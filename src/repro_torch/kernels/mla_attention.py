"""Absorbed latent attention over the latent slot cache (DeepSeek-V2's
MLA), and its plain PyTorch version.

It replaces no TPU kernel: latent attention exists only in the port
(``models/mla.py``).  There, each row's latent queries met the cache in
two cuBLAS products over all T cached positions: fp32 scores of
(B, S * H, T), the keys past each row's position masked in place, an
fp32 softmax over the whole width, P cast to bf16, and a second read of
the cache for the values.  At DeepSeek-V2-Lite's 128 slots of 8192 that
is 2.3 GB a layer in every decode step, where a row's own keys are on
average a third of its slot.  The kernel is CUDA C++
(``csrc/mla_attention.cu``, built by ``_build``).

What bounds it on the H100: bytes.  A decode step has 16 (query, head)
rows per batch row and each batch row its own keys, so no key is read
for more than 16 rows; the least time is the visible keys x 576 x 2 B,
plus q and o, over the memory rate (``work``).

What the design does about it: each visible key is read once, in bf16,
and nothing past the last visible key of a CTA; the values are the key
tile's first 512 columns, already in shared memory; scores and P never
leave the chip.  The keys are cut into splits of ``SPLIT`` positions,
one CTA each per 64-row query tile, so that a long row does not hold up
the layer; a split past its rows' positions returns at once, and a
second small kernel combines the splits' fp32 partials by log-sum-exp
in split order.  No atomics: a replayed CUDA graph gives the eager
call's bits.

It computes the products' function, not a cheaper one: bf16 operands,
fp32 sums, an fp32 softmax, P rounded to bf16 for the value product and
the output rounded once.  Two differences, both rounding: sums run in
another order (the scores' depth in two halves, the online softmax over
BK-key tiles, the splits), and P is rounded to bf16 as exp(s - m) of the
running max, before the normalisation, where the products rounded
softmax(s).

``mla_attention`` launches the kernels for CUDA tensors and counts the
launch in ``mla_attention.launches``; for CPU tensors it runs
``mla_attention_plain``, the kernel's arithmetic (its splits, its tile
walk and its combine) in PyTorch; on meta tensors (the capture prewarm's
trace, a program analysis) it launches nothing, reports its work
(``note_traced``) and returns an empty output of the right shape.
"""
from __future__ import annotations

import torch

from . import _build
from .goma_gemm import dtype_key, note_traced, refuse_grad, traced

# the kernel's constants (csrc/mla_attention.cu, checked at the first
# launch): (query, head) rows of a CTA, keys of a ring stage, the key
# width (rank + rope) and the value width (rank)
ROWS, BK = 64, 32
KEY_DIM, VALUE_DIM = 576, 512
# keys of a split, whole ring stages
SPLIT = 1024


def splits(T: int) -> int:
    """The splits of a cache of T positions: fixed by T, so a graph's
    grid and scratch do not depend on the positions."""
    return -(-T // SPLIT)


def key_limits(qpos: torch.Tensor, T: int) -> torch.Tensor:
    """The last key each query sees: its position, at most T - 1."""
    return qpos.clamp(max=T - 1)


def mla_attention_plain(q: torch.Tensor, ckv: torch.Tensor,
                        qpos: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic on whole rows: per split of SPLIT keys the
    online softmax over BK-key tiles, P of each tile rounded to q's
    dtype at the running max, the splits' partials combined by
    log-sum-exp; returns (B, S, H, VALUE_DIM) in q's dtype."""
    B, S, H, D = q.shape
    T, NS = ckv.shape[1], splits(ckv.shape[1])
    f32 = torch.float32
    pad = NS * SPLIT - T
    k = torch.nn.functional.pad(ckv.to(f32), (0, 0, 0, pad))
    s = q.to(f32).reshape(B, S * H, D) @ k.transpose(1, 2)
    lim = key_limits(qpos, T).repeat_interleave(H, dim=1)      # (B, S*H)
    late = torch.arange(NS * SPLIT, device=q.device) > lim[..., None]
    s = s.masked_fill(late, -torch.inf)
    NT = SPLIT // BK
    s = s.reshape(B, S * H, NS, NT, BK)
    v = k[..., :VALUE_DIM].reshape(B, NS, NT, BK, VALUE_DIM)
    m = torch.full((B, S * H, NS), -torch.inf, dtype=f32, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros((B, S * H, NS, VALUE_DIM), dtype=f32, device=q.device)
    for n in range(NT):
        sn = s[:, :, :, n]
        mn = torch.maximum(m, sn.amax(-1))
        ms = torch.where(mn == -torch.inf, 0.0, mn)
        alpha = torch.exp(m - ms)
        p = torch.exp(sn - ms[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("brjk,bjkd->brjd", p.to(q.dtype).to(f32),
                          v[:, :, n])
        o = o * alpha[..., None] + pv
        m = mn
    top = m.amax(-1, keepdim=True)
    seen = m != -torch.inf
    wt = torch.where(seen, torch.exp(m - torch.where(seen, top, 0.0)), 0.0)
    total = (wt * l).sum(-1)
    out = (wt[..., None] * o).sum(2) / total[..., None]
    return out.reshape(B, S, H, VALUE_DIM).to(q.dtype)


def work(B: int, S: int, H: int, T: int,
         qpos: torch.Tensor | None = None) -> dict:
    """What one call must do: the bytes (each batch row's visible keys,
    up to its last query's last key, read once at KEY_DIM x 2 B, q read
    and o written in bf16) and the products' flops (every (query, head)
    row against its visible keys, KEY_DIM deep for the scores and
    VALUE_DIM wide for the values).  Without positions (a trace) every
    key counts as visible."""
    if qpos is None:
        rows_keys, pairs = B * T, H * B * S * T
    else:
        keys = key_limits(qpos, T).to(torch.int64).cpu() + 1
        rows_keys, pairs = int(keys.amax(1).sum()), H * int(keys.sum())
    return {"bytes": rows_keys * KEY_DIM * 2
            + B * S * H * (KEY_DIM + VALUE_DIM) * 2,
            "flops": 2 * pairs * (KEY_DIM + VALUE_DIM)}


def _check(q, ckv, qpos) -> None:
    """Raise on what the kernel does not take, on every device, so that
    the CPU refuses what the card refuses: the widths, the positions'
    shape and dtype, one dtype for q and ckv, contiguous q and positions,
    and cache rows of KEY_DIM contiguous values at a batch stride of
    whole 16 bytes (a TMA map's)."""
    if q.ndim != 4 or ckv.ndim != 3 or q.shape[0] != ckv.shape[0] or \
            q.shape[3] != KEY_DIM or ckv.shape[2] != KEY_DIM:
        raise ValueError(f"mla_attention takes q (B, S, H, {KEY_DIM}) and "
                         f"ckv (B, T, {KEY_DIM}), not {tuple(q.shape)}, "
                         f"{tuple(ckv.shape)}")
    if qpos.shape != q.shape[:2] or qpos.dtype != torch.int64:
        raise ValueError(f"qpos must be int64 (B, S) = {tuple(q.shape[:2])}"
                         f", not {qpos.dtype} {tuple(qpos.shape)}")
    if q.dtype != ckv.dtype or q.dtype not in (torch.bfloat16,
                                               torch.float32):
        raise ValueError(f"q and ckv must share a dtype, bf16 (or fp32 for "
                         f"the plain version), not {q.dtype} and "
                         f"{ckv.dtype}")
    if not q.is_contiguous() or not qpos.is_contiguous():
        raise ValueError("mla_attention takes contiguous q and qpos")
    if ckv.stride(2) != 1 or ckv.stride(1) != KEY_DIM or ckv.stride(0) % 8:
        raise ValueError(f"mla_attention takes ckv with contiguous rows of "
                         f"{KEY_DIM} at a batch stride of whole 16 bytes, "
                         f"not strides {ckv.stride()}")


def _check_cuda(q, ckv, qpos) -> None:
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the latent attention kernel takes bf16 q and "
                         f"ckv, not {q.dtype}")
    if any(t.device != q.device for t in (ckv, qpos)):
        raise ValueError("q, ckv and qpos must lie on one device")
    if q.data_ptr() % 16 or ckv.data_ptr() % 16:
        raise ValueError("q and ckv must start at 16-byte aligned "
                         "addresses (a TMA map's base)")


def _library():
    """The built kernels, their constants checked against this module's."""
    lib = _build.load()
    if not _library.checked:
        got = [lib.mla_attn_config(w) for w in range(4)]
        want = [ROWS, BK, KEY_DIM, VALUE_DIM]
        if got != want:
            raise RuntimeError(f"the latent attention kernel's constants "
                               f"{got} are not the wrapper's {want}")
        _library.checked = True
    return lib


_library.checked = False


def mla_attention(q: torch.Tensor, ckv: torch.Tensor,
                  qpos: torch.Tensor) -> torch.Tensor:
    """Latent attention of q (B, S, H, KEY_DIM), the scaled latent queries,
    over ckv (B, T, KEY_DIM), one layer's [c_kv | k_pe] cache: key t is
    visible to query (b, s) when t <= qpos[b, s] (int64 (B, S)); the
    values are each key's first VALUE_DIM columns.  Returns (B, S, H,
    VALUE_DIM) in q's dtype.  On the card q and ckv are bf16."""
    _check(q, ckv, qpos)
    refuse_grad("mla_attention", q, ckv)
    B, S, H, _ = q.shape
    T = ckv.shape[1]
    if traced(q) or q.device.type == "meta":
        w = work(B, S, H, T)
        note_traced("mla_attention", shape=(B, S, H, T), nbytes=w["bytes"],
                    flops={dtype_key(q.dtype): w["flops"]})
        return q.new_empty((B, S, H, VALUE_DIM))
    if q.device.type == "cpu":
        return mla_attention_plain(q, ckv, qpos)
    if q.device.type != "cuda":
        raise ValueError(f"mla_attention runs on cuda or, as its plain "
                         f"version, on the cpu, not on {q.device}")
    _check_cuda(q, ckv, qpos)
    lib = _library()
    NS = splits(T)
    rows = B * S * H
    part = torch.empty((rows, NS, VALUE_DIM), dtype=torch.float32,
                       device=q.device)
    ml = torch.empty((rows, NS, 2), dtype=torch.float32, device=q.device)
    out = torch.empty((B, S, H, VALUE_DIM), dtype=q.dtype, device=q.device)
    err = lib.mla_attn_launch(
        q.data_ptr(), ckv.data_ptr(), qpos.data_ptr(), part.data_ptr(),
        ml.data_ptr(), out.data_ptr(), B, S, H, T, ckv.stride(0), NS, SPLIT,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mla_attention")
    mla_attention.launches += 1
    return out


mla_attention.launches = 0
