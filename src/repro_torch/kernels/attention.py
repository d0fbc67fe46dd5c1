"""Fused attention with its own backward, for the attention that has no
cache (a training loss's self-attention, the encoder's), and its plain
PyTorch version.

It replaces no TPU kernel: the reference leaves attention to XLA, and
the port's ``models/layers.flash_attention`` is its walk over key blocks
in plain PyTorch.  That walk writes every block's fp32 scores to device
memory and reads them back in some eight elementwise kernels, runs its
products in fp32 on the CUDA cores and computes the blocks the causal
mask throws away; autograd through it keeps all of that for the
backward.  At stablelm-1.6b's 2 x 4096 tokens it is about two thirds of
a training step.  The kernels are CUDA C++ (``csrc/attention.cu``,
built by ``_build``): ``attn_fwd``, and the backward's ``attn_dq`` and
``attn_dkdv``.

What bounds it on the H100: the tensor cores.  A causal layer at
B x H x S x hd does 4 B H hd S (S + 1) / 2 product flops forward and
twice that backward; the bytes (Q, K, V, O, dO and the gradients) are
far fewer.

What the design does about it: the scores never leave the chip; the
products run on the bf16 tensor cores (``wgmma``) with fp32
accumulators, fed by a TMA ring; key tiles past a query tile's last
position are never loaded and only tiles that straddle a query's
position are masked (``tile_ranges``), so the causal square costs half
the full one.

It computes the reference's function to fp32 rounding, not a cheaper
one:

- Q, K, V and dO are bf16, and a bf16 x bf16 product is exact in fp32,
  so S = Q K^T, dP = dO V^T and the products with Q or K as the other
  factor lose nothing on the tensor cores.
- The fp32 operands P and dS = P (dP - D) go into their products as
  three bf16 pieces each (``split3``), summed exactly to the fp32 value
  and multiplied one by one with fp32 accumulation, into a fresh sum
  for each tile that is added to the running one in fp32.  Nothing runs
  in TF32 and nothing the walk keeps in fp32 is rounded to bf16.  The
  pieces of P carry a factor 2**P_SHIFT and those of dS 2**DS_SHIFT,
  taken off the fp32 sums: powers of two, so exact, and they lift every
  fp32 value of P in [0, 1] and every dS of magnitude 2**-149 to 2**87
  into the range where the split is exact (``SPLIT_EXACT``).
- The scale 1/sqrt(hd) multiplies the fp32 scores (exact at hd 64).
- The forward also writes the fp32 output and the log-sum-exp, from
  which the backward recomputes P and takes D = rowsum(dO * O) against
  the fp32 O, as exact as the walk's.
- Key t is visible to a query at position p when kv_positions[t] < T
  and, if causal, kv_positions[t] <= p: the reference's mask with no
  ``kv_len``, for any positions.
- Sums run in another order than the walk's; that is the only
  difference.

``fused_attention`` is a ``torch.autograd.Function``, so
``torch.utils.checkpoint`` recomputes its forward as it recomputes the
walk.  For CUDA tensors it launches the kernels (counted in
``fused_attention.launches``, the forward, and
``fused_attention.backward_launches``, each backward's dQ and dK/dV
kernels); for CPU tensors it runs the plain version
(``fused_attention_plain``, ``fused_attention_plain_backward``), the
same arithmetic on whole rows; on the meta tensors of a program
analysis it launches nothing and reports its work (``note_traced``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build
from .goma_gemm import note_traced, traced

# the head sizes the kernels are built for
HEAD_DIMS = (64, 128)
BIG = 1 << 30            # a position no query reaches
# the powers of two that the pieces of P and of dS carry
P_SHIFT, DS_SHIFT = 64, 40
# split3 is exact for every fp32 x == 0 or 2**-SPLIT_EXACT <= |x| < 2**127
# (below, the last piece would need bits under bf16's smallest
# subnormal, 2**-133; above, hi may round to infinity)
SPLIT_EXACT = 110
# the kernels' tiles (csrc/attention.cu, checked at the first launch): a
# forward or dQ CTA holds Q_TILE queries and streams K_TILE keys a
# stage; a dK/dV CTA holds KV_TILE keys and streams q_stage(hd) queries
Q_TILE, K_TILE, KV_TILE = 128, 64, 128


def q_stage(hd: int) -> int:
    """Queries of a dK/dV ring stage at head size ``hd``."""
    return 64 if hd == 64 else 32


def split3(x: torch.Tensor):
    """fp32 x as three bf16 pieces, hi + mid + lo == x exactly (for
    2**-SPLIT_EXACT <= |x| < 2**127, and 0): hi rounds x, mid what hi
    leaves, lo what both leave; each takes 8 of fp32's 24 significant
    bits."""
    hi = x.to(torch.bfloat16)
    rest = x - hi.to(torch.float32)
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def split_matmul(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ b for fp32 x and b with bf16 values, as the kernels take it:
    the three pieces of x one after another into one fp32 sum, the
    smallest first."""
    hi, mid, lo = split3(x)
    acc = lo.to(torch.float32) @ b
    acc = acc + mid.to(torch.float32) @ b
    return acc + hi.to(torch.float32) @ b


def effective_positions(q_positions, kv_positions, causal: bool):
    """The positions the mask compares, so that key t is visible to query
    s exactly when ke[t] <= qe[..., s]: a key at a position >= T gets
    BIG, and without ``causal`` every query gets BIG - 1."""
    T = kv_positions.shape[0]
    ke = torch.where(kv_positions < T, kv_positions,
                     torch.full_like(kv_positions, BIG))
    qe = q_positions if causal else torch.full_like(q_positions, BIG - 1)
    return qe, ke


def _visible(qpos, kpos, causal: bool):
    """(B or 1, 1, S, T) bool: key t visible to query s."""
    qe, ke = effective_positions(qpos, kpos, causal)
    qe = qe if qe.ndim == 2 else qe[None]
    return (ke[None, None, :] <= qe[:, :, None])[:, None]


def _heads(q, k, v):
    """Q (B, H, S, hd) and K, V (B, H, T, hd) in fp32, each query head
    with its group's KV head."""
    G = q.shape[2] // k.shape[2]
    f32 = torch.float32
    qf = q.to(f32).transpose(1, 2)
    kf = k.to(f32).repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.to(f32).repeat_interleave(G, dim=2).transpose(1, 2)
    return qf, kf, vf


def fused_attention_plain(q, k, v, q_positions, kv_positions,
                          causal: bool = True):
    """The kernel's forward on whole rows: (O in q's dtype (B, S, H, hd),
    O in fp32 (B, S, H, hd), log-sum-exp (B, H, S), +inf where a query
    sees no key)."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf = _heads(q, k, v)
    ok = _visible(q_positions, kv_positions, causal)
    s = torch.where(ok, (qf @ kf.transpose(-1, -2)) * scale, -torch.inf)
    m = torch.amax(s, dim=-1)
    m_safe = torch.where(torch.isinf(m), 0.0, m)
    p = torch.exp(s - m_safe[..., None])
    total = torch.sum(p, dim=-1)
    acc = split_matmul(p * 2.0 ** P_SHIFT, vf)
    o32 = acc / (torch.clamp(total, min=1e-20) * 2.0 ** P_SHIFT)[..., None]
    lse = torch.where(total > 0, m_safe + torch.log(total), torch.inf)
    o32 = o32.transpose(1, 2).contiguous()
    return o32.to(q.dtype), o32, lse


def fused_attention_plain_backward(q, k, v, q_positions, kv_positions,
                                   causal, o32, lse, do):
    """The kernels' backward on whole rows: (dQ, dK, dV) in q's dtype."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf = _heads(q, k, v)
    dof = do.to(torch.float32).transpose(1, 2)
    ok = _visible(q_positions, kv_positions, causal)
    p = torch.where(ok, torch.exp((qf @ kf.transpose(-1, -2)) * scale
                                  - lse[..., None]), 0.0)
    delta = torch.sum(dof * o32.transpose(1, 2), dim=-1)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    dv = split_matmul(p.transpose(-1, -2) * 2.0 ** P_SHIFT, dof) \
        * 2.0 ** -P_SHIFT
    ds = ds * 2.0 ** DS_SHIFT
    dk = split_matmul(ds.transpose(-1, -2), qf) * (scale * 2.0 ** -DS_SHIFT)
    dq = split_matmul(ds, kf) * (scale * 2.0 ** -DS_SHIFT)

    def per_kv_head(t):                 # (B, H, T, hd) -> (B, T, KV, hd)
        return t.transpose(1, 2).reshape(B, T, KV, H // KV, hd).sum(3)
    return (dq.transpose(1, 2).to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))


def _tile_bounds(pos: torch.Tensor, tile: int, ragged: int):
    """Each tile's least and greatest position (..., n_tiles) over the
    positions that exist; ``ragged`` stands for the greatest position of
    a tile with fewer than ``tile`` of them."""
    L = pos.shape[-1]
    n = -(-L // tile)
    pad = n * tile - L
    lo = F.pad(pos, (0, pad), value=BIG)
    hi = F.pad(pos, (0, pad), value=ragged)
    return (lo.reshape(*pos.shape[:-1], n, tile).amin(-1),
            hi.reshape(*pos.shape[:-1], n, tile).amax(-1))


def tile_ranges(q_positions: torch.Tensor, kv_positions: torch.Tensor,
                BM: int, BN: int, causal: bool) -> dict:
    """The tiles each kernel program walks, int32, exact for any
    positions.  A query tile i of row b (BM queries) sees key tiles
    (BN keys) [0, k_full[b, i]) whole and [k_full, k_hi) in part, masked
    element by element; it sees no key of a later tile.  A key tile j
    is seen by query tiles [q_lo[b, j], q_full[b, j]) in part and by
    [q_full, n_q_tiles) whole, by none before q_lo.  A ragged last key
    tile counts as seen in part (its missing keys are masked); a ragged
    last query tile's missing rows read as zeros with a log-sum-exp of
    inf, so they need no mask."""
    qe, ke = effective_positions(q_positions, kv_positions, causal)
    qe = qe.to(torch.int32)
    qe = qe if qe.ndim == 2 else qe[None]
    qmin, qmax = _tile_bounds(qe, BM, -BIG)                   # (B?, NQ)
    kmin, kmax = _tile_bounds(ke.to(torch.int32), BN, BIG)
    nq, nk = qmin.shape[-1], kmin.shape[0]
    some = kmin[None, None, :] <= qmax[..., None]           # (B?, NQ, NK)
    every = kmax[None, None, :] <= qmin[..., None]
    qi = torch.arange(1, nq + 1, device=qe.device)[None, :, None]
    kj = torch.arange(1, nk + 1, device=qe.device)[None, None, :]
    k_hi = torch.amax(torch.where(some, kj, 0), dim=2)
    k_full = torch.minimum(torch.cumprod(every.to(torch.int32), 2).sum(2),
                           k_hi)
    q_lo = torch.amin(torch.where(some, qi - 1, nq), dim=1)
    q_full = torch.maximum(torch.amax(torch.where(every, 0, qi), dim=1),
                           q_lo)
    return {k: v.to(torch.int32) for k, v in (
        ("k_full", k_full), ("k_hi", k_hi), ("q_lo", q_lo),
        ("q_full", q_full))}


def attention_work(B: int, S: int, T: int, H: int, KV: int, hd: int,
                   causal: bool) -> dict:
    """What the kernels do for one call at arange positions: the
    products' flops (each product 2 x rows x cols x depth, P and dS by
    their three pieces), forward and backward, and the bytes each moves
    (inputs read once, outputs written once)."""
    if causal:
        n = min(S, T)
        pairs = n * (n + 1) // 2 + (S - n) * T
    else:
        pairs = S * T
    unit = 2 * B * H * hd * pairs        # one product over the visible pairs
    q_bytes, kv_bytes = B * S * H * hd * 2, B * T * KV * hd * 2
    rows = B * H * S * 4
    return {
        # S, then P V by P's three pieces
        "forward_flops": 4 * unit,
        # dQ: S, dP, dS K by three pieces; dK/dV: S, dP, then P^T dO and
        # dS^T Q by three pieces each
        "backward_flops": 13 * unit,
        # q, k, v read; o (bf16 and fp32) and the log-sum-exp written
        "forward_bytes": q_bytes + 2 * kv_bytes + 3 * q_bytes + rows,
        # q, k, v, dO, O32, the log-sum-exp read; D written and read; dQ,
        # dK, dV written
        "backward_bytes": (2 * q_bytes + 2 * kv_bytes + 2 * q_bytes + rows
                           + 2 * rows + q_bytes + 2 * kv_bytes),
    }


def _check(q, k, v, q_positions, kv_positions) -> None:
    B, S, H, hd = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B or \
            k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"fused_attention takes q (B, S, H, hd) and k, v "
                         f"(B, T, KV, hd) with KV dividing H, not "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if kv_positions.shape != (k.shape[1],) or \
            q_positions.shape not in ((S,), (B, S)):
        raise ValueError(f"positions must be (S,) or (B, S) for the "
                         f"queries and (T,) for the keys, not "
                         f"{tuple(q_positions.shape)}, "
                         f"{tuple(kv_positions.shape)}")


# the last positions the kernels were launched for: (q_positions,
# kv_positions, their in-place versions with causal, the batch and the
# head size, and (int32 q positions, int32 effective kv positions, the
# tables as B rows))
_last_ranges = None


def _ranges(q_positions, kv_positions, causal: bool, B: int, hd: int):
    """The int32 positions, the keys' effective positions and the
    ``tile_ranges`` tables as B rows, for the launches.  The model passes
    one positions tensor to every layer of a step (the forward, the
    recompute and the backward), so the last call's tables are used
    again while both tensors are the same objects at the same in-place
    version: some thirty small launches a call become one set a step,
    which took stablelm-1.6b's 2 x 4096 step from 9765 launches to 7163
    (PERF.md) (``_ranges.computed`` counts the sets).  The tensors are
    held, so neither can be freed and another take its place.  Tensors
    made under ``inference_mode`` (serving's encoder) carry no version,
    so their tables are computed afresh at every call."""
    global _last_ranges
    cached = not (q_positions.is_inference() or kv_positions.is_inference())
    key = cached and (q_positions._version, kv_positions._version, causal,
                      B, hd)
    last = _last_ranges
    if cached and last is not None and last[0] is q_positions and \
            last[1] is kv_positions and last[2] == key:
        return last[3]
    qp = q_positions.to(torch.int32).contiguous()
    kp = kv_positions.to(torch.int32)
    kpe = effective_positions(qp, kp, causal)[1].contiguous()
    tables = {}
    for (bm, bn), names in (((Q_TILE, K_TILE), ("k_full", "k_hi")),
                            ((q_stage(hd), KV_TILE), ("q_lo", "q_full"))):
        r = tile_ranges(qp, kp, bm, bn, causal)
        tables.update({n: r[n].expand(B, -1).contiguous() for n in names})
    result = (qp, kpe, tables)
    if cached:
        _last_ranges = (q_positions, kv_positions, key, result)
    _ranges.computed += 1
    return result


_ranges.computed = 0


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte aligned address (a TMA map's base)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _library():
    """The built kernels, their tiles checked against this module's."""
    lib = _build.load()
    if not _library.checked:
        got = [lib.attn_tile(w, hd) for hd in HEAD_DIMS for w in range(4)]
        want = [x for hd in HEAD_DIMS
                for x in (Q_TILE, K_TILE, KV_TILE, q_stage(hd))]
        if got != want:
            raise RuntimeError(f"the attention kernels' tiles {got} are "
                               f"not the wrapper's {want}")
        _library.checked = True
    return lib


_library.checked = False


def _s_pad(S: int) -> int:
    """The length of the log-sum-exp and D rows: S up to a whole
    Q_TILE."""
    return -(-S // Q_TILE) * Q_TILE


def _launch_forward(q, k, v, q_positions, kv_positions, causal):
    """O (bf16), O (fp32) and the log-sum-exp (B, H, S padded to a whole
    Q_TILE, +inf past S)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    lib = _library()
    q, k, v = _dense(q), _dense(k), _dense(v)
    qp, kpe, r = _ranges(q_positions, kv_positions, causal, B, hd)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    o32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, _s_pad(S)), dtype=torch.float32,
                      device=q.device)
    err = lib.attn_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
        kpe.data_ptr(), r["k_full"].data_ptr(), r["k_hi"].data_ptr(),
        o.data_ptr(), o32.data_ptr(), lse.data_ptr(), B, S, T, H, KV, hd,
        S if qp.ndim == 2 else 0, int(causal), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "attn_fwd")
    fused_attention.launches += 1
    return o, o32, lse


def _launch_backward(q, k, v, q_positions, kv_positions, causal, o32, lse,
                     do, grad_dtype: torch.dtype | None = None):
    """dQ, dK, dV in q's dtype, or in fp32 with ``grad_dtype`` float32
    (a check reads the kernels' sums before their last rounding)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    lib = _library()
    q, k, v, do = _dense(q), _dense(k), _dense(v), _dense(do)
    qp, kpe, r = _ranges(q_positions, kv_positions, causal, B, hd)
    f32 = grad_dtype == torch.float32
    gd = torch.float32 if f32 else q.dtype
    delta = torch.empty_like(lse)
    dq = torch.empty(q.shape, dtype=gd, device=q.device)
    dk = torch.empty(k.shape, dtype=gd, device=q.device)
    dv = torch.empty(v.shape, dtype=gd, device=q.device)
    err = lib.attn_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        qp.data_ptr(), kpe.data_ptr(), r["k_full"].data_ptr(),
        r["k_hi"].data_ptr(), r["q_lo"].data_ptr(), r["q_full"].data_ptr(),
        o32.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, S, T, H, KV, hd,
        S if qp.ndim == 2 else 0, int(causal), int(f32),
        1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "attn_bwd")
    fused_attention.backward_launches += 1
    return dq, dk, dv


def _note(q, k, causal: bool, part: str) -> None:
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    work = attention_work(B, S, T, H, KV, hd, causal)
    note_traced(f"fused_attention.{part}", shape=(B, S, T, H, KV, hd),
                nbytes=work[f"{part}_bytes"],
                flops={"bfloat16": work[f"{part}_flops"]})


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, causal):
        if traced(q):
            _note(q, k, causal, "forward")
            o = q.new_empty(q.shape)
            o32 = lse = q.new_empty((0,), dtype=torch.float32)
        elif q.device.type == "cuda":
            o, o32, lse = _launch_forward(q, k, v, q_positions,
                                          kv_positions, causal)
        else:
            o, o32, lse = fused_attention_plain(q, k, v, q_positions,
                                                kv_positions, causal)
        ctx.save_for_backward(q, k, v, q_positions, kv_positions, o32, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_positions, kv_positions, o32, lse = ctx.saved_tensors
        if traced(q):
            _note(q, k, ctx.causal, "backward")
            return (q.new_empty(q.shape), k.new_empty(k.shape),
                    v.new_empty(v.shape), None, None, None)
        run = (_launch_backward if q.device.type == "cuda"
               else fused_attention_plain_backward)
        dq, dk, dv = run(q, k, v, q_positions, kv_positions, ctx.causal,
                         o32, lse, do)
        return dq, dk, dv, None, None, None


def fused_attention(q, k, v, *, q_positions, kv_positions,
                    causal: bool = True) -> torch.Tensor:
    """Attention of q (B, S, H, hd) over k, v (B, T, KV, hd), H a multiple
    of KV, at q_positions (S,) or (B, S) and kv_positions (T,): key t is
    visible to a query at position p when kv_positions[t] < T and, if
    ``causal``, kv_positions[t] <= p; a query with no visible key gets
    zeros.  Returns (B, S, H, hd) in q's dtype, differentiable in q, k
    and v.  On the card q, k and v are bf16 with hd 64 or 128."""
    _check(q, k, v, q_positions, kv_positions)
    if q.device.type == "cuda" and not traced(q):
        hd = q.shape[-1]
        if hd not in HEAD_DIMS or any(t.dtype != torch.bfloat16
                                      for t in (q, k, v)):
            raise ValueError(f"the fused attention kernel takes bf16 q, k, "
                             f"v with head size in {HEAD_DIMS}, not "
                             f"{q.dtype}, {k.dtype}, {v.dtype} at {hd}")
    elif q.device.type != "cpu" and not traced(q):
        raise ValueError(f"fused_attention runs on CUDA or, as its plain "
                         f"version, on the CPU, not on {q.device}")
    return _FusedAttention.apply(q, k, v, q_positions, kv_positions,
                                 bool(causal))


fused_attention.launches = 0
fused_attention.backward_launches = 0
