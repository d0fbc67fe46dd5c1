"""Layer functions of the dense decoder, on PyTorch tensors (the
counterpart of the reference's ``models/layers.py``).

Parameters are nested dicts of tensors with the reference's layout
(``(d_in, d_out)`` projection weights), so ``convert.params_from_jax``
moves a JAX pytree over as it is.  Attention without a cache (a
training loss's self-attention, and the encoder's, in training and in
serving), with no active window and no softcap, on bf16 CUDA tensors at
head size 64 or 128, runs the fused attention kernel with its own
backward (``kernels/attention.py``); every other call (the decoder's
serving with its cache, cross-attention, windows, softcaps) runs
``flash_attention``, the reference's flash-style walk over key blocks in
plain PyTorch.  Latent attention (``mla.py``) has query/key heads of 192
and value heads of 128, which the kernel is not built for: its
training loss walks (its serving attends over the latent cache).  The
registry counts the calls of each route (``attn.kernel``,
``attn.walk``).  The
gated MLP runs through the GOMA-planned kernels when the config asks for
the fused MLP.  ``pad_seq`` pads a sequence to a scan's chunk for the
recurrent blocks (``rwkv.py``, ``ssm.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import goma_gemm
from ..kernels.attention import HEAD_DIMS, fused_attention
from ..kernels.ops import fused_mlp
from ..obs.registry import get_registry

Params = dict
_REG = get_registry()


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    # the reference casts the weight to the activation dtype at every use;
    # the port casts once at load (convert.py), so this is a no-op there
    return x @ p["w"].to(x.dtype)


def pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 (the sequence) of a (B, S, ...) tensor by ``pad``;
    the result is contiguous, as the scan kernels take it."""
    if not pad:
        return t.contiguous()
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["e"][tokens]


def apply_norm(p: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        out = ((xf - mu) * torch.rsqrt(var + eps)
               * p["scale"].to(torch.float32)
               + p["bias"].to(torch.float32))
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Half-split rotary embedding in fp32.  x: (B, S, H, hd);
    positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: torch.Tensor,
                    kv_positions: torch.Tensor,
                    causal: bool = True,
                    window: int | None = None,
                    window_active: bool | torch.Tensor | None = None,
                    kv_len: int | torch.Tensor | None = None,
                    softcap: float | None = None,
                    block: int = 512) -> torch.Tensor:
    """GQA attention in fp32 over key blocks with an online softmax, the
    reference's algorithm.  q: (B, S, H, hd); k/v: (B, T, KV, hd);
    q_positions (B, S) or (S,); kv_positions (T,).

    Keys go in blocks of ``min(block, T)``; the last block is padded to
    the full width with positions 2**30, which no mask lets through.  Key
    t is visible to a query at position p when kv_positions[t] < kv_len
    (one length, or a (B,) tensor of per-row lengths; T when None), when
    it is at or before p if ``causal``, and when p - kv_positions[t] <
    ``window`` if a window is given and ``window_active`` is not False (a
    local layer; a bool tensor is taken elementwise, as the reference's
    traced per-layer switch).  ``softcap`` caps the scaled scores,
    softcap * tanh(s / softcap), before the mask.  A query with no
    visible key gets zeros.  With one block there is no carry to rescale:
    the first block's running max, total and sum are taken as they are,
    which are the values the reference's rescale of its empty carry
    gives."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).to(torch.float32) * (1.0 / math.sqrt(hd))
    block = min(block, T)
    qpos = q_positions.to(torch.int64)
    if qpos.ndim == 1:
        qpos = qpos[None].expand(B, S)
    limit = (kv_len.reshape(-1, 1, 1) if isinstance(kv_len, torch.Tensor)
             else kv_len)
    windowed = window is not None and window_active is not False
    m = total = acc = None
    for start in range(0, T, block):
        kb = k[:, start:start + block]
        vb = v[:, start:start + block]
        kpos = kv_positions[start:start + block].to(torch.int64)
        pad = block - kb.shape[1]
        if pad:
            kb = torch.cat([kb, kb.new_zeros((B, pad, KV, hd))], 1)
            vb = torch.cat([vb, vb.new_zeros((B, pad, KV, hd))], 1)
            kpos = torch.cat([kpos, kpos.new_full((pad,), 2**30)])
            if limit is None:
                limit = T
        s = torch.einsum("bskgh,btkh->bskgt", qg, kb.to(torch.float32))
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        ok = None
        if causal:
            ok = kpos[None, None, :] <= qpos[:, :, None]      # (B, S, blk)
        if limit is not None:
            lim = kpos[None, None, :] < limit
            ok = lim if ok is None else ok & lim
        if windowed:
            in_window = qpos[:, :, None] - kpos[None, None, :] < window
            if isinstance(window_active, torch.Tensor):
                in_window = in_window | torch.logical_not(window_active)
            ok = in_window if ok is None else ok & in_window
        if ok is not None:
            ok = ok[:, :, None, None, :]
            s = torch.where(ok, s, -torch.inf)
        blk_max = torch.amax(s, dim=-1)
        m_new = blk_max if m is None else torch.maximum(m, blk_max)
        # rows with no valid key yet keep m = -inf; guard the exp
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        if ok is not None:
            p = torch.where(ok, p, 0.0)
        pv = torch.einsum("bskgt,btkh->bskgh", p, vb.to(torch.float32))
        if m is None:
            total, acc = torch.sum(p, dim=-1), pv
        else:
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            total = total * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(total, min=1e-20)[..., None]
    return out.reshape(B, S, H, hd).to(q.dtype)


def write_rows(cache: torch.Tensor, new: torch.Tensor,
               index: torch.Tensor) -> None:
    """Write each row's S new entries at its own position, in place, in
    one indexed store: cache (B, T, ...), new (B, S, ...), index (B,).
    A start is clamped into [0, T - S] so that the write fits, as
    jax.lax.dynamic_update_slice clamps it in the reference (a freed
    slot's stale position may lie past the end)."""
    B, S = new.shape[:2]
    start = torch.clamp(index, 0, cache.shape[1] - S)
    cols = start[:, None] + torch.arange(S, device=index.device)
    rows = torch.arange(B, device=index.device)[:, None]
    cache[rows, cols] = new.to(cache.dtype)


def on_kernel_device(t: torch.Tensor) -> bool:
    """Whether t lies where the fused attention kernel runs: on a CUDA
    card, or on the meta device while a program analysis collects the
    kernel calls (the kernel then reports its work, as the card runs
    it).  The CPU keeps the walk; the kernel's plain version runs there
    only when it is called directly."""
    return t.is_cuda or (goma_gemm.traced_calls is not None
                         and t.device.type == "meta")


def takes_kernel(q, k, v, *, cache, xkv, softcap, window,
                 window_active) -> bool:
    """Whether ``attention_apply`` runs the fused attention kernel: no
    cache and no cross-attention, no softcap, no active window, and bf16
    q, k, v of a head size the kernel is built for, on the kernel's
    device (``on_kernel_device``)."""
    return (cache is None and xkv is None and softcap is None
            and (window is None or window_active is False)
            and q.shape[-1] in HEAD_DIMS
            and all(t.dtype == torch.bfloat16 for t in (q, k, v))
            and on_kernel_device(q))


def attention_apply(p: Params, x: torch.Tensor, *, n_heads: int,
                    kv_heads: int, head_dim: int, rope_theta: float | None,
                    q_positions: torch.Tensor,
                    causal: bool = True,
                    window: int | None = None,
                    window_active: bool | torch.Tensor | None = None,
                    softcap: float | None = None,
                    xkv: torch.Tensor | None = None,
                    kv_positions: torch.Tensor | None = None,
                    cache: Params | None = None,
                    cache_index: int | torch.Tensor | None = None,
                    static_cache: bool = False,
                    kv_range: tuple[int, int] | None = None,
                    block: int = 512, enter=None):
    """Returns (out, cache).  ``xkv`` (B, T_src, d) switches to
    cross-attention: keys and values come from it, without rope, at
    positions arange(T_src).  Cache layout: {"k": (B, T_max, KV, hd),
    "v": ...}.  ``cache_index`` is the write position of a decode step:
    one int for every row, or a (B,) int64 tensor on the cache's device
    with each row's own position (the continuous scheduler's slot-indexed
    decode; attention then masks each row at its own valid length).  None
    is a prefill that writes [0, S).  With ``static_cache`` the cache's
    keys and values are read as they are and nothing is written (a
    precomputed cross-attention cache; the projections of ``xkv`` are
    not needed then and are not computed).  Unlike the reference, the
    cache is updated in place (no second copy of it per step); the
    returned cache is the same dict.  ``kv_range`` (lo, hi): the queries
    read only KV heads lo..hi-1 of those projected and cached (a
    tensor-parallel rank's query heads, with the KV heads replicated).
    ``enter`` maps ``x`` and ``xkv`` as they enter the projections (a
    tensor-parallel rank's split region: ``TensorParallel.enter``).
    """
    B, S, _ = x.shape
    if enter is not None:
        x = enter(x)
        xkv = None if xkv is None else enter(xkv)
    src = x if xkv is None else xkv
    q = dense(p["wq"], x).reshape(B, S, n_heads, head_dim)
    static = cache is not None and static_cache
    if not static:
        k = dense(p["wk"], src).reshape(B, src.shape[1], kv_heads, head_dim)
        v = dense(p["wv"], src).reshape(B, src.shape[1], kv_heads, head_dim)
    if kv_positions is None:
        kv_positions = (q_positions if xkv is None else
                        torch.arange(src.shape[1], device=x.device))
    if rope_theta is not None and xkv is None:
        q = rope(q, q_positions, rope_theta)
        if not static:
            k = rope(k, kv_positions, rope_theta)
    kv_len = None
    if static:
        k, v = cache["k"], cache["v"]
    elif cache is not None and isinstance(cache_index, torch.Tensor):
        write_rows(cache["k"], k, cache_index)
        write_rows(cache["v"], v, cache_index)
        k, v = cache["k"], cache["v"]
        kv_len = cache_index + S                            # (B,)
    elif cache is not None:
        start = 0 if cache_index is None else int(cache_index)
        cache["k"][:, start:start + S] = k.to(cache["k"].dtype)
        cache["v"][:, start:start + S] = v.to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
        kv_len = start + S
    if cache is not None:
        kv_positions = torch.arange(k.shape[1], device=x.device)
    if kv_range is not None:
        lo, hi = kv_range
        k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    if takes_kernel(q, k, v, cache=cache, xkv=xkv, softcap=softcap,
                    window=window, window_active=window_active):
        _REG.inc("attn.kernel")
        out = fused_attention(q, k, v, q_positions=q_positions,
                              kv_positions=kv_positions, causal=causal)
    else:
        _REG.inc("attn.walk")
        out = flash_attention(q, k, v, q_positions=q_positions,
                              kv_positions=kv_positions, causal=causal,
                              window=window, window_active=window_active,
                              kv_len=kv_len, softcap=softcap, block=block)
    return dense(p["wo"], out.reshape(B, S, n_heads * head_dim)), cache


def mlp_apply(p: Params, x: torch.Tensor, activation: str = "silu",
              use_fused: bool = False) -> torch.Tensor:
    if use_fused:
        return fused_mlp_apply(p, x, activation=activation)
    g = dense(p["wg"], x)
    if activation == "silu":
        act = F.silu(g)
    elif activation == "sqrelu":
        act = torch.square(torch.relu(g))
    else:
        act = F.gelu(g, approximate="tanh")
    return dense(p["wd"], act * dense(p["wu"], x))


def fused_mlp_apply(p: Params, x: torch.Tensor,
                    activation: str = "silu") -> torch.Tensor:
    """Gated MLP through the GOMA-chain-planned fused kernel: token rows
    flatten to one (B*S, d) GEMM chain; ``kernels.ops.fused_mlp`` falls
    back to the B1 composition when the chain does not fuse."""
    *lead, d = x.shape
    cdt = x.dtype
    out = fused_mlp(x.reshape(-1, d), p["wg"]["w"].to(cdt),
                    p["wu"]["w"].to(cdt), p["wd"]["w"].to(cdt),
                    activation=f"{activation}_mul")
    return out.reshape(*lead, out.shape[-1])
