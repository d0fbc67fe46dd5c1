"""Layer functions of the dense decoder, on PyTorch tensors (the
counterpart of the reference's ``models/layers.py``).

Parameters are nested dicts of tensors with the reference's layout
(``(d_in, d_out)`` projection weights), so ``convert.params_from_jax``
moves a JAX pytree over as it is.  Attention is plain PyTorch: the
reference leaves it to XLA, so the port has no hand kernel for it.  The
gated MLP runs through the GOMA-planned kernels when the config asks for
the fused MLP.  ``pad_seq`` pads a sequence to a scan's chunk for the
recurrent blocks (``rwkv.py``, ``ssm.py``).

Not ported yet: sliding windows, softcaps and cross-attention.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.ops import fused_mlp

Params = dict


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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_positions: torch.Tensor,
              kv_len: int | torch.Tensor | None = None) -> torch.Tensor:
    """Causal GQA attention in fp32.  q: (B, S, H, hd); k/v: (B, T, KV,
    hd); key t is visible to a query at position p when t <= p and
    t < kv_len, where ``kv_len`` is one length for every row or a (B,)
    tensor of per-row lengths.  The softmax is taken as the reference's
    flash attention takes it within one key block: exponentials of the
    shifted scores, weighted sum, then one division by their total."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).to(torch.float32) * (1.0 / math.sqrt(hd))
    s = torch.einsum("bskgh,btkh->bskgt", qg, k.to(torch.float32))
    kpos = torch.arange(T, device=q.device)
    qpos = q_positions.to(torch.int64)
    if qpos.ndim == 1:
        qpos = qpos[None].expand(B, S)
    ok = kpos[None, None, :] <= qpos[:, :, None]          # (B, S, T)
    if isinstance(kv_len, torch.Tensor):
        ok = ok & (kpos[None, None, :] < kv_len[:, None, None])
    elif kv_len is not None:
        ok = ok & (kpos < kv_len)[None, None, :]
    ok = ok[:, :, None, None, :]
    s = torch.where(ok, s, -torch.inf)
    m = torch.amax(s, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    denom = torch.sum(p, dim=-1)
    out = torch.einsum("bskgt,btkh->bskgh", p, v.to(torch.float32))
    out = out / torch.clamp(denom, min=1e-20)[..., None]
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


def attention_apply(p: Params, x: torch.Tensor, *, n_heads: int,
                    kv_heads: int, head_dim: int, rope_theta: float | None,
                    q_positions: torch.Tensor, cache: Params | None = None,
                    cache_index: int | torch.Tensor | None = None):
    """Returns (out, cache).  Cache layout: {"k": (B, T_max, KV, hd),
    "v": ...}.  ``cache_index`` is the write position of a decode step:
    one int for every row, or a (B,) int64 tensor on the cache's device
    with each row's own position (the continuous scheduler's slot-indexed
    decode; attention then masks each row at its own valid length).  None
    is a prefill that writes [0, S).  Unlike the reference, the cache is
    updated in place (no second copy of it per step); the returned cache
    is the same dict."""
    B, S, _ = x.shape
    q = dense(p["wq"], x).reshape(B, S, n_heads, head_dim)
    k = dense(p["wk"], x).reshape(B, S, kv_heads, head_dim)
    v = dense(p["wv"], x).reshape(B, S, kv_heads, head_dim)
    if rope_theta is not None:
        q = rope(q, q_positions, rope_theta)
        k = rope(k, q_positions, rope_theta)
    kv_len = None
    if cache is not None and isinstance(cache_index, torch.Tensor):
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
    out = attention(q, k, v, q_positions=q_positions, kv_len=kv_len)
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
