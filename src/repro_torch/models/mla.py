"""Multi-head latent attention (MLA) of DeepSeek-V2, on PyTorch tensors.

Per token x (d): q = x W_q, (H, nope + rope); [c_kv | k_pe] = x W_kva,
c_kv normed by its own RMSNorm (the kv-a norm) and k_pe shared by every
head; [k_nope | v] = c_kv W_kvb, (H, nope + v).  Rotary embedding acts on
q_pe and k_pe alone, with YaRN's inverse frequencies (``yarn_inv_freq``)
and, as the published modeling code does, on interleaved pairs
(``rope_pairs``; the modeling code's regrouping of the pairs into halves
permutes q_pe and k_pe alike and is left out).  Scores are (q_nope
k_nope + q_pe k_pe) times ``softmax_scale``, (nope + rope)^-1/2 times
YaRN's attention factor squared.

Two forms compute the same attention:

- expanded (no cache: a training loss): per-head keys [k_nope | k_pe]
  and values v, through the port's walk (``layers.flash_attention``,
  counted as ``attn.walk``; the fused kernel takes no 192/128 heads);
- absorbed (with a cache: prefill chunks and decode): the cache holds
  the normed c_kv and the roped k_pe, kv_lora_rank + rope values a token
  a layer, and is never expanded to per-head keys.  Each head's query
  q_nope W_kvb_k[h]^T is kv_lora_rank wide, so attention is MQA over
  [c_kv | k_pe] keys with c_kv values, and the latent output times
  W_kvb_v[h] is the head's v-weighted sum.  Products take the compute
  dtype with fp32 sums and fp32 results; the softmax is fp32.  On the
  card it runs through the latent attention kernel
  (``kernels.mla_attention``), which reads each row's visible keys once;
  on the CPU by two products over the whole cache.

Each call opens an ``attn.mla`` span (rows, width, context: the keys
in reach) and counts ``attn.mla`` in the registry, and
``attn.mla_kernel`` when the kernel runs it.
"""
from __future__ import annotations

import math

import torch

from ..kernels import mla_attention as MK
from ..obs.registry import get_registry
from ..obs.tracing import span as _span
from . import layers as L

_REG = get_registry()
_F32 = torch.float32


# ------------------------------------------------------------- YaRN rope
def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def correction_range(cfg) -> tuple[int, int]:
    """The rotary dims (of the rope dim's pairs) between which YaRN's ramp
    blends extrapolation into interpolation: 10 and 23 at the published
    values."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta

    def at(rotations):
        return (dim * math.log(cfg.rope_original_max
                               / (rotations * 2 * math.pi))
                / (2 * math.log(base)))
    low = math.floor(at(cfg.rope_beta_fast))
    high = math.ceil(at(cfg.rope_beta_slow))
    return max(low, 0), min(high, dim - 1)


def yarn_inv_freq(cfg, device=None) -> torch.Tensor:
    """(rope / 2,) fp32 inverse frequencies: θ^(-2i/rope) extrapolated
    below the low correction dim, divided by the factor (interpolated)
    above the high one, linear between."""
    dim = cfg.qk_rope_head_dim
    extra = 1.0 / cfg.rope_theta ** (
        torch.arange(0, dim, 2, dtype=_F32, device=device) / dim)
    inter = extra / cfg.rope_factor
    low, high = correction_range(cfg)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=_F32, device=device) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def softmax_scale(cfg) -> float:
    """(nope + rope)^-1/2 times YaRN's mscale(factor, mscale_all_dim)^2:
    0.11472 at the published values."""
    m = yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5 * m * m


def rope_angles(positions: torch.Tensor, cfg) -> torch.Tensor:
    """exp(i θ) of YaRN's angles at positions (B, S) or (S,), complex64,
    shaped to broadcast over heads, times mscale(factor, mscale) /
    mscale(factor, mscale_all_dim) (1 at the published values).  The
    layers of one pass share them."""
    inv = yarn_inv_freq(cfg, positions.device)
    ang = positions[..., None].to(_F32) * inv
    m = (yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
         / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))
    return torch.polar(torch.full_like(ang, m), ang)[..., None, :]


def rope_pairs(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, rope) at ``rope_angles``, in fp32:
    each interleaved pair (x[2i], x[2i+1]) rotated by its angle and left
    where it lies.  The modeling code regroups the pairs into halves
    before it rotates them; that permutes q_pe's and k_pe's dims alike
    and leaves every score as it is."""
    pairs = x.to(_F32).reshape(*x.shape[:-1], -1, 2).contiguous()
    out = torch.view_as_real(torch.view_as_complex(pairs) * angles)
    return out.flatten(-2).to(x.dtype)


# ----------------------------------------------------------- parameters
def mla_init(normal, full, cfg, lead: tuple, cdt, pdt) -> dict:
    """One MLA block per entry of ``lead``: the projections (d_in, d_out)
    with std 1/sqrt(d_in) in ``cdt``, the kv-a norm's scale 1 in
    ``pdt``.  ``normal(shape, std, dtype)`` and ``full(shape, value,
    dtype)`` make the leaves (``Model.init_params``)."""
    d, H, R = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
        cfg.v_head_dim

    def proj(d_in, d_out):
        return {"w": normal(lead + (d_in, d_out), 1.0 / math.sqrt(d_in),
                            cdt)}
    return {"wq": proj(d, H * (nope + rope)), "wkv_a": proj(d, R + rope),
            "kv_norm": {"scale": full(lead + (R,), 1.0, pdt)},
            "wkv_b": proj(R, H * (nope + vd)), "wo": proj(H * vd, d)}


def cache_shapes(cfg, n_layers: int, batch: int,
                 max_len: int) -> dict[str, tuple]:
    """The latent slot cache: [c_kv | k_pe], the normed c_kv and the roped
    k_pe of every position, kv_lora_rank + rope values a token, stacked
    on the layer axis (batch on axis 1, as every cache of the port)."""
    return {"ckv": (n_layers, batch, max_len,
                    cfg.kv_lora_rank + cfg.qk_rope_head_dim)}


# ------------------------------------------------------------- products
def _bmm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b with fp32 sums and an fp32 result; bf16 operands stay
    bf16 (cuBLAS's fp32-out product on the card)."""
    if a.dtype == _F32:
        return torch.bmm(a, b.to(_F32))
    return torch.bmm(a, b, out_dtype=_F32)


def _split_kvb(p: dict, cfg):
    """W_kvb as (R, H, nope + v): its key part (H, nope, R) and value part
    (H, R, v), views."""
    H, R = cfg.n_heads, cfg.kv_lora_rank
    w = p["wkv_b"]["w"].reshape(R, H, -1)
    nope = cfg.qk_nope_head_dim
    return w[..., :nope].permute(1, 2, 0), w[..., nope:].permute(1, 0, 2)


def _projections(p: dict, cfg, x: torch.Tensor, angles):
    """q_nope (B, S, H, nope), roped q_pe (B, S, H, rope) and the chunk's
    latent rows [c_kv | k_pe] (B, S, R + rope): c_kv normed, k_pe roped,
    in x's dtype."""
    B, S, _ = x.shape
    H, R = cfg.n_heads, cfg.kv_lora_rank
    nope = cfg.qk_nope_head_dim
    q = L.dense(p["wq"], x).reshape(B, S, H, -1)
    kva = L.dense(p["wkv_a"], x)
    c = L.apply_norm(p["kv_norm"], kva[..., :R], "rmsnorm")
    k_pe = rope_pairs(kva[..., None, R:], angles)[:, :, 0]
    return (q[..., :nope], rope_pairs(q[..., nope:], angles),
            torch.cat([c, k_pe], -1))


def _expanded(p: dict, cfg, q_nope, q_pe, ckv, positions):
    """The published form over the chunk itself (no cache): per-head keys
    [k_nope | k_pe] and values v through the walk.  The walk scales by
    (nope + rope)^-1/2, so q carries the rest of ``softmax_scale``; v is
    zero-padded to the key width and cut back after."""
    B, S, H, nope = q_nope.shape
    R = cfg.kv_lora_rank
    kv = L.dense(p["wkv_b"], ckv[..., :R]).reshape(B, S, H, -1)
    k_pe = ckv[:, :, None, R:]
    k = torch.cat([kv[..., :nope], k_pe.expand(B, S, H, k_pe.shape[-1])],
                  -1)
    hd = k.shape[-1]
    q = torch.cat([q_nope, q_pe], -1).to(_F32) * (
        softmax_scale(cfg) * math.sqrt(hd))
    v = kv[..., nope:]
    vd = v.shape[-1]
    v = torch.cat([v, v.new_zeros((B, S, H, hd - vd))], -1)
    _REG.inc("attn.walk")
    out = L.flash_attention(q, k, v, q_positions=positions,
                            kv_positions=positions, causal=True)
    return out[..., :vd].to(ckv.dtype)


def kernel_route(cfg, ckv: torch.Tensor) -> bool:
    """Whether an absorbed call runs the latent attention kernel
    (``kernels.mla_attention``): at the widths it is built for (rank 512,
    rope 64), on the card, and on the meta tensors of a trace, where it
    stands as one opaque call as it runs on the card.  The CPU keeps the
    products; the kernel's plain version runs there only when called
    directly."""
    return (cfg.kv_lora_rank == MK.VALUE_DIM
            and ckv.shape[-1] == MK.KEY_DIM
            and (ckv.is_cuda or ckv.device.type == "meta"))


def latent_products(q: torch.Tensor, ckv: torch.Tensor, qpos,
                    R: int) -> torch.Tensor:
    """Attention of the scaled latent queries q (B, S, H, R + rope) over
    ckv (B, T, R + rope) by two products over every cached key: fp32
    scores, the keys past each query's position ``qpos`` (B, S) masked,
    an fp32 softmax, P rounded to ckv's dtype.  Returns o_lat (B, S, H,
    R) in ckv's dtype."""
    B, S, H, _ = q.shape
    T = ckv.shape[1]
    dt = ckv.dtype
    s = _bmm32(q.reshape(B, S * H, -1).to(dt), ckv.transpose(1, 2))
    kpos = torch.arange(T, device=s.device)
    late = kpos[None, None, :] > qpos[..., None].to(torch.int64)
    s.view(B, S, H, T).masked_fill_(late[:, :, None, :], -torch.inf)
    prob = torch.softmax(s, -1).to(dt)
    o_lat = _bmm32(prob, ckv[..., :R])                           # (B, S*H, R)
    return o_lat.reshape(B, S, H, R).to(dt)


def _absorbed(p: dict, cfg, q_nope, q_pe, ckv, qpos):
    """Attention over the latent cache ckv (B, T, R + rope): MQA with
    [c_kv | k_pe] keys and c_kv values, queries [q_nope W_kvb_k[h]^T |
    q_pe] scaled before they are rounded to the cache's dtype.  Key t is
    visible to the query of row b at column s when t <= qpos[b, s]
    (B, S).  The latent attention kernel runs it where ``kernel_route``
    takes it (counted as ``attn.mla_kernel``), reading each row's visible
    keys alone; elsewhere ``latent_products``.  Returns (B, S, H, v)."""
    B, S, H, nope = q_nope.shape
    R = cfg.kv_lora_rank
    w_k, w_v = _split_kvb(p, cfg)
    dt = ckv.dtype
    scale = softmax_scale(cfg)
    # (H, B*S, nope) @ (H, nope, R): each head's latent query
    q_lat = _bmm32(q_nope.permute(2, 0, 1, 3).reshape(H, B * S, nope), w_k)
    q = torch.cat([q_lat.reshape(H, B, S, R).permute(1, 2, 0, 3),
                   q_pe.to(_F32)], -1) * scale
    if kernel_route(cfg, ckv):
        _REG.inc("attn.mla_kernel")
        o_lat = MK.mla_attention(q.to(dt), ckv, qpos)
    else:
        o_lat = latent_products(q, ckv, qpos, R)
    o_lat = o_lat.reshape(B * S, H, R).transpose(0, 1)           # (H, B*S, R)
    out = _bmm32(o_lat, w_v)                                     # (H, B*S, v)
    return out.transpose(0, 1).reshape(B, S, H, -1).to(dt)


def mla_apply(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor, *,
              cache: dict | None = None,
              cache_index: int | torch.Tensor | None = None,
              angles=None) -> torch.Tensor:
    """One MLA block on the normed x (B, S, d); returns (B, S, d).
    ``positions`` (B, S) or (S,); ``angles`` their ``rope_angles``, made
    here when not given (a pass makes them once for its layers).  With
    ``cache`` {"ckv": (B, T, R + rope)} the chunk's latent rows are
    written at ``cache_index`` (one int, None for 0, or a (B,) tensor of
    each row's position; rows' writes clamp as ``layers.write_rows``) and
    attention runs absorbed over the cache: over [0, start + S) for one
    int, over all T for per-row positions.  Without a cache the expanded
    form runs over the chunk."""
    B, S, _ = x.shape
    if angles is None:
        angles = rope_angles(positions, cfg)
    q_nope, q_pe, ckv = _projections(p, cfg, x, angles)
    per_row = isinstance(cache_index, torch.Tensor)
    start = None if per_row else (cache_index or 0)
    if cache is None:
        context = S
    elif per_row:
        context = cache["ckv"].shape[1]
    else:
        context = start + S
    _REG.inc("attn.mla")
    with _span("attn.mla", rows=B, width=S, context=context):
        if cache is None:
            o = _expanded(p, cfg, q_nope, q_pe, ckv, positions)
        else:
            if per_row:
                L.write_rows(cache["ckv"], ckv, cache_index)
                qpos = positions
            else:
                cache["ckv"][:, start:start + S] = ckv.to(cache["ckv"].dtype)
                qpos = (start + torch.arange(S, device=ckv.device)).expand(
                    B, S).contiguous()
            o = _absorbed(p, cfg, q_nope, q_pe, cache["ckv"][:, :context],
                          qpos)
        return L.dense(p["wo"], o.reshape(B, S, -1))
