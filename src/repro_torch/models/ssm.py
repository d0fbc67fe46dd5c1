"""Mamba2 (SSD) block on PyTorch tensors (the counterpart of the
reference's ``models/ssm.py``): chunked parallel form and decode step.

State-space duality form (Dao & Gu 2024): per head h with scalar decay
a_t = exp(A * dt_t), A = -exp(A_log), state S in R^{P x N}:

    S_t = a_t S_{t-1} + dt_t * x_t B_t^T          y_t = C_t^T S_t + D x_t

A prefill from a zero state runs the chunked scan: through B4
(``kernels/mamba2_ssd.py``) followed by the D x skip when the config's
``use_pallas_scan`` knob is on, as the knob's documentation in
``configs/base.py`` says; through ``ssd_chunked`` otherwise or when an
incoming state is given.  Decode is the single-step recurrence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.mamba2_ssd import ssd_scan, ssd_scan_plain
from .layers import Params, dense, pad_seq


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def _causal_conv(xs: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor | None = None):
    """xs: (B,S,C); w: (K,C).  Depthwise causal conv; returns (y,
    new_state) where state carries the trailing K-1 inputs for decode."""
    K = w.shape[0]
    if state is None:
        pad = xs.new_zeros((xs.shape[0], K - 1, xs.shape[2]))
    else:
        pad = state.to(xs.dtype)
    xp = torch.cat([pad, xs], dim=1)
    wc = w.to(xs.dtype)
    y = sum(xp[:, i:i + xs.shape[1], :] * wc[i] for i in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else None
    return F.silu(y), new_state


def _split_proj(zxbcdt, d_inner: int, ns: int, nh: int):
    z, x, Bm, Cm, dt = torch.split(
        zxbcdt, [d_inner, d_inner, ns, ns, nh], dim=-1)
    return z, x, Bm, Cm, dt


def ssd_chunked(xh, dt, a_log, Bm, Cm, D, *, chunk: int,
                init_state=None):
    """Chunked SSD scan with the D x skip.

    xh: (B,S,H,P)  dt: (B,S,H)  Bm/Cm: (B,S,N)  a_log: (H,) (A = -exp(a_log))
    Returns y: (B,S,H,P), final_state: (B,H,P,N), from ``init_state`` or
    zeros: the sequence padded to the chunk, then B4's plain version,
    which walks the chunks in order.
    """
    S = xh.shape[1]
    C = min(chunk, S)
    pad = (-S) % C
    # zero-contribution padding: dt=0 => decay exp(0)=1, input 0
    y, state = ssd_scan_plain(*(pad_seq(t, pad) for t in (xh, dt)), a_log,
                              *(pad_seq(t, pad) for t in (Bm, Cm)),
                              chunk=C, init_state=init_state)
    return y[:, :S] + xh * D[None, None, :, None], state


def ssm_apply(p: Params, cfg, x: torch.Tensor, *, state=None,
              conv_state=None, decode: bool = False,
              heads: int | None = None):
    """x: (B,S,d_model).  Returns (y, (state, conv_state)).  ``heads``:
    the heads this call runs (a tensor-parallel rank's, whose
    [z, x, B, C, dt] columns of ``in_proj``, [x, B, C] of ``conv_w``,
    ``A_log``, ``D``, ``dt_bias`` and ``out_proj`` rows it holds; the
    output is then its partial sum); all of them when None."""
    _, nh, hd, ns = ssm_dims(cfg)
    nh = heads or nh
    d_inner = nh * hd
    f32 = torch.float32
    zxbcdt = dense(p["in_proj"], x)
    z, xs, Bm, Cm, dt = _split_proj(zxbcdt, d_inner, ns, nh)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], conv_state)
    xs, Bm, Cm = torch.split(conv_out, [d_inner, ns, ns], dim=-1)
    dt = F.softplus(dt.to(f32) + p["dt_bias"][None, None, :])
    B_, S, _ = x.shape
    xh = xs.reshape(B_, S, nh, hd).to(f32)

    if decode:
        # single-step recurrence (S == 1)
        a = torch.exp(dt[:, 0] * (-torch.exp(p["A_log"]))[None, :])  # (B,H)
        if state is None:
            state = torch.zeros((B_, nh, hd, ns), dtype=f32, device=x.device)
        upd = torch.einsum("bhp,bk->bhpk", xh[:, 0] * dt[:, 0, :, None],
                           Bm[:, 0].to(f32))
        new_state = state * a[..., None, None] + upd
        y = torch.einsum("bhpk,bk->bhp", new_state, Cm[:, 0].to(f32))
        y = y + xh[:, 0] * p["D"][None, :, None]
        y = y[:, None]
    elif cfg.use_pallas_scan and state is None:
        # B4 from a zero state, then the D x skip; the caller pads to the
        # chunk
        C = min(cfg.ssd_chunk, S)
        pad = (-S) % C
        y, new_state = ssd_scan(
            pad_seq(xh, pad), pad_seq(dt, pad), p["A_log"],
            pad_seq(Bm.to(f32), pad), pad_seq(Cm.to(f32), pad), chunk=C)
        y = y[:, :S] + xh * p["D"][None, None, :, None]
    else:
        y, new_state = ssd_chunked(xh, dt, p["A_log"], Bm.to(f32),
                                   Cm.to(f32), p["D"],
                                   chunk=cfg.ssd_chunk, init_state=state)
    y = y.reshape(B_, S, d_inner).to(x.dtype) * F.silu(z)
    return dense(p["out_proj"], y), (new_state, new_conv)


def ssm_ref_scan(p: Params, cfg, x: torch.Tensor):
    """O(S) sequential reference for tests (token-by-token recurrence)."""
    B = x.shape[0]
    d_inner, nh, hd, ns = ssm_dims(cfg)
    conv_dim = d_inner + 2 * ns
    state = torch.zeros((B, nh, hd, ns), dtype=torch.float32,
                        device=x.device)
    conv_state = torch.zeros((B, cfg.conv_kernel - 1, conv_dim),
                             dtype=x.dtype, device=x.device)
    ys = []
    for t in range(x.shape[1]):
        y, (state, conv_state) = ssm_apply(
            p, cfg, x[:, t:t + 1], state=state, conv_state=conv_state,
            decode=True)
        ys.append(y[:, 0])
    return torch.stack(ys, dim=1)
