"""RWKV-6 "Finch" block on PyTorch tensors (the counterpart of the
reference's ``models/rwkv.py``): the data-dependent decay WKV recurrence.

Per head (size P), with data-dependent per-channel decay w_t in (0,1),
bonus u, receptance r_t, key k_t, value v_t:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (S in R^{P x P})
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

A prefill from a zero state runs the chunked scan: through B3
(``kernels/wkv6.py``) when the config's ``use_pallas_scan`` knob is on,
through ``wkv_chunked`` otherwise or when an incoming state is given.
Decode is the O(1)-state step.  Token shift is the reference's
simplified Finch interpolation (the LoRA generators folded into dense
maps).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.wkv6 import wkv6_scan, wkv6_scan_plain
from .layers import Params, dense, pad_seq


def rwkv_dims(cfg):
    head_dim = 64
    return cfg.d_model // head_dim, head_dim


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None):
    """Shift right by one token; ``prev`` is the carry for decode."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    shifted = torch.cat([prev, x[:, :-1]], dim=1)
    return shifted, x[:, -1:]


def wkv_chunked(r, k, v, logw, u, *, chunk: int, init_state=None):
    """Chunked WKV6: r/k/v (B,S,H,P), logw (B,S,H,P) = log decay < 0.

    Returns (y, final_state) with state (B,H,P,P) mapping key-dim to
    value-dim, from ``init_state`` or zeros: the sequence padded to the
    chunk, then B3's plain version, which walks the chunks in order."""
    S = r.shape[1]
    C = min(chunk, S)
    pad = (-S) % C
    # zero-contribution padding: logw=0 => w=1, k=v=r=0
    y, state = wkv6_scan_plain(*(pad_seq(t, pad) for t in (r, k, v, logw)),
                               u, chunk=C, init_state=init_state)
    return y[:, :S], state


def rwkv_time_apply(p: Params, cfg, x: torch.Tensor, *, state=None,
                    shift=None, decode: bool = False,
                    heads: int | None = None, enter=None):
    """Returns (y, (state, shift_carry)).  ``heads``: the heads this call
    runs (a tensor-parallel rank's, whose ``wr``..``ww`` columns, ``u``
    and ``w_bias`` it holds; ``wo``'s output is then its partial sum);
    all of them when None.  ``enter`` maps each mixed input as it enters
    its split projection (``TensorParallel.enter``)."""
    nh, hd = rwkv_dims(cfg)
    nh = heads or nh
    B, S, _ = x.shape
    prev, new_shift = _token_shift(x, shift)
    mix = p["mix"].to(x.dtype)
    xr = x + (prev - x) * mix[0]
    xk = x + (prev - x) * mix[1]
    xv = x + (prev - x) * mix[2]
    xw = x + (prev - x) * mix[3]
    xg = x + (prev - x) * mix[4]
    if enter is not None:
        xr, xk, xv, xw, xg = map(enter, (xr, xk, xv, xw, xg))
    f32 = torch.float32
    r = dense(p["wr"], xr).reshape(B, S, nh, hd).to(f32)
    k = dense(p["wk"], xk).reshape(B, S, nh, hd).to(f32)
    v = dense(p["wv"], xv).reshape(B, S, nh, hd).to(f32)
    g = F.silu(dense(p["wg"], xg))
    logw = -torch.exp((dense(p["ww"], xw).to(f32)
                       + p["w_bias"]).reshape(B, S, nh, hd))  # < 0

    if decode:
        if state is None:
            state = torch.zeros((B, nh, hd, hd), dtype=f32, device=x.device)
        w = torch.exp(logw[:, 0])                         # (B,H,P)
        kv = torch.einsum("bhp,bhq->bhpq", k[:, 0], v[:, 0])
        y = torch.einsum("bhp,bhpq->bhq", r[:, 0],
                         state + p["u"][None, :, :, None] * kv)
        new_state = state * w[..., None] + kv
        y = y[:, None]
    elif cfg.use_pallas_scan and state is None:
        # B3 from a zero state; the caller pads to the chunk
        C = min(cfg.ssd_chunk, S)
        pad = (-S) % C
        y, new_state = wkv6_scan(
            *(pad_seq(t, pad) for t in (r, k, v, logw)),
            p["u"].to(f32), chunk=C)
        y = y[:, :S]
    else:
        y, new_state = wkv_chunked(r, k, v, logw, p["u"],
                                   chunk=cfg.ssd_chunk, init_state=state)
    y = y.reshape(B, S, nh * hd).to(x.dtype) * g
    return dense(p["wo"], y), (new_state, new_shift)


def rwkv_channel_apply(p: Params, cfg, x: torch.Tensor, *, shift=None,
                       reduce=None, enter=None):
    """Returns (y, shift_carry).  ``reduce`` sums the ``wv`` output over
    tensor-parallel ranks (each holds a share of d_ff) before the
    receptance gates it; ``enter`` maps ``wk``'s input as it enters that
    split region (``wr``, whole on every rank, reads its own)."""
    prev, new_shift = _token_shift(x, shift)
    mix = p["mix"].to(x.dtype)
    xk = x + (prev - x) * mix[0]
    if enter is not None:
        xk = enter(xk)
    xr = x + (prev - x) * mix[1]
    k = torch.square(torch.relu(dense(p["wk"], xk)))
    v = dense(p["wv"], k)
    if reduce is not None:
        v = reduce(v)
    return torch.sigmoid(dense(p["wr"], xr)) * v, new_shift


def rwkv_time_ref(p: Params, cfg, x: torch.Tensor):
    """Sequential O(S) reference for tests."""
    nh, hd = rwkv_dims(cfg)
    B = x.shape[0]
    state = torch.zeros((B, nh, hd, hd), dtype=torch.float32,
                        device=x.device)
    shift = torch.zeros((B, 1, cfg.d_model), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(x.shape[1]):
        y, (state, shift) = rwkv_time_apply(p, cfg, x[:, t:t + 1],
                                            state=state, shift=shift,
                                            decode=True)
        ys.append(y[:, 0])
    return torch.stack(ys, dim=1)
