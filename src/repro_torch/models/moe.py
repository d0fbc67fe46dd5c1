"""Mixture-of-experts MLP on PyTorch tensors (the counterpart of the
reference's ``models/moe.py``): fine-grained routed experts plus shared
experts.

Deepseek-MoE style (2 shared + 64 routed, top-6) and Granite-MoE style
(32 routed, top-8).  The router's logits, softmax and top-k and every
expert product run in fp32, as in the reference, which upcasts the
banks at every use.  The port stores the banks (and the shared experts)
in the compute dtype, as it stores every projection, and upcasts them
here, once per layer call: at full width (bf16 compute, fp32 parameters
in the configs) the port therefore equals the reference run with
``param_dtype="bfloat16"``; on the fp32 smoke configs it equals the
reference exactly.

Two dispatches, chosen by ``cfg.moe_dispatch``:

- "dense" (the default): every expert processes every token, weighted by
  a (B, S, E) combine matrix that is zero off the token's top-k, at
  E / top_k times the routed work.  Rows are independent, so it serves
  behind the continuous scheduler.
- "gathered": capacity-bucketed sort dispatch; overflow tokens drop
  (Switch semantics), so rows share expert capacity.  The scatter into
  the expert buffers and the sort are the reference's (a stable argsort
  on expert ids, the same searchsorted positions, so the same tokens
  drop); the combine sums each token's k contributions in a fixed order
  instead of the reference's scatter-add, so it does not depend on the
  order of atomic adds on the card.

There is no hand kernel on this path: the reference's experts are
``jnp.einsum``s, and the family's layers have no dense MLP, so no GOMA
kernel is dispatched.  ``moe_apply`` also returns the Switch
load-balancing loss.

On a tensor-parallel rank (``tp``; expert parallelism on the model axis)
the banks hold the rank's E/TP experts and the shared experts its share
of their d_ff; the router is whole, so every rank routes every token
alike, runs its own experts on the tokens routed to them and sums its
partial output in the fixed order above; one all_reduce then adds the
ranks' partial sums (``parallel.tp_sum``).  The tokens and the combine
weights enter the experts' split region (``TensorParallel.enter``), so
in training the router gets every rank's share of the gradient through
the weights, and its load-balancing loss, the same on every rank, once.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import Params
from .parallel import tp_sum

_F32 = torch.float32


def moe_init(normal, cfg, lead: tuple, dtype: torch.dtype) -> Params:
    """One MoE MLP per entry of ``lead`` (the layer stack), with the
    reference's scales: the router (d, E) in fp32 with std 1/sqrt(d), the
    banks (E, d_in, d_out) and the shared experts' projections with std
    1/sqrt(d_in) in ``dtype``.  ``normal(shape, std, dtype)`` draws the
    weights (``Model.init_params``' generator on its device)."""
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff

    def bank(din, dout):
        return normal(lead + (E, din, dout), 1.0 / math.sqrt(din), dtype)

    def proj(din, dout, dt):
        return {"w": normal(lead + (din, dout), 1.0 / math.sqrt(din), dt)}

    p = {"router": proj(d, E, _F32), "wg": bank(d, ff), "wu": bank(d, ff),
         "wd": bank(ff, d)}
    if cfg.shared_experts:
        ffs = ff * cfg.shared_experts
        p["shared"] = {"wg": proj(d, ffs, dtype), "wu": proj(d, ffs, dtype),
                       "wd": proj(ffs, d, dtype)}
    return p


def _route(p: Params, cfg, xf: torch.Tensor):
    """Router probabilities (..., E) and the renormalised top-k weights
    and expert ids (..., k) of fp32 token rows ``xf``."""
    probs = torch.softmax(xf @ p["router"]["w"].to(_F32), dim=-1)
    top_w, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, top_w / torch.sum(top_w, dim=-1, keepdim=True), top_i


def _aux_loss(probs: torch.Tensor, top_i: torch.Tensor, E: int,
              k: int, data_mean=None) -> torch.Tensor:
    """Switch load balancing: E * sum_e f_e * P_e / k, with f_e the share
    of tokens routing to expert e and P_e its mean probability; with
    ``data_mean`` (a training loss on data ranks: the differentiable mean
    over them, ``launch.mesh.HostMesh.data_mean``) both means are over
    the global batch, the data ranks' means averaged, as the reference's
    loss takes them over its sharded batch."""
    tokens = probs.reshape(-1, E)
    picked = F.one_hot(top_i.reshape(-1, k), E).sum(1).to(_F32)
    f, P = picked.mean(0), tokens.mean(0)
    if data_mean is not None:
        f, P = data_mean(torch.cat([f, P])).split(E)
    return E * torch.sum(f * P) / k


def _shared(p: Params, xf: torch.Tensor) -> torch.Tensor:
    sh = p["shared"]
    h = F.silu(xf @ sh["wg"]["w"].to(_F32)) * (xf @ sh["wu"]["w"].to(_F32))
    return h @ sh["wd"]["w"].to(_F32)


def _local_experts(p: Params, tp) -> tuple[int, int]:
    """The range of expert ids this rank's banks hold."""
    n = p["wd"].shape[0]
    lo = tp.index * n if tp is not None and tp.experts_split else 0
    return lo, lo + n


def _enter(tp, x: torch.Tensor, path: str) -> torch.Tensor:
    return x if tp is None else tp.enter(x, path)


def _combine_shared(p: Params, cfg, xf, y, tp):
    parts = [(y, tp is not None and tp.experts_split)]
    if cfg.shared_experts:
        parts.append((_shared(p, _enter(tp, xf, "layers/moe/shared/wd/w")),
                      tp is not None and tp.shared_split))
    return tp_sum(tp, parts)


def moe_apply(p: Params, cfg, x: torch.Tensor, *, tp=None,
              data_mean=None):
    """x: (B, S, d).  Returns (y in x's dtype, aux loss); the dispatch per
    ``cfg.moe_dispatch``.  ``data_mean``: the mean over the data ranks
    that takes the aux loss over the global batch (a training loss on
    data ranks; ``_aux_loss``)."""
    if getattr(cfg, "moe_dispatch", "dense") == "gathered":
        return moe_apply_gathered(p, cfg, x, tp=tp, data_mean=data_mean)
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(B * S, d).to(_F32)
    probs, top_w, top_i = _route(p, cfg, xf)
    # the combine weights as a dense (T, E) matrix: zero off the top-k
    combine = _enter(tp, torch.zeros_like(probs).scatter_add_(
        -1, top_i, top_w), "layers/moe/wd")
    lo, hi = _local_experts(p, tp)
    # every (local) expert over every token: (E, T, F), one batched
    # product each
    xe = _enter(tp, xf, "layers/moe/wd")
    g = torch.matmul(xe, p["wg"].to(_F32))
    u = torch.matmul(xe, p["wu"].to(_F32))
    h = F.silu(g) * u * combine.T[lo:hi, :, None]
    # sum over (expert, f) in one product: (T, E * F) @ (E * F, d)
    wd = p["wd"].to(_F32)
    y = h.permute(1, 0, 2).reshape(B * S, -1) @ wd.reshape(-1, d)
    y = _combine_shared(p, cfg, xf, y, tp)
    aux = _aux_loss(probs, top_i, E, k, data_mean)
    return y.reshape(B, S, d).to(x.dtype), aux


def moe_apply_gathered(p: Params, cfg, x: torch.Tensor, *,
                       capacity_factor: float = 1.25, tp=None,
                       data_mean=None):
    """Sort-based capacity-bucketed dispatch: each expert processes at most
    C = capacity_factor * T * k / E of its routed tokens, in the order of
    a stable sort on expert ids; the rest drop.  A trash row absorbs the
    dropped tokens' scatters.  A tensor-parallel rank runs its experts'
    buffers; tokens routed elsewhere contribute zeros to its partial sum."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    dev = x.device
    xf = x.reshape(T, d).to(_F32)
    probs, top_w, top_i = _route(p, cfg, xf)

    C = max(1, int(capacity_factor * T * k / E))
    eid = top_i.reshape(-1)                             # (T*k,)
    order = torch.argsort(eid, stable=True)
    sorted_eid = eid[order]
    starts = torch.searchsorted(sorted_eid, torch.arange(E, device=dev))
    pos_in_expert = torch.arange(T * k, device=dev) - starts[sorted_eid]
    keep = pos_in_expert < C
    buf_idx = torch.where(keep, sorted_eid * C + pos_in_expert, E * C)

    # scatter the tokens into (E*C [+1 trash], d) expert buffers
    xbuf = torch.zeros((E * C + 1, d), dtype=_F32, device=dev)
    xbuf[buf_idx] = _enter(tp, xf, "layers/moe/wd")[order // k]
    lo, hi = _local_experts(p, tp)
    xe = xbuf[:E * C].reshape(E, C, d)[lo:hi]
    g = torch.bmm(xe, p["wg"].to(_F32))
    u = torch.bmm(xe, p["wu"].to(_F32))
    ye = torch.bmm(F.silu(g) * u, p["wd"].to(_F32)).reshape(-1, d)
    if hi - lo != E:
        ye = torch.zeros((E * C, d), dtype=_F32, device=dev).index_copy_(
            0, torch.arange(lo * C, hi * C, device=dev), ye)
    # back to (token, choice) order: each token sums its k contributions
    # in a fixed order; dropped ones weigh zero
    slot = torch.empty_like(buf_idx)
    slot[order] = buf_idx
    weight = _enter(tp, top_w.reshape(-1) * (slot < E * C),
                    "layers/moe/wd")
    contrib = ye[torch.clamp(slot, max=E * C - 1)] * weight[:, None]
    y = _combine_shared(p, cfg, xf, contrib.reshape(T, k, d).sum(1), tp)
    aux = _aux_loss(probs, top_i, E, k, data_mean)
    return y.reshape(B, S, d).to(x.dtype), aux
