"""Mixture-of-experts MLP on PyTorch tensors (the counterpart of the
reference's ``models/moe.py``): fine-grained routed experts plus shared
experts.

Deepseek-MoE style (2 shared + 64 routed, top-6) and Granite-MoE style
(32 routed, top-8).  The router's logits, softmax and top-k run in fp32,
as in the reference.  The port stores the banks (and the shared experts)
in the compute dtype, as it stores every projection.

Three dispatches, chosen by ``cfg.moe_dispatch``:

- "dense" (the default): every expert processes every token, weighted by
  a (B, S, E) combine matrix that is zero off the token's top-k, at
  E / top_k times the routed work.  Its products run in fp32: the banks
  are upcast here, once per layer call, as the reference upcasts them at
  every use, so at full width (bf16 compute, fp32 parameters in the
  configs) the port equals the reference run with
  ``param_dtype="bfloat16"``; on the fp32 smoke configs it equals the
  reference exactly.  Rows are independent, so it serves behind the
  continuous scheduler.
- "gathered": capacity-bucketed sort dispatch, in fp32 as "dense";
  overflow tokens drop (Switch semantics), so rows share expert
  capacity.  The scatter into the expert buffers and the sort are the
  reference's (a stable argsort on expert ids, the same searchsorted
  positions, so the same tokens drop); the combine sums each token's k
  contributions in a fixed order instead of the reference's scatter-add,
  so it does not depend on the order of atomic adds on the card.
- "dropless" (``moe_apply_dropless``; DeepSeek-V2-Lite): the (token,
  expert) pairs sorted by expert, every routed row through its expert as
  grouped products over the experts in the compute dtype
  (``grouped_mm``), and each token's k contributions combined in a fixed
  order.  No capacity, no dropped row, and no expert runs a row that was
  not routed to it, so rows stay independent.  The top-k weights are
  renormalised only where the config says so (``norm_topk_prob``) and
  then scaled (``routed_scale``); the shared experts are one gated MLP of
  their summed width through ``layers.mlp_apply``, so with ``fused_mlp``
  they take the GOMA kernels (``kernels/ops.py``), as a dense layer's
  MLP does.  Each call opens a ``moe.route`` span (rows) and counts
  ``moe.dropless.calls`` and ``moe.rows_routed``; with ``ROUTE_LOAD``
  switched on it sums each expert's routed rows on the device
  (``RouteLoad``).

The "dense" and "gathered" experts are ``einsum``s in the reference and
take no hand kernel here.  ``moe_apply`` also returns the Switch
load-balancing loss.

On a tensor-parallel rank (``tp``; expert parallelism on the model axis;
"dense" and "gathered")
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

import contextlib
import math

import torch
import torch.nn.functional as F

from ..obs.registry import get_registry
from ..obs.tracing import span as _span
from . import layers as L
from .layers import Params
from .parallel import tp_sum

_F32 = torch.float32
_REG = get_registry()


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
    dispatch = getattr(cfg, "moe_dispatch", "dense")
    if dispatch == "gathered":
        return moe_apply_gathered(p, cfg, x, tp=tp, data_mean=data_mean)
    if dispatch == "dropless":
        return moe_apply_dropless(p, cfg, x, tp=tp, data_mean=data_mean)
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


class RouteLoad:
    """Routed rows per expert, summed on the device over the dropless
    calls made while ``on``: ``rows`` (E,), the number of calls, and the
    sum over calls of the largest expert's rows over the mean rows an
    expert (rows x k / E).  Nothing is read back during a call; ``read``
    copies the sums to the host once.

    The sums are made at the first call that records and zeroed in place,
    and ``on`` is a flag on the device too, which each call multiplies
    in.  Calls made under ``recording`` (a CUDA graph's capture,
    ``serving.graphs``) are recorded whether on or not, so that each
    replay adds its calls just while ``on``."""

    def __init__(self):
        self._on = False
        self._graphed = False
        self.rows = self.max_share = self.calls = self.flag = None

    @property
    def on(self) -> bool:
        return self._on

    @on.setter
    def on(self, value: bool) -> None:
        self._on = bool(value)
        if self.flag is not None:
            self.flag.fill_(float(self._on))

    @contextlib.contextmanager
    def recording(self):
        """Record every call inside, on or not (a graph's capture)."""
        self._graphed = True
        try:
            yield
        finally:
            self._graphed = False

    def reset(self) -> None:
        for t in (self.rows, self.max_share, self.calls):
            if t is not None:
                t.zero_()

    def add(self, counts: torch.Tensor, routed: int) -> None:
        if counts.device.type == "meta" or not (self._on or self._graphed):
            return
        if self.rows is None or self.rows.shape != counts.shape or \
                self.rows.device != counts.device:
            dev = counts.device
            # normal tensors, which serving's inference mode and the
            # switches outside it may both update
            with torch.inference_mode(False):
                self.rows = torch.zeros(counts.shape, dtype=counts.dtype,
                                        device=dev)
                self.max_share = torch.zeros((), dtype=_F32, device=dev)
                self.calls = torch.zeros((), dtype=_F32, device=dev)
                self.flag = torch.full((), float(self._on), dtype=_F32,
                                       device=dev)
        share = counts.max().to(_F32) * (counts.numel() / routed)
        self.rows += counts * self.flag.to(counts.dtype)
        self.max_share += share * self.flag
        self.calls += self.flag

    def read(self) -> dict:
        """{"calls", "rows" (a list by expert), "max_share_sum"}."""
        if self.rows is None:
            return {"calls": 0, "rows": [], "max_share_sum": 0.0}
        return {"calls": int(self.calls), "rows": self.rows.tolist(),
                "max_share_sum": float(self.max_share)}


ROUTE_LOAD = RouteLoad()


def grouped_mm(xs: torch.Tensor, w: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """Rows xs (R, d_in) sorted by expert, times their experts' weights
    w (E, d_in, d_out): rows [ends[e-1], ends[e]) through expert e.  One
    grouped product (``torch._grouped_mm``) where it takes the operands
    (16-byte strides; bf16 on the card), else a loop over the experts
    that reads the row counts back.  On the meta device (a capture, a
    program analysis) the result's shape alone."""
    if xs.device.type == "meta":
        return xs.new_empty((xs.shape[0], w.shape[-1]))
    aligned = all(t.shape[-1] * t.element_size() % 16 == 0 for t in (xs, w))
    if aligned and (xs.device.type == "cpu" or xs.dtype == torch.bfloat16):
        return torch._grouped_mm(xs, w, offs=ends.to(torch.int32))
    out = xs.new_empty((xs.shape[0], w.shape[-1]))
    lo = 0
    for e, hi in enumerate(ends.tolist()):
        if hi > lo:
            out[lo:hi] = xs[lo:hi] @ w[e]
        lo = hi
    return out


def combine_choices(ys: torch.Tensor, order: torch.Tensor,
                    top_w: torch.Tensor) -> torch.Tensor:
    """Expert outputs ys (T * k, d) in the sorted order ``order`` back in
    (token, choice) order, weighed by ``top_w`` (T, k) and summed over each
    token's choices in their order, in fp32: (T, d)."""
    y = torch.empty_like(ys)
    y[order] = ys
    return (y.reshape(*top_w.shape, -1).to(_F32) * top_w[..., None]).sum(1)


def moe_apply_dropless(p: Params, cfg, x: torch.Tensor, *, tp=None,
                       data_mean=None):
    """Every routed (token, expert) pair through its expert, nothing
    dropped: pairs sorted stably by expert, grouped products in x's
    dtype, the gate's silu in fp32, each token's k outputs weighed and
    summed in a fixed order in fp32, plus the shared experts.  The
    load-balancing loss is None under inference mode.  One device
    only."""
    if tp is not None:
        raise ValueError("the dropless dispatch runs on one device")
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    _REG.inc("moe.dropless.calls")
    _REG.inc("moe.rows_routed", T * k)
    with _span("moe.route", rows=T):
        probs = torch.softmax(xt.to(_F32) @ p["router"]["w"].to(_F32), -1)
        top_w, top_i = torch.topk(probs, k, dim=-1)
        if getattr(cfg, "norm_topk_prob", True):
            top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
        scale = getattr(cfg, "routed_scale", 1.0)
        if scale != 1.0:
            top_w = top_w * scale
        eid = top_i.reshape(-1)
        order = torch.argsort(eid, stable=True)
        counts = torch.zeros(E, dtype=torch.int64, device=x.device)
        counts.scatter_add_(0, eid, torch.ones_like(eid))
        ROUTE_LOAD.add(counts, T * k)
        ends = torch.cumsum(counts, 0, dtype=torch.int32)
    xs = xt[order // k]
    g = grouped_mm(xs, p["wg"], ends)
    u = grouped_mm(xs, p["wu"], ends)
    h = (F.silu(g.to(_F32)) * u.to(_F32)).to(x.dtype)
    y = combine_choices(grouped_mm(h, p["wd"], ends), order, top_w)
    if cfg.shared_experts:
        y = y + L.mlp_apply(p["shared"], x,
                            use_fused=cfg.fused_mlp).reshape(T, d).to(_F32)
    # serving (inference mode) has no use for the load-balancing loss
    aux = (None if torch.is_inference_mode_enabled()
           else _aux_loss(probs, top_i, E, k, data_mean))
    return y.reshape(B, S, d).to(x.dtype), aux
