"""Explicit Megatron tensor parallelism of every family over a mesh's
"model" axis.

The reference places its parameters under the rule table
(``sharding.rules``) and lets GSPMD lower every program with
collectives.  The port runs the same split by hand: each rank holds the
local slice of every split parameter, runs its share of the heads (of
attention, of the RWKV time mix, of the Mamba2 scan), of d_ff, of the
experts and of the vocabulary, and sums the partial results with one
``all_reduce`` after each row-split projection (the attention's and the
cross-attention's ``wo``, the MLP's ``wd`` or the MoE's partial sum, the
RWKV time mix's ``wo`` and channel mix's ``wv``, the Mamba2
``out_proj``), one after a vocab-parallel embedding lookup (a masked
local lookup) and one to gather the vocab-parallel logits (written into
a zero-filled full-width buffer: an exact gather with the only
collective besides ``broadcast`` that gloo runs on CUDA tensors).

Where the rule's split cannot run as it is, the execution layout
differs from the rule (ROADMAP C13, C14):

- ``replicated``: a tensor the rule splits that every rank holds whole.
  Attention weights the rule cuts inside a head (``attn/wk/w`` with
  fewer KV heads than ranks; ``attn/wq/w``, ``attn/wo/w`` with a head
  count the ranks do not divide; the same for ``xattn``), where each
  rank's query heads then read the one KV head they share
  (``kv_range``); the RWKV time mix where the ranks do not divide its
  heads of 64; the Mamba2 mixer where they do not divide its heads; and
  the channel mix's ``chan/wr``, whose sigmoid gates the *summed*
  ``wv`` output, so a column slice of it cannot be used before the sum.
- ``relaid``: a tensor each rank holds a slice of that is not the
  rule's block.  ``time/w_bias`` (rule: replicated) is added per head
  after ``time/ww``, so each rank keeps its heads' slice.
  ``ssm/in_proj/w`` packs [z, x, B, C, dt] and ``ssm/conv_w`` [x, B, C]
  in its columns, which a contiguous split cuts across: each rank keeps
  [z_r, x_r, B, C, dt_r] and [x_r, B, C] (its heads' channels and the
  one group's B and C whole; ``ssm_columns``).

The caches follow the execution layout: KV caches and recurrent states
hold the rank's heads, the Mamba2 conv carry its [x_r, B, C] channels,
and the RWKV token-shift carries and the encoder's output stay at the
full d_model (they feed replicated inputs).

Training differentiates through the collectives (Megatron's f and g):
each sum over the model axis (``all_reduce``: the row-split outputs,
the vocab-parallel embedding) passes its gradient through unchanged, and
every input that enters a split region (``enter``) is the identity
forward with an ``all_reduce`` of its gradient backward, so a
replicated activation gets the gradient of every rank's share; the
logits gather hands each rank back its own columns.  A leaf each rank
holds whole but uses only in part gets its gradient summed over the
model axis after the backward (``sum_grad``).  Under ``no_grad`` and
``inference_mode`` the forward runs the same collectives, in place, as
serving always has.
"""
from __future__ import annotations

import re
import time

import torch
import torch.distributed as dist

from ..sharding.rules import (TP, P, flatten_with_paths, leaf_at,
                              local_copy, map_with_paths, param_shardings)
from .rwkv import rwkv_dims
from .ssm import ssm_dims

_QO = re.compile(r"(^|/)x?attn/w[qo]/w$")
_KV = re.compile(r"(^|/)x?attn/w[kv]/w$")
_TIME = re.compile(r"(^|/)time/(w[rkvgwo]/w|u)$")
_SSM = re.compile(r"(^|/)ssm/")
_CHAN_R = re.compile(r"(^|/)chan/wr/w$")
_W_BIAS = re.compile(r"(^|/)time/w_bias$")
_PACKED = re.compile(r"(^|/)ssm/(in_proj/w|conv_w)$")


def ssm_columns(cfg, index: int, size: int) -> dict[str, torch.Tensor]:
    """The columns of ``ssm/in_proj/w`` ([z, x, B, C, dt]) and of
    ``ssm/conv_w`` ([x, B, C]) that rank ``index`` of ``size`` keeps:
    its heads' z, x and dt and the whole B and C, in that order."""
    d_inner, nh, _, ns = ssm_dims(cfg)
    di, h = d_inner // size, nh // size

    def at(lo, n):
        return torch.arange(lo, lo + n)

    x, bc = at(d_inner + index * di, di), at(2 * d_inner, 2 * ns)
    return {"in_proj": torch.cat([at(index * di, di), x, bc,
                                  at(2 * d_inner + 2 * ns + index * h, h)]),
            "conv_w": torch.cat([x - d_inner, bc - d_inner])}


def all_reduce_timed(t: torch.Tensor, group, comm: dict | None,
                     kind: str) -> None:
    """``dist.all_reduce(t)`` over ``group``, in place, counted in
    ``comm[kind]``: calls, bytes and the host seconds inside the call
    (waits for queued device work and for the other ranks included).  A
    trace's meta tensor has no values to sum: its call is counted (no
    seconds) and not run, so that a program analysis sees the
    collectives a run makes (``launch.roofline``)."""
    meta = t.device.type == "meta"
    t0 = time.perf_counter()
    if not meta:
        dist.all_reduce(t, group=group)
    if comm is not None:
        row = comm.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
        row["calls"] += 1
        row["bytes"] += t.numel() * t.element_size()
        row["seconds"] += 0.0 if meta else time.perf_counter() - t0


class _SumOverModel(torch.autograd.Function):
    """Sum over the model axis: an all_reduce forward; the identity
    backward, since every rank holds the same gradient of the sum."""

    @staticmethod
    def forward(ctx, x, tp, kind):
        y = x.clone(memory_format=torch.contiguous_format)
        tp.reduce_in_place(y, kind)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _EnterSplit(torch.autograd.Function):
    """Enter a split region: the identity forward; the backward sums the
    gradient over the model axis, since each rank's share of the region
    gives only its part of it."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        ctx.tp.reduce_in_place(g, "tp_enter")
        return g, None


class _GatherColumns(torch.autograd.Function):
    """The ranks' column blocks gathered exactly (each writes its own
    into zeros; one all_reduce sums them); the backward hands each rank
    back its own columns."""

    @staticmethod
    def forward(ctx, local, tp, width):
        full, ctx.lo = tp.columns_in_zeros(local, width)
        ctx.n = local.shape[-1]
        tp.reduce_in_place(full, "logits_gather")
        return full

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.lo + ctx.n], None, None


class TensorParallel:
    """A model's tensor-parallel layout on ``mesh`` (``launch.mesh``),
    for this rank: the execution spec of every parameter (``specs``),
    the parameters whose rule spec it replicates (``replicated``) or lays
    out otherwise (``relaid``), which projections are split
    (``split``), the local head counts of each attention block
    (``heads``), of the RWKV time mix (``rwkv_heads``) and of the Mamba2
    mixer (``ssm_heads``), and the collectives, each counted
    (``all_reduces``, ``broadcasts``, ``token_checks``; in training also
    by kind in ``comm``: calls, bytes, host seconds)."""

    def __init__(self, model, mesh, *, strict: bool = True):
        cfg = model.cfg
        self.cfg = cfg
        self.mesh = mesh
        self.size = n = mesh.shape.get(TP, 1)
        self.index = mesh.coords[TP] if mesh.coords is not None else 0
        self.group = mesh.model_group
        meta = model.init_params(torch.Generator(), "meta")
        paths = [path for path, _ in flatten_with_paths(meta)]
        H, KV = cfg.n_heads, cfg.kv_heads
        heads_ok = H % n == 0
        kv_ok = heads_ok and KV % n == 0
        if any(_QO.search(p) for p in paths) and heads_ok and not kv_ok \
                and n % KV:
            raise NotImplementedError(
                f"{cfg.name}: {KV} KV heads neither divide nor are divided "
                f"by {n} ranks; a rank's query heads would read "
                f"parts of two KV heads")
        time_ok = cfg.family == "rwkv" and rwkv_dims(cfg)[0] % n == 0
        ssm_ok = (cfg.family in ("ssm", "hybrid")
                  and ssm_dims(cfg)[1] % n == 0)
        rule = param_shardings(meta, mesh, mode="tp", strict=strict)

        def execution(path, spec):
            whole = ((_QO.search(path) and not heads_ok)
                     or (_KV.search(path) and not kv_ok)
                     or (_TIME.search(path) and not time_ok)
                     or (_SSM.search(path) and not ssm_ok)
                     or _CHAN_R.search(path))
            if n > 1 and whole and TP in spec:
                return P()
            if n > 1 and time_ok and _W_BIAS.search(path):
                return P(*([None] * (len(spec) - 1)), TP)
            return spec

        self.specs = map_with_paths(execution, rule)
        flat = dict(flatten_with_paths(self.specs))
        self.replicated = sorted(
            path for path, spec in flatten_with_paths(rule)
            if TP in spec and TP not in flat[path])
        self.relaid = sorted(
            path for path in paths if n > 1 and (
                (time_ok and _W_BIAS.search(path))
                or (ssm_ok and _PACKED.search(path))))
        self._columns = (ssm_columns(cfg, self.index, n)
                         if ssm_ok and n > 1 else {})
        self._split = {path: n > 1 and TP in spec
                       for path, spec in flat.items()}
        self.heads = {}
        for path in paths:
            if _QO.search(path) and path.endswith("/wq/w"):
                prefix = path[:-len("/wq/w")]
                q_split = self.split(path)
                kv_split = self.split(f"{prefix}/wk/w")
                kv_range = None
                if q_split and not kv_split and KV > 1:
                    lo = self.index * KV // n
                    kv_range = (lo, lo + 1)
                self.heads[prefix] = dict(
                    n_heads=H // n if q_split else H,
                    kv_heads=KV // n if kv_split else KV,
                    kv_range=kv_range)
        if cfg.family == "rwkv":
            nh = rwkv_dims(cfg)[0]
            self.rwkv_heads = nh // n if self.split(
                "layers/time/wr/w") else nh
        if cfg.family in ("ssm", "hybrid"):
            nh = ssm_dims(cfg)[1]
            self.ssm_heads = nh // n if self.split(
                "layers/ssm/out_proj/w") else nh
        self.experts_split = self.split("layers/moe/wd")
        self.shared_split = self.split("layers/moe/shared/wd/w")
        self.embed_split = self.split("embed/e")
        self.head_split = (self.embed_split if cfg.tie_embeddings
                           else self.split("lm_head/w"))
        # the leaves each rank holds whole but reads only in part, whose
        # gradients are summed over the model axis after the backward:
        # the KV projections a split attention replicates (C13: each rank's
        # query heads read their KV heads through kv_range, or the one KV
        # head), and the B and C columns of the relaid Mamba2 in_proj and
        # conv_w (C14: whole on every rank, each rank's heads read them).
        # Replicated leaves of a region that runs whole on every rank (a
        # replicated attention, time mix or Mamba2 mixer) and chan/wr,
        # which gates the summed wv output, get their whole gradient on
        # every rank and are not summed.  None sums the whole leaf, a
        # tensor of column indices those columns of the local tensor.
        self.grad_sums = {}
        for path in self.replicated:
            if _KV.search(path) and self.split(path[:-len("wk/w")] + "wo/w"):
                self.grad_sums[path] = None
        if self._columns:
            d_inner, _, _, ns = ssm_dims(cfg)
            di = d_inner // n
            for path in self.relaid:
                if _PACKED.search(path):
                    lo = di if path.endswith("conv_w") else 2 * di
                    self.grad_sums[path] = torch.arange(lo, lo + 2 * ns)
        self.all_reduces = 0
        self.broadcasts = 0
        self.token_checks = 0
        self.comm: dict = {}

    def split(self, path: str) -> bool:
        """Whether the parameter at ``path`` is split over the ranks."""
        return self._split.get(path, False)

    def per_pass(self, *, prefill: bool) -> int:
        """The all_reduces one forward pass makes: one after every
        row-split projection it runs (the encoder's in a prefill only),
        one for a split embedding and one for split logits."""
        cfg, s = self.cfg, self.split
        if cfg.family == "rwkv":
            n = cfg.layers * (s("layers/time/wo/w") + s("layers/chan/wv/w"))
        elif cfg.family in ("ssm", "hybrid"):
            n = cfg.layers * s("layers/ssm/out_proj/w")
            if cfg.family == "hybrid":
                n += cfg.layers // cfg.attn_every * (
                    s("shared_block/attn/wo/w")
                    + s("shared_block/mlp/wd/w"))
        else:
            if cfg.family == "moe":
                # the experts' and the shared experts' partial sums
                # share one all_reduce
                mlp = s("layers/moe/wd") or s("layers/moe/shared/wd/w")
            else:
                mlp = s("layers/mlp/wd/w")
            n = cfg.layers * (s("layers/attn/wo/w") + mlp
                              + s("layers/xattn/wo/w"))
            if cfg.family == "encdec" and prefill:
                n += cfg.encoder_layers * (s("encoder/attn/wo/w")
                                           + s("encoder/mlp/wd/w"))
        return n + self.embed_split + self.head_split

    # ------------------------------------------------------- parameters
    def place(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of one whole parameter (a copy of its own
        where it is split, so the whole tensor can be freed)."""
        if self._columns and _PACKED.search(path):
            cols = self._columns["conv_w" if path.endswith("conv_w")
                                 else "in_proj"]
            return t.index_select(-1, cols.to(t.device))
        return local_copy(t, leaf_at(self.specs, path), self.mesh)

    def shard(self, params: dict) -> dict:
        """This rank's slice of every leaf of a whole parameter tree."""
        return map_with_paths(self.place, params)

    def unplace(self, path: str, parts: list) -> torch.Tensor:
        """The whole parameter at ``path`` from every model rank's slice
        (``parts`` in model-axis order): the inverse of ``place``, the
        relaid Mamba2 columns put back in the reference's layout."""
        if self._columns and _PACKED.search(path):
            key = "conv_w" if path.endswith("conv_w") else "in_proj"
            d_inner, nh, _, ns = ssm_dims(self.cfg)
            width = d_inner + 2 * ns + (d_inner + nh) * (key == "in_proj")
            whole = parts[0].new_empty(parts[0].shape[:-1] + (width,))
            for m, part in enumerate(parts):
                cols = ssm_columns(self.cfg, m, self.size)[key]
                whole[..., cols.to(part.device)] = part
            return whole
        spec = leaf_at(self.specs, path)
        dims = [i for i, entry in enumerate(spec) if entry == TP]
        return torch.cat(parts, dims[0]) if dims else parts[0]

    # ------------------------------------------------------ collectives
    def reduce_in_place(self, t: torch.Tensor, kind: str) -> None:
        """``t`` summed over the model axis, in place, counted in
        ``comm[kind]``."""
        all_reduce_timed(t, self.group, self.comm, kind)

    def all_reduce(self, x: torch.Tensor,
                   kind: str = "tp_sum") -> torch.Tensor:
        """Sum ``x`` over the model axis: in place, or, where ``x``
        needs a gradient, into a copy whose gradient passes back
        unchanged.  On a trace's meta tensor (a capture, a program
        analysis) the call is counted in ``comm`` and not run
        (``all_reduce_timed``); ``all_reduces`` counts the calls that
        ran."""
        self.all_reduces += x.device.type != "meta"
        if torch.is_grad_enabled() and x.requires_grad:
            return _SumOverModel.apply(x, self, kind)
        x = x.contiguous()
        self.reduce_in_place(x, kind)
        return x

    def reduce(self, x: torch.Tensor, path: str) -> torch.Tensor:
        """``x``, the output of the projection at ``path``, summed over
        the ranks when that projection is split by rows (a partial sum
        on each), else as it is."""
        return self.all_reduce(x) if self.split(path) else x

    def enter(self, x: torch.Tensor, path: str) -> torch.Tensor:
        """``x`` as it enters the region that the projection at ``path``
        closes: where that region is split over the ranks and ``x`` needs
        a gradient, the identity whose backward sums the gradient over
        the model axis; else ``x`` itself."""
        if self.split(path) and torch.is_grad_enabled() and x.requires_grad:
            return _EnterSplit.apply(x, self)
        return x

    def columns_in_zeros(self, local: torch.Tensor, width: int):
        """(a zero tensor ``width`` wide holding ``local`` at this rank's
        columns, the first of them)."""
        full = local.new_zeros(local.shape[:-1] + (width,))
        lo = self.index * local.shape[-1]
        full[..., lo:lo + local.shape[-1]] = local
        return full, lo

    def gather_columns(self, local: torch.Tensor, width: int) -> torch.Tensor:
        """The ranks' column blocks (the vocab-parallel logits) gathered
        into ``width`` columns on every rank, exactly."""
        if torch.is_grad_enabled() and local.requires_grad:
            self.all_reduces += local.device.type != "meta"
            return _GatherColumns.apply(local, self, width)
        return self.all_reduce(self.columns_in_zeros(local, width)[0],
                               "logits_gather")

    def sum_grad(self, path: str, g: torch.Tensor) -> torch.Tensor:
        """The gradient ``g`` of the leaf at ``path`` with ``grad_sums``'
        sum over the model axis applied (in place where it is one)."""
        if path not in self.grad_sums:
            return g
        cols = self.grad_sums[path]
        if cols is None:
            g = g.contiguous()
            self.reduce_in_place(g, "tp_grad_sum")
            return g
        cols = cols.to(g.device)
        part = g.index_select(-1, cols)
        self.reduce_in_place(part, "tp_grad_sum")
        return g.index_copy(-1, cols, part)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the model axis's first rank holds it, in place on
        every rank of the axis."""
        dist.broadcast(x, src=self.mesh.rank - self.index, group=self.group)
        self.broadcasts += 1
        return x

    def tokens_agree(self, tokens: torch.Tensor) -> torch.Tensor:
        """A device bool: whether every rank of the world holds these
        tokens (one all_reduce of (tokens, -tokens) by max)."""
        both = torch.cat([tokens, -tokens]).to(torch.int64)
        dist.all_reduce(both, op=dist.ReduceOp.MAX)
        self.token_checks += 1
        n = tokens.numel()
        return torch.all(both[:n] == -both[n:])


def tp_sum(tp: TensorParallel | None, parts) -> torch.Tensor:
    """The sum of ``parts``, (tensor, split) pairs.  Without TP, in their
    order; on a TP rank, the split parts (partial sums over the rank's
    share) add up and are all-reduced in one collective, and the
    replicated parts are added after it."""
    if tp is None:
        y = parts[0][0]
        for t, _ in parts[1:]:
            y = y + t
        return y
    y = None
    for t, split in parts:
        if split:
            y = t if y is None else y + t
    if y is not None:
        y = tp.all_reduce(y)
    for t, split in parts:
        if not split:
            y = t if y is None else y + t
    return y
