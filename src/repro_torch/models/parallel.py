"""Explicit Megatron tensor parallelism of the dense and MoE families
over a mesh's "model" axis.

The reference places its parameters under the rule table
(``sharding.rules``) and lets GSPMD lower every program with
collectives.  The port runs the same split by hand: each rank holds the
local slice of every split parameter, runs its share of the heads, of
d_ff, of the experts and of the vocabulary, and sums the partial
results with one ``all_reduce`` after the attention's ``wo``, one after
the MLP's ``wd`` (or the MoE's partial sum), one after a vocab-parallel
embedding lookup (a masked local lookup) and one to gather the
vocab-parallel logits (written into a zero-filled full-width buffer:
an exact gather with the only collective besides ``broadcast`` that
gloo runs on CUDA tensors).

Where the rule splits a tensor inside an attention head (``attn/wk/w``
with fewer KV heads than ranks; ``attn/wq/w``, ``attn/wo/w`` with a head
count that the ranks do not divide), explicit TP cannot run the split,
and the layout replicates that tensor instead (``replicated``; ROADMAP
C13).  With KV heads replicated, each rank's query heads read the one KV
head they share (``kv_range``).
"""
from __future__ import annotations

import re

import torch
import torch.distributed as dist

from ..sharding.rules import (TP, P, flatten_with_paths, leaf_at,
                              local_copy, map_with_paths, param_shardings)

_QO = re.compile(r"(^|/)attn/w[qo]/w$")
_KV = re.compile(r"(^|/)attn/w[kv]/w$")
FAMILIES = ("dense", "moe")


class TensorParallel:
    """A model's tensor-parallel layout on ``mesh`` (``launch.mesh``),
    for this rank: the execution spec of every parameter (``specs``), the
    parameters whose rule spec it replicates (``replicated``), which
    blocks are split, the local head counts, and the collectives, each
    counted (``all_reduces``, ``token_checks``)."""

    def __init__(self, model, mesh, *, strict: bool = True):
        cfg = model.cfg
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: tensor-parallel serving runs the dense and MoE "
                f"families; the {cfg.family!r} family's rules split packed "
                f"columns that explicit TP cannot use as they are (ROADMAP "
                f"A13, its remainder)")
        self.mesh = mesh
        self.size = mesh.shape.get(TP, 1)
        self.index = mesh.coords[TP] if mesh.coords is not None else 0
        self.group = mesh.model_group
        H, KV = cfg.n_heads, cfg.kv_heads
        heads_ok = H % self.size == 0
        kv_ok = heads_ok and KV % self.size == 0
        if heads_ok and not kv_ok and self.size % KV:
            raise NotImplementedError(
                f"{cfg.name}: {KV} KV heads neither divide nor are divided "
                f"by {self.size} ranks; a rank's query heads would read "
                f"parts of two KV heads")
        rule = param_shardings(model.init_params(torch.Generator(), "meta"),
                               mesh, mode="tp", strict=strict)

        def execution(path, spec):
            if TP in spec and ((_QO.search(path) and not heads_ok)
                               or (_KV.search(path) and not kv_ok)):
                return P()
            return spec

        self.specs = map_with_paths(execution, rule)
        self.replicated = sorted(
            path for path, spec in flatten_with_paths(rule)
            if leaf_at(self.specs, path) != spec)

        def split(path):
            spec = leaf_at(self.specs, path)
            return spec is not None and TP in spec

        self.attn_split = split("layers/attn/wq/w")
        self.kv_split = split("layers/attn/wk/w")
        self.mlp_split = split("layers/mlp/wd/w")
        self.experts_split = split("layers/moe/wd")
        self.shared_split = split("layers/moe/shared/wd/w")
        self.embed_split = split("embed/e")
        self.head_split = (self.embed_split if cfg.tie_embeddings
                           else split("lm_head/w"))
        self.n_heads = H // self.size if self.attn_split else H
        self.kv_heads = KV // self.size if self.kv_split else KV
        self.kv_range = None
        if self.attn_split and not self.kv_split and KV > 1:
            lo = self.index * KV // self.size
            self.kv_range = (lo, lo + 1)
        self.all_reduces = 0
        self.token_checks = 0

    # ------------------------------------------------------- parameters
    def place(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of one whole parameter (a copy of its own
        where it is split, so the whole tensor can be freed)."""
        return local_copy(t, leaf_at(self.specs, path), self.mesh)

    def shard(self, params: dict) -> dict:
        """This rank's slice of every leaf of a whole parameter tree."""
        return map_with_paths(self.place, params)

    # ------------------------------------------------------ collectives
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the model axis, in place; a trace's meta tensor
        (capture) passes through, since it has no values to sum."""
        if x.device.type == "meta":
            return x
        x = x.contiguous()
        dist.all_reduce(x, group=self.group)
        self.all_reduces += 1
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
