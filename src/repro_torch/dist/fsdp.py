"""Fully sharded data parallelism over a mesh's "data" axis, on top of the
tensor-parallel layout of its "model" axis (the port's own module: the
reference gets the same from GSPMD).

The reference places every parameter and its optimizer state under
``param_shardings(mode="fsdp")``: the Megatron TP split over "model",
and one more free dim of every large leaf split over the data axes
(``sharding.rules.apply_fsdp``: the first free dim that divides, often
the stacked layer axis).  XLA then gathers each layer's parameters as
its program reaches them and reduce-scatters their gradients.  The port
does the same by hand:

- ``FullyShardedData`` (on ``Model.fsdp``) records, for every leaf of
  the TP execution layout (``models.parallel.TensorParallel``), the dim
  its data split takes (``dims``) and gathers a leaf where a forward
  pass uses it (``gather``, ``gather_layer``): an all-gather over the
  data group, written as each rank's block in zeros and one
  ``all_reduce`` (gloo runs ``all_reduce`` and ``broadcast`` on CUDA
  tensors).  Its backward is the reduce-scatter with the mean over the
  data ranks: the fp32 sum of ``exact_mean``, this rank's block, over
  the ranks.  Where the layer axis is split, layer i comes from the
  rank that holds it and the others contribute zeros.  The model
  gathers each layer inside its rematerialized body, so the backward's
  recompute gathers it again and a layer's whole parameters live only
  while it runs.
- ``ShardedLayout`` is what a sharded training run needs besides: each
  leaf's placement from the whole tensor (``place``) and back
  (``whole``), the gradient reductions after the backward
  (``reduce_grads``), the global norm that counts every element once
  (``global_norm``) and the checkpoint's assembly and placement.

Collectives are counted by kind in the layout's ``comm`` (calls, bytes,
host seconds): "fsdp_gather", "reduce_scatter", the data mean of the
leaves FSDP leaves whole ("data_mean"), and the TP kinds of
``TensorParallel``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..models.parallel import all_reduce_timed
from ..sharding.rules import (DP, TP, P, _axes, assemble,
                              flatten_with_paths, leaf_at, map_with_paths,
                              param_shardings)


def _data_dim(spec) -> int | None:
    for i, entry in enumerate(spec):
        if any(a in DP for a in _axes(entry)):
            return i
    return None


class _Gather(torch.autograd.Function):
    """The all-gather of one leaf over the data group; the backward is its
    reduce-scatter with the mean over the data ranks."""

    @staticmethod
    def forward(ctx, local, fsdp, shape, dim, owned):
        ctx.fsdp, ctx.dim, ctx.owned, ctx.dtype = fsdp, dim, owned, \
            local.dtype
        return fsdp.gather_in_zeros(local, shape, dim, owned)

    @staticmethod
    def backward(ctx, g):
        return (ctx.fsdp.reduce_scatter(g, ctx.dim, ctx.owned, ctx.dtype),
                None, None, None, None)


class FullyShardedData:
    """The FSDP layout of a tensor-parallel ``model`` (``model.tp``) on its
    mesh, for this rank: ``dims`` (path -> the dim of the TP-local leaf
    split over the data axis, or None where the rule keeps it whole),
    ``shapes`` (the TP-local shapes), ``specs`` (the execution spec with
    the data entry added), and the data group's collectives, counted in
    ``comm`` (the TP layout's)."""

    def __init__(self, model, *, strict: bool = True):
        tp = model.tp
        mesh = tp.mesh
        self.mesh = mesh
        self.size = mesh.data_ranks
        self.index = mesh.data_index
        self.group = mesh.data_group
        self.comm = tp.comm
        gen = torch.Generator()
        whole = dataclasses.replace(model, tp=None, fsdp=None).init_params(
            gen, "meta")
        local = dict(flatten_with_paths(
            dataclasses.replace(model, fsdp=None).init_params(gen, "meta")))
        rule = dict(flatten_with_paths(param_shardings(
            whole, mesh, mode="fsdp", strict=strict)))
        execution = dict(flatten_with_paths(tp.specs))
        self.dims, self.shapes, specs = {}, {}, {}
        for path, t in local.items():
            dim = _data_dim(rule[path])
            if dim is not None and t.shape[dim] % self.size:
                raise NotImplementedError(
                    f"{path}: the data split of dim {dim} ({rule[path]}) "
                    f"does not divide this rank's {tuple(t.shape)} into "
                    f"{self.size}")
            self.dims[path] = dim
            self.shapes[path] = tuple(t.shape)
            entries = list(execution[path]) + [None] * (
                t.ndim - len(execution[path]))
            if dim is not None:
                entries[dim] = "data"
            specs[path] = P(*entries)
        self.specs = map_with_paths(lambda path, _: specs[path], whole)

    def split(self, path: str) -> bool:
        """Whether the leaf at ``path`` is split over the data axis."""
        return self.dims.get(path) is not None

    # ------------------------------------------------------- placement
    def place(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's data block of ``t``, the TP-local leaf at ``path``
        (a copy of its own where it is split)."""
        dim = self.dims[path]
        if dim is None:
            return t
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n).clone(
            memory_format=torch.contiguous_format)

    def shard(self, params: dict) -> dict:
        """This rank's data block of every leaf of a TP-local tree."""
        return map_with_paths(self.place, params)

    # ----------------------------------------------------- collectives
    def gather_in_zeros(self, local: torch.Tensor, shape: tuple, dim,
                        owned: bool) -> torch.Tensor:
        """The whole ``shape`` from the data ranks' blocks on ``dim`` (or,
        with ``dim`` None, from the one rank that ``owned`` says holds
        it), each written into zeros and summed by one all_reduce; a
        trace's meta tensor gets an empty one of the whole shape, its
        all_reduce counted and not run (``all_reduce_timed``)."""
        if local.device.type == "meta":
            full = local.new_empty(shape)
            all_reduce_timed(full, self.group, self.comm, "fsdp_gather")
            return full
        full = local.new_zeros(shape)
        if dim is None:
            if owned:
                full.copy_(local)
        else:
            n = shape[dim] // self.size
            full.narrow(dim, self.index * n, n).copy_(local)
        all_reduce_timed(full, self.group, self.comm, "fsdp_gather")
        return full

    def reduce_scatter(self, g: torch.Tensor, dim, owned: bool, dtype):
        """This rank's block of the mean of the whole gradient ``g`` over
        the data ranks (``exact_mean``'s arithmetic: an fp32 sum, then /
        ranks); None where this rank holds none of it."""
        s = g.to(torch.float32).clone(memory_format=torch.contiguous_format)
        all_reduce_timed(s, self.group, self.comm, "reduce_scatter")
        if dim is None:
            return (s / self.size).to(dtype) if owned else None
        n = s.shape[dim] // self.size
        return (s.narrow(dim, self.index * n, n) / self.size).to(dtype)

    def _apply(self, local, shape, dim, owned):
        if torch.is_grad_enabled() and local.requires_grad:
            return _Gather.apply(local, self, shape, dim, owned)
        return self.gather_in_zeros(local, shape, dim, owned)

    def gather(self, path: str, local: torch.Tensor) -> torch.Tensor:
        """The whole TP-local leaf at ``path`` from this rank's block (the
        block itself where the leaf is not split over data)."""
        dim = self.dims[path]
        if dim is None:
            return local
        return self._apply(local, self.shapes[path], dim, True)

    def gather_tree(self, prefix: str, tree: dict) -> dict:
        """``gather`` over every leaf of the subtree at ``prefix``."""
        return map_with_paths(self.gather, tree, prefix=f"{prefix}/")

    def layer_parts(self, prefix: str, stack: dict) -> list[dict]:
        """Every layer's share of the stacked subtree at ``prefix``, for
        ``gather_layer``: each leaf unbound once on the layer axis
        (views), except where the layer axis is split over data: there a
        layer's part is the owner's view and, on the other ranks, the
        local stack itself (its backward gives it nothing, but keeps the
        gather's reduce-scatter on every rank's graph)."""
        n = None
        parts = {}
        for path, t in flatten_with_paths(stack, f"{prefix}/"):
            n = self.shapes[path][0]
            if self.dims[path] == 0:
                held = t.shape[0]
                lo = self.index * held
                views = t.unbind(0)
                parts[path] = [views[i - lo] if lo <= i < lo + held else t
                               for i in range(n)]
            else:
                parts[path] = t.unbind(0)
        return [map_with_paths(lambda path, _, i=i: parts[path][i], stack,
                               prefix=f"{prefix}/") for i in range(n)]

    def gather_layer(self, prefix: str, parts: dict, i: int) -> dict:
        """Layer ``i``'s whole TP-local parameters from its parts
        (``layer_parts``); the leaves FSDP keeps whole pass as they are."""
        def one(path, part):
            dim = self.dims[path]
            if dim is None:
                return part
            shape = self.shapes[path][1:]
            if dim == 0:
                held = self.shapes[path][0] // self.size
                return self._apply(part, shape, None,
                                   i // held == self.index)
            return self._apply(part, shape, dim - 1, True)
        return map_with_paths(one, parts, prefix=f"{prefix}/")


def _sorted_items(tree, prefix: str = "") -> list[tuple]:
    """(path, leaf) of a nested dict's leaves in ``tree_leaves`` order
    (sorted keys), the paths '/'-joined."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _sorted_items(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


class ShardedLayout:
    """A sharded model's whole layout for training: ``model.tp`` over the
    mesh's model axis and, when installed, ``model.fsdp`` over its data
    axis (the data ranks otherwise each hold every TP-local leaf
    whole)."""

    def __init__(self, model):
        self.tp = model.tp
        self.fsdp = model.fsdp
        self.mesh = self.tp.mesh
        self.rank = self.mesh.rank
        self.data = self.mesh.data_ranks
        self.data_group = self.mesh.data_group
        self.comm = self.tp.comm
        self.paths = {p for p, _ in flatten_with_paths(self.tp.specs)}

    def _data_split(self, path: str) -> bool:
        return self.fsdp is not None and self.fsdp.split(path)

    # ------------------------------------------------------- placement
    def place(self, path: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole leaf at ``path``."""
        local = self.tp.place(path, whole)
        return local if self.fsdp is None else self.fsdp.place(path, local)

    def shard(self, tree: dict) -> dict:
        """This rank's slice of every leaf of a whole parameter tree."""
        return map_with_paths(self.place, tree)

    def whole(self, path: str, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf at ``path`` on every rank, from the ranks'
        slices: each distinct block broadcast bit for bit from the first
        rank that holds it, then ``sharding.rules.assemble`` under the
        execution spec, the relaid columns undone
        (``TensorParallel.unplace``).  Every rank calls it, in one
        order."""
        D, M = self.data, self.tp.size
        spec = leaf_at(self.fsdp.specs if self.fsdp is not None
                       else self.tp.specs, path)
        local = local.contiguous()
        blocks = {}
        for d in range(D if self._data_split(path) else 1):
            for m in range(M if self.tp.split(path) else 1):
                owner = d * M + m
                buf = (local.clone() if owner == self.rank
                       else torch.empty_like(local))
                dist.broadcast(buf, src=owner)
                blocks[d, m] = buf
        if path not in self.tp.grad_sums or self.tp.grad_sums[path] is None:
            return assemble(blocks, spec, self.mesh)
        # the relaid Mamba2 columns: each model rank's tensor over the
        # data axis, then the columns put back
        data_only = P(*(None if e == TP else e for e in spec))
        return self.tp.unplace(path, [
            assemble({k: v for k, v in blocks.items() if k[1] == m},
                     data_only, self.mesh) for m in range(M)])

    # -------------------------------------------------------- gradients
    def reduce_grads(self, grads: dict) -> dict:
        """The gradients an update takes, in ``tree_leaves`` order on every
        rank: each leaf's ``TensorParallel.sum_grad`` over the model axis,
        then, for a leaf not split over data (whose gather would have
        reduced it), the exact mean over the data group."""
        stats = self.comm.setdefault("data_mean", {"calls": 0, "bytes": 0,
                                                   "seconds": 0.0})
        from ..training.grad_compression import exact_mean

        def one(path, g):
            g = self.tp.sum_grad(path, g)
            if self.data > 1 and not self._data_split(path):
                g = exact_mean(g, self.data_group, stats=stats)
            return g
        return _map_sorted(one, grads)

    def mean_over_data(self, x: torch.Tensor) -> torch.Tensor:
        from ..training.grad_compression import exact_mean
        return exact_mean(x, self.data_group) if self.data > 1 else x

    def global_norm(self, grads: dict) -> torch.Tensor:
        """The global norm of the whole gradients, each element counted
        once: every leaf's sum of squares over this rank's slice, from
        one rank of each set of ranks that hold the same slice (the
        others add zero), summed over the world by one all_reduce, so
        that every rank gets the same norm bit for bit.  The relaid
        Mamba2 B and C columns, whole on every model rank, count once.
        One rank's ``global_norm`` sums each leaf in one pass; here the
        slices' sums add up in another order, so the two agree within
        ulps, not bitwise."""
        coords = self.mesh.coords
        sq = lambda t: torch.sum(torch.square(t.to(torch.float32)))
        parts, count = [], []
        for path, g in _sorted_items(grads):
            first_data = self._data_split(path) or self.mesh.data_index == 0
            shared = self.tp.grad_sums.get(path)
            if shared is not None:
                # the other columns, as indices made on the host (a mask
                # would index by nonzero, which a meta tensor cannot run)
                keep = torch.ones(g.shape[-1], dtype=torch.bool)
                keep[shared] = False
                rest = keep.nonzero()[:, 0].to(g.device)
                shared = shared.to(g.device)
                split, whole = (sq(g.index_select(-1, rest)),
                                sq(g.index_select(-1, shared)))
                parts += [split * first_data,
                          whole * (first_data and coords["model"] == 0)]
                count.append(2)
                continue
            mine = first_data and (self.tp.split(path)
                                   or coords["model"] == 0)
            parts.append(sq(g) * mine)
            count.append(1)
        v = torch.stack(parts)
        all_reduce_timed(v, None, self.comm, "grad_norm")
        leaves, i = [], 0
        for c in count:
            leaves.append(v[i] if c == 1 else v[i] + v[i + 1])
            i += c
        return torch.sqrt(torch.sum(torch.stack(leaves)))

    # ------------------------------------------------------- checkpoint
    def param_path(self, ckpt_path: str) -> str | None:
        """The parameter path a checkpoint leaf's path ends with (its
        moments' too), or None for a leaf of no parameter (the step)."""
        keys = ckpt_path.split("/")
        for k in range(len(keys)):
            path = "/".join(keys[k:])
            if path in self.paths:
                return path
        return None

    def unshard(self, ckpt_path: str, leaf):
        """The whole checkpoint leaf on the host at rank 0, None on the
        other ranks (every rank calls it, in one order)."""
        path = self.param_path(ckpt_path)
        if path is not None:
            leaf = self.whole(path, leaf)
        if self.rank != 0:
            return None
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().to("cpu", copy=True).numpy()
        return np.array(leaf)

    def placement(self, ckpt_path: str):
        """How restore makes this rank's leaf from the whole one."""
        path = self.param_path(ckpt_path)
        return None if path is None else (
            lambda whole: self.place(path, whole))

    def barrier(self) -> None:
        dist.barrier()


def _map_sorted(fn, tree: dict, prefix: str = "") -> dict:
    """fn(path, leaf) over a nested dict, visiting the leaves in
    ``tree_leaves`` order (sorted keys), so that the collectives inside
    ``fn`` come in one order on every rank."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out[k] = (_map_sorted(fn, v, f"{prefix}{k}/") if isinstance(v, dict)
                  else fn(f"{prefix}{k}", v))
    return {k: out[k] for k in tree}


__all__ = ["FullyShardedData", "ShardedLayout"]
