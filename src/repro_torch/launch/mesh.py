"""Mesh construction over ``torch.distributed`` (the counterpart of the
reference's ``launch/mesh.py``).

A mesh here is a description, not a device array: its axis names and
sizes, and, on a rank of an initialised process group, the rank's
coordinates and the process groups of its "model" axis (the ranks that
differ only in their model coordinate), which tensor parallelism sums
over, and of its "data" axis (the ranks that differ only in their data
coordinate), which FSDP gathers over and data parallelism averages
over.  Ranks lie on the mesh data-major, as ``jax.make_mesh``
lays devices out: rank r of a (data, model) mesh sits at (r // model,
r % model).

The backend is the caller's: ``nccl`` needs one card per rank (it refuses
two ranks on one card); ``gloo`` runs ranks that share a card, and ranks
on the CPU, and its all-reduce of CUDA tensors is staged through the
host.  Nothing here switches backend.

``run_ranks`` starts the ranks of a world as spawned processes joined in
one gloo process group, for the smoke scripts and the tests.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..models.parallel import all_reduce_timed
from ..sharding.rules import DP

BACKENDS = ("gloo", "nccl")


class _DataMean(torch.autograd.Function):
    """The mean over the data axis of a statistic of each rank's rows; the
    identity backward: every data rank computes the same function of the
    mean, so the mean's gradient is the same on every rank, each rank's
    rows take 1 / ranks of it, and the train step's mean of the ranks'
    parameter gradients restores the factor."""

    @staticmethod
    def forward(ctx, x, mesh, comm):
        y = x.clone(memory_format=torch.contiguous_format)
        all_reduce_timed(y, mesh.data_group, comm, "data_stats")
        return y / mesh.data_ranks

    @staticmethod
    def backward(ctx, g):
        return g, None, None


@dataclasses.dataclass
class HostMesh:
    """A mesh's axes and sizes (``shape``, in ``axis_names`` order, as a
    jax Mesh has them); on a rank, its coordinates (``coords``) and the
    process groups of its model axis (``model_group``) and of its data
    axis (``data_group``)."""

    shape: dict[str, int]
    axis_names: tuple[str, ...]
    rank: int | None = None
    coords: dict[str, int] | None = None
    model_group: object = dataclasses.field(default=None, repr=False)
    data_group: object = dataclasses.field(default=None, repr=False)

    @property
    def data_ranks(self) -> int:
        """The ranks of the data axes (the rules' ``DP``: "pod" and
        "data"), which FSDP splits over and the data mean averages over."""
        return math.prod(self.shape.get(a, 1) for a in DP)

    @property
    def data_index(self) -> int:
        """This rank's index over the data axes (the first the most
        significant, as the rules lay blocks out); 0 without
        coordinates."""
        if self.coords is None:
            return 0
        i = 0
        for a in DP:
            if a in self.shape:
                i = i * self.shape[a] + self.coords[a]
        return i

    @property
    def devices(self) -> np.ndarray:
        """The ranks laid out on the mesh (a jax Mesh's device array)."""
        return np.arange(math.prod(self.shape.values())).reshape(
            tuple(self.shape.values()))

    def data_mean(self, x: torch.Tensor, comm=None) -> torch.Tensor:
        """The mean of ``x`` over the data ranks (``x`` itself on a mesh
        with one), differentiable (``_DataMean``; ``comm`` counts the
        all_reduce, which a trace's meta tensor records without running):
        the MoE loss's token statistics over a sharded loss's global
        batch."""
        if self.data_ranks == 1:
            return x
        return _DataMean.apply(x, self, comm)

    def barrier(self) -> None:
        """Wait for every rank of the world."""
        dist.barrier()


def group_mesh(group=None) -> HostMesh:
    """A replicated data-parallel ``group`` (the default group when None)
    as a mesh whose data axis is the group's ranks and whose model axis
    is 1: ``data_mean`` then averages over the group."""
    n = dist.get_world_size(group)
    return HostMesh(shape={"data": n, "model": 1},
                    axis_names=("data", "model"), rank=dist.get_rank(),
                    coords={"data": dist.get_rank(group), "model": 0},
                    data_group=group)


def make_production_mesh(*, multi_pod: bool = False) -> HostMesh:
    """16x16 single pod (256 chips) or 2x16x16 two-pod (512 chips): the
    description only, with no process group (for the rules)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return HostMesh(shape=dict(zip(axes, shape)), axis_names=axes)


def make_host_mesh(*, data: int | None = None, model: int = 1,
                   backend: str | None = None) -> HostMesh:
    """The ("data", "model") mesh of the initialised process group's
    ranks, with this rank's coordinates and its model and data axes'
    groups.

    ``data`` defaults to whatever the ranks fill (world // model).
    ``backend`` is that of the model groups; None takes the default
    group's, as the caller initialised it.  ``nccl`` with fewer visible
    cards than ranks raises (NCCL refuses two ranks on one card; ranks
    that share a card run ``gloo``), as does a mesh that does not tile
    the world or needs more ranks than it has."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_host_mesh runs over an initialised process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "world_size=..., rank=...) first")
    backend = backend or dist.get_backend()
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    n = dist.get_world_size()
    cards = torch.cuda.device_count()
    if backend == "nccl" and cards < n:
        raise ValueError(
            f"nccl needs one card per rank: {n} rank(s) but {cards} "
            f"card(s) visible; ranks that share a card run backend='gloo'")
    if data is None:
        if n % model:
            raise ValueError(
                f"make_host_mesh(model={model}) cannot tile {n} rank(s) "
                f"evenly; start a multiple of {model} ranks")
        data = n // model
    need = data * model
    if need > n:
        raise ValueError(
            f"host mesh ({data} data x {model} model) needs {need} ranks "
            f"but only {n} exist")
    if need != n:
        raise ValueError(
            f"host mesh ({data} data x {model} model) does not tile the "
            f"{n} ranks of the world")
    rank = dist.get_rank()
    coords = {"data": rank // model, "model": rank % model}
    # every rank creates every model group (a row of the mesh), then
    # every data group (a column), in one order (new_group is
    # collective), and keeps its own
    grid = np.arange(n).reshape(data, model)
    own = {}
    for axis, lines in (("model", grid), ("data", grid.T)):
        for line in lines:
            group = dist.new_group([int(r) for r in line], backend=backend)
            if rank in line:
                own[axis] = group
    return HostMesh(shape={"data": data, "model": model},
                    axis_names=("data", "model"), rank=rank, coords=coords,
                    model_group=own["model"], data_group=own["data"])


def _rank_main(rank: int, fn, world: int, rendezvous: str, timeout_s: float,
               args: tuple) -> None:
    dist.init_process_group(
        "gloo", init_method=f"file://{rendezvous}/init", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(rendezvous, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout_s: float = 900.0) -> list:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes joined in one
    gloo process group (ranks that share a card, or run on the CPU; a
    ``file://`` rendezvous in a fresh temporary directory, so concurrent
    worlds never share a port) and
    return each rank's result in rank order.  ``fn`` and ``args`` must
    pickle (``fn`` by its module path).  A rank that raises ends the
    others and raises here with its traceback; a collective that waits
    ``timeout_s`` raises in its rank."""
    from torch import multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="ranks_") as rendezvous:
        mp.start_processes(_rank_main, args=(fn, world, rendezvous,
                                             timeout_s, args),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(rendezvous, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
