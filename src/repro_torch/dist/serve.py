"""Serve a TP-sharded model over ``torch.distributed`` (the counterpart
of the reference's ``dist/serve.py``).

The deployment-side half of the dist subsystem: ``shard_engine`` puts an
existing ``serving.Engine`` on a ("data", "model") mesh of the
initialised process group's ranks.  Where the reference places the
parameters under the strict rule table and lets GSPMD lower each
program with collectives, the port keeps this rank's slice of every
parameter (``sharding.rules``) and installs an explicit Megatron layout
on the model (``models.parallel.TensorParallel``): each rank runs its
heads, its share of d_ff and its experts, and sums partial outputs with
``all_reduce``s over the model axis.  Every rank of a data group runs
the engine's whole batch, as the reference's engine, which places no
batch sharding, does.

Token identity: greedy decoding of the sharded engine is held
token-identical to one device's (``dist.serve_smoke``).  The all-reduces
reassociate the contraction sums, so float logits differ in ulps.

Runs every family.  Where a rule's split cannot run as it is (a cut
inside a head, packed Mamba2 columns, the RWKV channel mix's gate), the
layout replicates or lays out the tensor otherwise (``TensorParallel``'s
``replicated`` and ``relaid``; ROADMAP C13, C14).  A sharded engine also
runs behind the continuous scheduler and the replica router, whose
rank 0 decides every tick (``serving.sched.scheduler``,
``serving.router.tp``).  ``mode="fsdp"`` adds the reference's FSDP
placement over the mesh's data axis (``dist.fsdp``): each rank also keeps
only its data block of every large leaf, and every pass gathers each
layer's leaves as it runs them.

Imports the serving stack's layers: not re-exported from
``repro_torch.dist``, as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch.distributed as dist

from ..launch.mesh import make_host_mesh
from ..models.parallel import TensorParallel
from ..obs.registry import get_registry
from .fsdp import FullyShardedData

MODES = ("tp", "fsdp")

_REG = get_registry()


def shard_model(model, mesh, *, mode: str = "tp", strict: bool = True):
    """A copy of ``model`` that runs this rank's share of the TP layout on
    ``mesh`` (with ``mode="fsdp"`` also the FSDP layout over its data
    axis, as ``sharding.rules.param_shardings`` names the modes); its
    ``init_params`` makes the rank's slices (the original model is left
    as it is)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    sharded = dataclasses.replace(model, tp=TensorParallel(model, mesh,
                                                           strict=strict))
    if mode == "fsdp":
        sharded.fsdp = FullyShardedData(sharded, strict=strict)
    return sharded


def shard_engine(engine, *, model_axis: int, data_axis: int = 1,
                 mode: str = "tp", strict: bool = True):
    """Put ``engine`` on a (data_axis, model_axis) mesh of the process
    group's ranks (its backend, as the caller initialised it): its model
    becomes a sharded copy (``shard_model``: "tp", or "fsdp" with the data
    axis's split too) and its parameters this rank's slices; returns the
    mesh.  Every rank runs the engine's whole batch.  ``strict=True``
    (default) uses the strict rule table: an unmatched parameter path
    raises instead of replicating."""
    if mode not in MODES:
        raise ValueError(f"shard_engine(mode={mode!r}): not one of {MODES}")
    mesh = make_host_mesh(data=data_axis, model=model_axis)
    engine.model = shard_model(engine.model, mesh, mode=mode, strict=strict)
    engine.params = engine.model.tp.shard(engine.params)
    if engine.model.fsdp is not None:
        engine.params = engine.model.fsdp.shard(engine.params)
    _REG.inc("dist.engines_sharded")
    return mesh


def devices_available(n: int) -> bool:
    """True when the process group has at least ``n`` ranks (mesh smoke
    gate)."""
    return dist.is_initialized() and dist.get_world_size() >= n
