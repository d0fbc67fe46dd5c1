"""The training step: loss -> grad -> clip -> AdamW (the counterpart of
the reference's ``training/train_step.py``).

``make_train_step`` is the reference's function: microbatch gradients
accumulate in fp32 zeros, in microbatch order, times 1/microbatches.
``jit_train_step`` is the step a run takes (the counterpart of the
reference's pjit-wrapped step): it updates the parameters and the
moments in place, as the reference donates them.  Over a data-parallel
``torch.distributed`` group of replicas it reduces the gradients before
the update, by the exact fp32 mean or by the int8 error-feedback
all-reduce (``grad_compression``), and reports the mean loss over the
ranks.  On a sharded model (``dist.serve.shard_model``: TP over the
mesh's model axis, FSDP over its data axis) every rank updates its own
slices: a data-split leaf's gradient comes out of the FSDP gather's
backward already reduced, the others take the exact mean over the data
group, and the leaves each rank reads only in part are summed over the
model axis (``dist.fsdp.ShardedLayout``).

Under a tracer (``obs.tracing``) a step is one ``train.step`` span
holding ``train.forward`` and ``train.backward`` for each microbatch,
``train.reduce`` around a data-parallel or sharded reduction, and
``train.optimizer`` around the update.  Spans that a rematerialized
layer opens in the backward, on autograd's device thread too, parent
under ``train.backward``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..dist.fsdp import ShardedLayout
from ..launch.mesh import group_mesh
from ..models.model import Model
from ..obs.tracing import span as _span
from . import optimizer as opt
from .grad_compression import (comm_stats, exact_mean, init_error_buffers,
                               make_compressed_allreduce)


def _grads_of(model: Model, params, batch, *, microbatches: int,
              remat: bool, data_mean=None):
    """(loss, grads): the mean over ``microbatches`` equal splits of the
    batch's rows, each a backward of its own (peak activations of one
    microbatch).  Every leaf gets a gradient (zeros where the loss does
    not reach it, as jax.grad gives).  ``data_mean``: the mean over the
    data ranks that ``Model.loss`` takes the MoE statistics through."""
    leaves = opt.tree_leaves(params)
    live = opt.tree_map(lambda p: p.detach().requires_grad_(), params)
    live_leaves = opt.tree_leaves(live)

    def one(mbatch):
        with _span("train.forward"):
            loss = model.loss(live, mbatch, remat=remat,
                              data_mean=data_mean)
        with _span("train.backward"):
            grads = torch.autograd.grad(loss, live_leaves,
                                        allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
        return loss.detach(), grads

    if microbatches == 1:
        loss, grads = one(batch)
    else:
        B = next(iter(batch.values())).shape[0]
        mb = B // microbatches
        loss = torch.zeros((), dtype=torch.float32,
                           device=leaves[0].device)
        grads = [torch.zeros(p.shape, dtype=torch.float32,
                             device=p.device) for p in leaves]
        for i in range(microbatches):
            l_i, g_i = one({k: v[i * mb:(i + 1) * mb]
                            for k, v in batch.items()})
            loss = loss + l_i
            grads = [a + g for a, g in zip(grads, g_i)]
        inv = 1.0 / microbatches
        loss = loss * inv
        grads = [g * inv for g in grads]
    it = iter(grads)
    return loss, _unflatten(params, it)


def _unflatten(tree, it):
    """A tree like ``tree`` whose leaves come from ``it`` in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    return next(it)


def make_train_step(model: Model, cfg_opt: opt.AdamWConfig,
                    *, microbatches: int = 1, remat: bool = True):
    """Returns train_step(params, opt_state, batch) -> (p, s, metrics),
    metrics {"loss", "grad_norm", "lr"} as 0-d tensors; the parameters
    and state passed in are left as they are."""

    def train_step(params, opt_state, batch):
        loss, grads = _grads_of(model, params, batch,
                                microbatches=microbatches, remat=remat)
        params, opt_state, om = opt.apply_updates(params, grads, opt_state,
                                                  cfg_opt)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def jit_train_step(model: Model, cfg_opt: opt.AdamWConfig, group=None, *,
                   mesh=None, microbatches: int = 1, remat: bool = True,
                   compress: bool = False):
    """The step a run takes: parameters and moments updated in place.

    Over a data-parallel process group (``group``, or the default group
    when one is initialised) each rank takes its rows of the global
    batch; the gradients are reduced before the update, by the exact
    fp32 mean, or with ``compress`` by the int8 error-feedback
    all-reduce, whose error buffers the step keeps from one call to the
    next (``step.errors``; they are not checkpointed).  The loss in the
    metrics is the mean over the ranks, and the MoE load-balancing loss
    takes its token statistics over the group's global batch
    (``launch.mesh.group_mesh``'s ``data_mean``), as the sharded step
    does over its data axis.  ``step.comm`` counts the last step's
    gradient all_reduces: calls, bytes and host seconds inside them.

    A sharded model (``model.tp`` set) trains on its ``mesh``: each rank
    takes its data coordinate's rows and holds its slices of the
    parameters and moments; ``step.comm`` then counts the step's
    collectives by kind (``dist.fsdp``).  Gradient compression stays
    with replicated data parallelism, as in the reference."""
    if model.tp is not None:
        return _sharded_step(model, cfg_opt, mesh, group, compress,
                             microbatches=microbatches, remat=remat)
    data_parallel = group is not None or dist.is_initialized()
    data_mean = group_mesh(group).data_mean if data_parallel else None

    def step(params, opt_state, batch):
        with _span("train.step"):
            loss, grads = _grads_of(model, params, batch,
                                    microbatches=microbatches, remat=remat,
                                    data_mean=data_mean)
            step.comm = comm_stats()
            if data_parallel:
                with _span("train.reduce"):
                    if compress:
                        if step.errors is None:
                            step.errors = init_error_buffers(grads)
                        grads, step.errors = make_compressed_allreduce(
                            group, stats=step.comm)(grads, step.errors)
                    else:
                        grads = opt.tree_map(
                            lambda g: exact_mean(g, group, stats=step.comm),
                            grads)
                    loss = exact_mean(loss, group)
            with _span("train.optimizer"):
                params, opt_state, om = opt.apply_updates(
                    params, grads, opt_state, cfg_opt, donate=True)
        return params, opt_state, {"loss": loss, **om}

    step.errors = None
    step.comm = comm_stats()
    return step


def _sharded_step(model: Model, cfg_opt: opt.AdamWConfig, mesh, group,
                  compress: bool, *, microbatches: int, remat: bool):
    if mesh is not None and mesh is not model.tp.mesh:
        raise ValueError("the model is sharded on another mesh")
    if group is not None or compress:
        raise ValueError("a sharded model reduces over its mesh's groups; "
                         "group= and compress= belong to replicated data "
                         "parallelism")
    layout = ShardedLayout(model)

    def step(params, opt_state, batch):
        layout.comm.clear()
        with _span("train.step"):
            loss, grads = _grads_of(model, params, batch,
                                    microbatches=microbatches, remat=remat)
            with _span("train.reduce"):
                grads = layout.reduce_grads(grads)
                loss = layout.mean_over_data(loss)
            with _span("train.optimizer"):
                params, opt_state, om = opt.apply_updates(
                    params, grads, opt_state, cfg_opt, donate=True,
                    norm=layout.global_norm)
        step.comm = {k: dict(v) for k, v in layout.comm.items()}
        return params, opt_state, {"loss": loss, **om}

    step.layout = layout
    step.comm = {}
    return step
