"""The training step: loss -> grad -> clip -> AdamW (the counterpart of
the reference's ``training/train_step.py``).

``make_train_step`` is the reference's function: microbatch gradients
accumulate in fp32 zeros, in microbatch order, times 1/microbatches.
``jit_train_step`` is the step a run takes (the counterpart of the
reference's pjit-wrapped step): it updates the parameters and the
moments in place, as the reference donates them, and over a data-parallel
``torch.distributed`` group it reduces the gradients before the update,
by the exact fp32 mean or by the int8 error-feedback all-reduce
(``grad_compression``), and reports the mean loss over the ranks.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.model import Model
from . import optimizer as opt
from .grad_compression import (comm_stats, exact_mean, init_error_buffers,
                               make_compressed_allreduce)


def _grads_of(model: Model, params, batch, *, microbatches: int,
              remat: bool):
    """(loss, grads): the mean over ``microbatches`` equal splits of the
    batch's rows, each a backward of its own (peak activations of one
    microbatch).  Every leaf gets a gradient (zeros where the loss does
    not reach it, as jax.grad gives)."""
    leaves = opt.tree_leaves(params)
    live = opt.tree_map(lambda p: p.detach().requires_grad_(), params)
    live_leaves = opt.tree_leaves(live)

    def one(mbatch):
        loss = model.loss(live, mbatch, remat=remat)
        grads = torch.autograd.grad(loss, live_leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

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
                   microbatches: int = 1, remat: bool = True,
                   compress: bool = False):
    """The step a run takes: parameters and moments updated in place.

    Over a data-parallel process group (``group``, or the default group
    when one is initialised) each rank takes its rows of the global
    batch; the gradients are reduced before the update, by the exact
    fp32 mean, or with ``compress`` by the int8 error-feedback
    all-reduce, whose error buffers the step keeps from one call to the
    next (``step.errors``; they are not checkpointed).  The loss in the
    metrics is the mean over the ranks.  ``step.comm`` counts the last
    step's all_reduces: calls, bytes and host seconds inside them."""
    data_parallel = group is not None or dist.is_initialized()

    def step(params, opt_state, batch):
        loss, grads = _grads_of(model, params, batch,
                                microbatches=microbatches, remat=remat)
        step.comm = comm_stats()
        if data_parallel:
            if compress:
                if step.errors is None:
                    step.errors = init_error_buffers(grads)
                grads, step.errors = make_compressed_allreduce(
                    group, stats=step.comm)(grads, step.errors)
            else:
                grads = opt.tree_map(
                    lambda g: exact_mean(g, group, stats=step.comm), grads)
            loss = exact_mean(loss, group)
        params, opt_state, om = opt.apply_updates(params, grads, opt_state,
                                                  cfg_opt, donate=True)
        return params, opt_state, {"loss": loss, **om}

    step.errors = None
    step.comm = comm_stats()
    return step
