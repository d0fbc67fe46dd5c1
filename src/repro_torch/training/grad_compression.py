"""Int8 error-feedback gradient compression for the data-parallel
all-reduce, over a ``torch.distributed`` group (the counterpart of the
reference's ``training/grad_compression.py``, which runs it under
``shard_map`` over the mesh's data axes).

Off by default.  Gradients are quantized to int8 with a per-tensor
scale agreed by all ranks before the all-reduce; the quantization
residual is carried in an error-feedback buffer, so the compression bias
vanishes over steps (Seide et al. / EF-SGD style).  As in the reference
the int8 values are summed as int32, so the all-reduce moves 4 bytes an
element, as many as the exact fp32 mean (``exact_mean``): the payload
is not smaller, only quantized.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .optimizer import tree_map


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _all_reduce(t: torch.Tensor, op, group, stats) -> None:
    """In place; counted in ``stats`` (calls, bytes, seconds inside).  A
    trace's meta tensor is counted (no seconds) and not run."""
    if t.device.type == "meta":
        if stats is not None:
            stats["calls"] += 1
            stats["bytes"] += t.numel() * t.element_size()
        return
    if not dist.is_initialized():
        return
    t0 = time.perf_counter()
    dist.all_reduce(t, op=op, group=group)
    if stats is not None:
        stats["calls"] += 1
        stats["bytes"] += t.numel() * t.element_size()
        stats["seconds"] += time.perf_counter() - t0


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group=None, *,
                    stats: dict | None = None):
    """One tensor: returns (mean-reduced g approx, new error buffer).

    A global max-scale is agreed first (an all_reduce MAX of one scalar),
    every rank quantizes with it, the int8 payload is summed as int32,
    and the decode is exact w.r.t. the quantized values; only the local
    quantization residual enters the error buffer.  The reference's
    arithmetic, step for step.  Without an initialised process group
    (one rank) the sums are the rank's own."""
    gf = g.to(torch.float32) + err
    gmax = torch.max(torch.abs(gf)).reshape(1)
    _all_reduce(gmax, dist.ReduceOp.MAX, group, stats)
    scale = torch.clamp(gmax[0], min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.to(torch.float32) * scale
    summed = q.to(torch.int32)
    _all_reduce(summed, dist.ReduceOp.SUM, group, stats)
    mean = summed.to(torch.float32) * scale / _world(group)
    return mean.to(g.dtype), new_err


def exact_mean(g: torch.Tensor, group=None, *,
               stats: dict | None = None) -> torch.Tensor:
    """The exact mean over the group's ranks: an fp32 all_reduce SUM,
    then / world."""
    s = g.to(torch.float32).clone()
    _all_reduce(s, dist.ReduceOp.SUM, group, stats)
    return (s / _world(group)).to(g.dtype)


def make_compressed_allreduce(group=None, *, stats: dict | None = None):
    """Returns f(grads_tree, err_tree) -> (reduced_tree, new_err_tree):
    ``compressed_psum`` leaf by leaf over ``group`` (the default group
    when None), every rank in one order.  Each rank passes its own
    gradients; every rank gets the same reduced tree."""

    def reduce_tree(grads, errs):
        out = tree_map(lambda g, e: compressed_psum(g, e, group,
                                                    stats=stats),
                       grads, errs)
        return (tree_map(lambda o: o[0], out),
                tree_map(lambda o: o[1], out))

    return reduce_tree


def init_error_buffers(grads_like):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def comm_stats() -> dict:
    """A fresh counter of a step's all_reduces: calls, bytes, seconds."""
    return {"calls": 0, "bytes": 0, "seconds": 0.0}


__all__ = ["compressed_psum", "comm_stats", "exact_mean",
           "init_error_buffers", "make_compressed_allreduce"]
