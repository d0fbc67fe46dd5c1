"""Trace time on a tensor-parallel engine: one clock that every rank
reads alike.

``traffic.TraceClock`` folds each tick's measured wall time into the
virtual trace time at ``release``.  Two ranks measure two times, so
their clocks part by microseconds a tick; ``traffic.replay`` would then
submit a request before a tick on one rank and after it on another,
and the router would step another replica.  ``RankClock`` folds in the
time that the model axis's first rank measured (one broadcast a
tick), so between ticks every rank's clock reads the same, and so do
the decisions taken from it.  Inside a tick the scheduler takes its
reading from rank 0 too (``scheduler.TickOrders``).
"""
from __future__ import annotations

import time

import torch

from .traffic import TraceClock


class RankClock(TraceClock):
    """A ``TraceClock`` whose ``release`` folds in rank 0's measured
    time, broadcast over the model axis of ``tp``
    (``models.parallel.TensorParallel``)."""

    def __init__(self, tp):
        super().__init__()
        self.tp = tp

    def release(self) -> None:
        dt = torch.tensor([time.perf_counter() - self._pin],
                          dtype=torch.float64)
        self.advance(float(self.tp.broadcast(dt)[0]))
        self._pin = None
