"""The replica router on a tensor-parallel engine.

``router.ReplicaRouter`` (a verbatim copy of the reference's) gives each
replica its own ``TraceClock`` and steps the busy replica whose clock is
furthest behind.  On tensor-parallel ranks those clocks must read alike
on every rank, or the ranks step different replicas and their
collectives pair passes of different schedulers.  ``TPReplicaRouter``
swaps each replica's clock for a ``sched.tp.RankClock``, which folds in
the time the model axis's first rank measured; every routing choice is
then the same on every rank, and each replica's scheduler takes its
tick orders from rank 0 (``sched.scheduler.TickOrders``).
"""
from __future__ import annotations

from ..sched.tp import RankClock
from .router import ReplicaRouter


class TPReplicaRouter(ReplicaRouter):
    """``ReplicaRouter`` whose replica clocks are ``RankClock``s on a
    tensor-parallel engine (on one device, the router as it is)."""

    def __init__(self, engine, cfg=None, **kwargs):
        super().__init__(engine, cfg, **kwargs)
        tp = engine.model.tp
        if tp is not None:
            self.clocks = [RankClock(tp) for _ in self.clocks]
            for sched, clock in zip(self.scheds, self.clocks):
                sched.clock = clock.now
