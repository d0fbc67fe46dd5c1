"""Replica router: N continuous schedulers behind one admission point.

One physical host (one jitted program set, one weight copy) can model a
fleet: every replica is a ``ContinuousScheduler`` with its own slot
pool, queue, and *virtual clock* (``TraceClock``), all sharing a single
``Engine``.  Trace replay runs as a discrete-event simulation — always
step the busy replica whose clock is furthest behind, fold the measured
wall time of its tick into *its* clock only — so N replicas' compute
interleaves on one machine while the virtual timeline is what N
parallel chips would have seen.  Fleet throughput is total tokens over
the *makespan* (the slowest clock), not the summed busy time.

Plan prewarm is one pass for the whole fleet: replica 0 derives the
bucketed GEMM groups and pushes every tiling through the plan store /
in-process cache; replicas 1..N-1 are constructed with the donor's
group dicts and skip both derivation and planning (``plan_groups``
ctor kwarg).  Steady state across *all* replicas certifies zero solver
invocations, same as a single scheduler.

Routing is least-loaded: queued + in-flight requests, ties broken by
the laggiest clock.  An optional shared ``PrefixCache`` rides across
replicas (KV rows are replica-agnostic), so a prefix prefilled on one
replica saves prefill compute on all of them.

Failure: the ``router.replica_down`` chaos site kills the laggiest busy
replica mid-trace.  Its queued and in-flight-prefill requests (no
user-visible token yet) fail over transparently to survivors; its
decode slots are evicted as ERRORED with their streamed prefix kept —
truncation, never divergence.

Unsupported model families (recurrent state, frontend prefixes — see
``ensure_supported_family``) degrade to a static fallback: the router
still accepts traces and produces ``RequestResult``s, serving requests
one at a time through ``Engine.generate``.
"""
from __future__ import annotations

import collections
import dataclasses
import logging

import numpy as np

from ...faults import inject
from ...obs.registry import get_registry
from ..engine import Engine
from ..sched.metrics import ServingMetrics
from ..sched.requests import Request, RequestResult
from ..sched.scheduler import (ContinuousScheduler, SchedConfig,
                               ensure_supported_family)
from ..sched.traffic import TraceClock

_REG = get_registry()
_LOG = logging.getLogger(__name__)


@dataclasses.dataclass
class RouterConfig:
    replicas: int = 2
    sched: SchedConfig = dataclasses.field(default_factory=SchedConfig)
    # fleet-level latency SLOs (ServingMetrics.merged summary)
    ttft_slo_s: float | None = None
    tpot_slo_s: float | None = None


class ReplicaRouter:
    def __init__(self, engine: Engine, cfg: RouterConfig | None = None, *,
                 arch_id: str | None = None, prefix_cache=None,
                 drafter=None, on_token=None, on_finish=None):
        self.engine = engine
        self.cfg = cfg or RouterConfig()
        n = self.cfg.replicas
        if n < 1:
            raise ValueError(f"need >= 1 replica, got {n}")
        self.clocks = [TraceClock() for _ in range(n)]
        self.scheds: list[ContinuousScheduler] = []
        self.alive: list[bool] = []
        self._static_results: list[RequestResult] = []
        # unsupported family -> static Engine.generate fallback (clear
        # construction-time signal instead of failing in slot grafting)
        self.static_reason: str | None = None
        try:
            ensure_supported_family(engine.model.cfg)
        except ValueError as e:
            self.static_reason = str(e)
            _REG.inc("router.static_fallback")
            _LOG.warning("router: continuous batching unavailable (%s); "
                         "serving via static Engine.generate", e)
            return
        # replica 0 is the prewarm donor: one derivation + one planning
        # pass covers the fleet (identical engine/config -> identical
        # bucketed shape groups on every replica)
        donor = ContinuousScheduler(
            engine, self.cfg.sched, arch_id=arch_id,
            clock=self.clocks[0].now, prefix_cache=prefix_cache,
            drafter=drafter, on_token=on_token, on_finish=on_finish)
        self.scheds.append(donor)
        for i in range(1, n):
            self.scheds.append(ContinuousScheduler(
                engine, self.cfg.sched, clock=self.clocks[i].now,
                prefix_cache=prefix_cache, drafter=drafter,
                on_token=on_token, on_finish=on_finish,
                plan_groups=donor._plan_groups,
                chain_groups=donor._chain_groups))
        self.alive = [True] * n
        self.prewarmed_plans = donor.prewarmed_plans
        _REG.set_gauge("router.replicas", n)

    # ------------------------------------------------------------ routing
    def _alive(self) -> list[int]:
        return [i for i, a in enumerate(self.alive) if a]

    def _load(self, i: int) -> int:
        s = self.scheds[i]
        return len(s.queue) + s.slots.n_busy + \
            (1 if s._prefill is not None else 0)

    def submit(self, req: Request, *, now: float | None = None):
        """Admit one request to the least-loaded live replica (ties go
        to the laggiest clock, so work also levels *time*).  ``now`` is
        the trace-time of the admission; the target replica's clock
        never moves backwards."""
        if self.static_reason is not None:
            raise RuntimeError(
                "router is in static fallback; drive it with "
                f"route_trace() ({self.static_reason})")
        alive = self._alive()
        if not alive:
            raise RuntimeError("no live replicas")
        j = min(alive, key=lambda i: (self._load(i),
                                      self.clocks[i].now(), i))
        if now is not None:
            self.clocks[j].wait_until(now)
        _REG.inc("router.routed")
        _REG.inc(f"router.replica{j}.routed")
        return self.scheds[j].submit(req)

    # ---------------------------------------------------------- failover
    def _kill(self, victim: int) -> None:
        """Chaos ``router.replica_down``: mark the replica dead, requeue
        its evacuated requests on survivors.  Evacuated requests keep
        their original ``arrival_s`` (their latency honestly includes
        the failover), but land at the dead replica's current time."""
        self.alive[victim] = False
        _REG.inc("router.replica_downs")
        evac = self.scheds[victim].evacuate()
        now = self.clocks[victim].now()
        _LOG.warning("router: replica %d down at t=%.3fs; failing over "
                     "%d request(s)", victim, now, len(evac))
        for req in evac:
            self.submit(req, now=now)
        _REG.inc("router.failovers", len(evac))

    # ------------------------------------------------------------ driving
    def route_trace(self, requests: list[Request]
                    ) -> list[RequestResult]:
        """Discrete-event replay of a trace across the fleet.

        Invariant: an arrival is delivered before any busy replica's
        clock steps past it, so load scores at routing time reflect the
        state the fleet would actually have had at that trace moment.
        """
        if self.static_reason is not None:
            return self._route_static(requests)
        pending = collections.deque(sorted(requests,
                                           key=lambda r: r.arrival_s))
        while True:
            busy = [i for i in self._alive() if self.scheds[i].busy]
            if pending:
                horizon = min((self.clocks[i].now() for i in busy),
                              default=float("inf"))
                if pending[0].arrival_s <= horizon + 1e-12:
                    req = pending.popleft()
                    self.submit(req, now=req.arrival_s)
                    continue
            if not busy:
                break
            j = min(busy, key=lambda i: self.clocks[i].now())
            hit = inject("router.replica_down")
            if hit is not None and sum(self.alive) > 1:
                self._kill(j)
                continue
            clk = self.clocks[j]
            clk.pin()                # in-tick timestamps include compute
            try:
                self.scheds[j].step()
            finally:
                clk.release()
        return self.results()

    def _route_static(self, requests: list[Request]
                      ) -> list[RequestResult]:
        """Fallback for unsupported families: serve the trace one
        request at a time through ``Engine.generate`` on a single
        virtual clock.  No streaming — first token and finish coincide
        at batch drain, like ``run_static_baseline``."""
        clock = self.clocks[0]
        engine = self.engine
        orig_budget = engine.cfg.max_new_tokens
        orig_stop = engine.cfg.stop_token
        try:
            for req in sorted(requests, key=lambda r: r.arrival_s):
                clock.wait_until(req.arrival_s)
                engine.cfg.max_new_tokens = req.max_new_tokens
                stop = req.stop_token if req.stop_token is not None \
                    else self.cfg.sched.stop_token
                engine.cfg.stop_token = stop
                clock.pin()
                try:
                    out = engine.generate(np.asarray(req.tokens)[None])
                finally:
                    clock.release()
                row = out[0]
                stopped = stop is not None and bool((row == stop).any())
                if stopped:
                    row = row[:int(np.argmax(row == stop)) + 1]
                done = clock.now()
                res = RequestResult(
                    req_id=req.req_id,
                    tokens=[int(t) for t in row],
                    finish_reason="stop" if stopped else "length",
                    prompt_len=req.prompt_len, arrival_s=req.arrival_s,
                    first_token_s=done, finish_s=done)
                self._static_results.append(res)
                _REG.inc("router.static_served")
        finally:
            engine.cfg.max_new_tokens = orig_budget
            engine.cfg.stop_token = orig_stop
        return self.results()

    # ------------------------------------------------------------ results
    def results(self) -> list[RequestResult]:
        out = list(self._static_results)
        for s in self.scheds:
            out.extend(s.results)
        return out

    @property
    def makespan_s(self) -> float:
        """Fleet elapsed time: the slowest replica's clock."""
        return max((c.now() for c in self.clocks), default=0.0)

    def metrics(self) -> ServingMetrics:
        if self.static_reason is not None:
            m = ServingMetrics(ttft_slo_s=self.cfg.ttft_slo_s,
                               tpot_slo_s=self.cfg.tpot_slo_s)
            for r in self._static_results:
                m.record_result(r)
            m.finished_s = self.makespan_s
            return m
        return ServingMetrics.merged(
            [s.metrics for s in self.scheds],
            elapsed_s=self.makespan_s,
            ttft_slo_s=self.cfg.ttft_slo_s,
            tpot_slo_s=self.cfg.tpot_slo_s)

    def summary(self) -> dict:
        out = self.metrics().summary()
        out.update(replicas=self.cfg.replicas,
                   alive=int(sum(self.alive)) if self.alive
                   else 0,
                   makespan_s=round(self.makespan_s, 6))
        if self.static_reason is not None:
            out["static_fallback"] = self.static_reason
        return out
