"""Process-wide counter/gauge registry with scoped reset.

Names are dotted paths (``solver.calls``, ``plan_store.hits``,
``sched.decode_steps``); the dot hierarchy is the *only* structure —
there are no typed metric objects to pre-declare.  ``inc`` on an
unknown name creates it, which keeps instrumentation sites one line
and makes the registry safe to use from modules that must stay
import-light (``core.solver`` is imported by numpy-only planner
subprocesses, so this module depends on nothing outside the stdlib).

Scoped reset (``reset("solver.")``) zeroes exactly the counters under a
prefix, which is what the per-test autouse fixture and the serving
zero-steady-state-solve certification need: reset the solver namespace,
run the steady state, assert ``solver.calls`` stayed 0.

Counters are monotonic ints; gauges are last-write-wins floats
(e.g. ``solver.axis_cache.entries``).  ``snapshot()`` merges both into
one sorted dict for JSONL streaming (``launch/serve --metrics-jsonl``).

Conventions used across the repo:

  solver.calls                    one per ``solve()`` entry
  solver.solve_many.calls         batched entry points
  solver.chain.calls              fused-chain solves
  solver.axis_cache.{hits,misses} axis-candidate memo
  plan_store.{hits,misses,puts}   content-addressed store traffic
  planner.batches                 ``BatchPlanner.plan_gemms`` builds
  capture.{traces,plans}          jaxpr capture / program planning
  kernel.{gemm,fused_mlp}.dispatch   Python-level kernel dispatches
                                     (trace-time under jit)
  sched.*                         scheduler ticks / chunks / tokens
  sched.spec.{rounds,drafted,accepted}   scheduler-side speculative
                                  verify rounds and acceptance tallies
  sched.prefix_tokens_reused      prompt tokens grafted from the KV
                                  prefix cache instead of prefilled

Scale-out namespaces (see ``repro.serving.router`` and DESIGN.md
§Scale-out):

  router.{routed,failovers}       admissions routed / requests failed
                                  over from a dead replica
  router.replica<i>.routed        per-replica admission counts
  router.replica_downs            replica-death chaos events handled
  router.static_fallback          routers degraded to Engine.generate
                                  (unsupported model family)
  prefix.{hits,misses,inserts,evictions}   KV prefix-cache traffic
                                  (gauge prefix.bytes = bytes held)
  spec.{rounds,drafted,accepted,tokens}    static-path speculative
                                  decoding (spec.draft_steps = draft-
                                  model forward steps)

Resilience namespaces (see ``repro.faults`` and DESIGN.md §Resilience):

  faults.injected.<site>          deterministic fault injections fired
  errors.*                        genuine faults observed (injected or
                                  real): errors.store.{read_io,write_io,
                                  corrupt}, errors.sched.nan_row
  degraded.*                      graceful-degradation events taken in
                                  response: degraded.store.{quarantined,
                                  cold_resolves}, degraded.sched.{shed,
                                  expired}, degraded.solver.bounded,
                                  degraded.plans.bounded_served
  sched.prewarm_failures          per-group/per-shape prewarm failures
                                  that were logged and skipped
"""
from __future__ import annotations

import threading


class Registry:
    """Named monotonic counters + last-write gauges.

    Thread-safe via one lock; every operation is O(1) dict work, so the
    hot increments (solver inner loops, scheduler ticks) stay cheap.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}

    # ---------------------------------------------------------- counters
    def inc(self, name: str, value: int = 1) -> int:
        with self._lock:
            new = self._counters.get(name, 0) + value
            self._counters[name] = new
            return new

    def get(self, name: str, default: int = 0) -> int:
        with self._lock:
            return self._counters.get(name, default)

    def counters(self, prefix: str = "") -> dict[str, int]:
        with self._lock:
            return {k: v for k, v in sorted(self._counters.items())
                    if k.startswith(prefix)}

    # ------------------------------------------------------------ gauges
    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def gauge(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def gauges(self, prefix: str = "") -> dict[str, float]:
        with self._lock:
            return {k: v for k, v in sorted(self._gauges.items())
                    if k.startswith(prefix)}

    # ----------------------------------------------------------- control
    def snapshot(self, prefix: str = "") -> dict[str, float]:
        """Counters and gauges merged into one sorted flat dict."""
        with self._lock:
            merged: dict[str, float] = {}
            merged.update(self._counters)
            merged.update(self._gauges)
        return {k: merged[k] for k in sorted(merged)
                if k.startswith(prefix)}

    def reset(self, prefix: str = "") -> None:
        """Zero every counter and drop every gauge under ``prefix``.

        Counters are *zeroed in place* (the key survives) so a snapshot
        taken after a scoped reset still shows the namespace; gauges are
        removed because a stale last-write is worse than absence.
        """
        with self._lock:
            for k in self._counters:
                if k.startswith(prefix):
                    self._counters[k] = 0
            for k in [k for k in self._gauges if k.startswith(prefix)]:
                del self._gauges[k]


_REGISTRY = Registry()


def get_registry() -> Registry:
    """The process-global registry every instrumented module shares."""
    return _REGISTRY


def inc(name: str, value: int = 1) -> int:
    return _REGISTRY.inc(name, value)


def set_gauge(name: str, value: float) -> None:
    _REGISTRY.set_gauge(name, value)
