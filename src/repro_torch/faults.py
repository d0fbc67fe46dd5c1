"""Deterministic fault injection: named sites, seeded schedules.

Chaos testing only works when a failing run can be replayed: every
injection site is a *named* hook (``SITES``), and whether a given
invocation fires is decided by a seeded per-site schedule — explicit
invocation indices, a per-invocation probability drawn from a per-site
RNG stream, or both.  Each site owns its own counter and its own
``numpy`` Generator (seeded from ``(seed, sha256(site))``), so the
schedule at one site is independent of how calls at other sites
interleave: a chaos run is reproducible from ``(seed, specs)`` alone.

Usage shape mirrors ``obs.tracing``: a process-global injector installed
with ``set_injector`` (None = all sites dormant), and a module-level
``inject(site)`` fast path whose cost when no injector is installed is
one global read::

    from repro_torch.faults import FaultSpec, FaultInjector, set_injector

    inj = FaultInjector([FaultSpec("store.corrupt", prob=0.01),
                         FaultSpec("kernel.nan_row", at=(5,))], seed=0)
    prev = set_injector(inj)
    try:
        ...   # chaos run: sites consult inject() and degrade gracefully
    finally:
        set_injector(prev)

Every fire is counted in the observability registry under
``faults.injected.<site>`` and emitted as a tracer event, so a chaos
run's fault schedule is visible in the same telemetry stream as the
degradations it provoked (``errors.*`` / ``degraded.*``).
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from .obs.registry import get_registry
from .obs.tracing import trace_event

_REG = get_registry()

# The fault-site registry: every injection point in the codebase, with
# what firing there simulates.  FaultInjector rejects unknown sites at
# construction so a typo'd chaos config fails loudly, not silently.
SITES: dict[str, str] = {
    "store.read_io":
        "plan-store entry read raises OSError (transient disk/NFS fault); "
        "the store treats it as a miss and the caller re-solves cold",
    "store.write_io":
        "plan-store entry write fails (full disk, IO error); the entry "
        "stays in the in-process cache and serving continues unpersisted",
    "store.corrupt":
        "plan-store entry bytes are mangled before parsing (torn write, "
        "bit rot); the store quarantines the entry and reports a miss",
    "solver.over_budget":
        "solver solve() behaves as if its time budget expired immediately "
        "after the first incumbent: returns a bounded certificate",
    "kernel.nan_row":
        "one decode logits row is poisoned with NaN (payload "
        "{'value': inf} for Inf) before the scheduler's sampling guard",
    "sched.slow_tick":
        "one scheduler tick stalls (payload {'stall_s': s}, default "
        "0.02) — exercises the stuck-tick watchdog",
    "traffic.burst":
        "traffic-replay arrival gaps collapse to zero for this request "
        "(a burst), exercising admission control / shedding",
    "router.replica_down":
        "one scheduler replica of the serving router dies mid-trace: its "
        "queued requests fail over to surviving replicas, its in-flight "
        "slots are evicted as ERRORED (streamed tokens kept)",
}


def _site_key(site: str) -> int:
    """Stable 64-bit stream key for one site name."""
    return int.from_bytes(hashlib.sha256(site.encode()).digest()[:8],
                          "big")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Schedule for one site: fire at explicit invocation indices
    (``at``) and/or with per-invocation probability ``prob``, at most
    ``limit`` times total.  ``payload`` rides along on the hit."""

    site: str
    prob: float = 0.0
    at: tuple[int, ...] = ()
    limit: int | None = None
    payload: dict | None = None

    def __post_init__(self):
        if self.site not in SITES:
            raise KeyError(f"unknown fault site {self.site!r}; known: "
                           f"{sorted(SITES)}")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")
        object.__setattr__(self, "at", tuple(int(i) for i in self.at))


@dataclasses.dataclass(frozen=True)
class FaultHit:
    """One fired fault: which site, at which invocation index, with
    what payload (the spec's, never None)."""

    site: str
    index: int
    payload: dict


class FaultInjector:
    """Seeded, countable fault scheduler over the site registry.

    ``fires(site)`` is called once per *invocation* of a site; it
    increments that site's invocation counter, consumes exactly one
    random draw when the spec is probabilistic (keeping the stream
    aligned regardless of which invocations hit), and returns a
    ``FaultHit`` or None.  Sites without a spec count invocations but
    never fire — ``invocations`` doubles as site-coverage telemetry.
    """

    def __init__(self, specs: "list[FaultSpec] | tuple[FaultSpec, ...]" = (),
                 *, seed: int = 0):
        self.seed = seed
        self.specs: dict[str, FaultSpec] = {}
        for spec in specs:
            if spec.site in self.specs:
                raise ValueError(f"duplicate spec for site {spec.site!r}")
            self.specs[spec.site] = spec
        self._rng = {site: np.random.default_rng([seed, _site_key(site)])
                     for site in self.specs}
        self.invocations: dict[str, int] = {}
        self.fired: dict[str, int] = {}

    def fires(self, site: str) -> FaultHit | None:
        idx = self.invocations.get(site, 0)
        self.invocations[site] = idx + 1
        spec = self.specs.get(site)
        if spec is None:
            return None
        hit = False
        if spec.prob > 0.0:
            # one draw per invocation, hit or not: stream stays aligned
            hit = bool(self._rng[site].random() < spec.prob)
        hit = hit or idx in spec.at
        if not hit:
            return None
        if spec.limit is not None and \
                self.fired.get(site, 0) >= spec.limit:
            return None
        self.fired[site] = self.fired.get(site, 0) + 1
        _REG.inc(f"faults.injected.{site}")
        trace_event(f"fault.{site}", index=idx)
        return FaultHit(site=site, index=idx, payload=spec.payload or {})

    def counts(self) -> dict:
        """{site: (invocations, fired)} over every site touched."""
        return {site: (n, self.fired.get(site, 0))
                for site, n in sorted(self.invocations.items())}


# ------------------------------------------------------------------ global
_INJECTOR: FaultInjector | None = None


def set_injector(inj: FaultInjector | None) -> FaultInjector | None:
    """Install (or clear, with None) the process injector; returns the
    previous one so callers can restore it."""
    global _INJECTOR
    prev = _INJECTOR
    _INJECTOR = inj
    return prev


def get_injector() -> FaultInjector | None:
    return _INJECTOR


def inject(site: str) -> FaultHit | None:
    """Instrumentation entry point: None (fast path) when no injector
    is installed or the site's schedule does not fire this invocation."""
    inj = _INJECTOR
    if inj is None:
        return None
    return inj.fires(site)


def parse_faults(text: str) -> list[FaultSpec]:
    """Chaos schedules from a CLI string.

    Comma-separated terms: ``site:prob`` (per-invocation probability),
    ``site@i`` / ``site@i+j+k`` (explicit invocation indices), or both
    (``site:0.01@5``).  Example::

        store.corrupt:0.01,kernel.nan_row@5,sched.slow_tick@2+9
    """
    specs = []
    for term in text.split(","):
        term = term.strip()
        if not term:
            continue
        site, prob, at = term, 0.0, ()
        if "@" in site:
            site, _, idxs = site.partition("@")
            at = tuple(int(i) for i in idxs.split("+") if i)
        if ":" in site:
            site, _, p = site.partition(":")
            prob = float(p)
        specs.append(FaultSpec(site=site, prob=prob, at=at))
    return specs


__all__ = ["SITES", "FaultHit", "FaultInjector", "FaultSpec",
           "get_injector", "inject", "parse_faults", "set_injector"]
