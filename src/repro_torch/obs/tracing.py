"""Structured span tracer: nested spans, injected clock, JSONL export.

Design mirrors the scheduler's clock idiom: a ``Tracer`` takes any
``clock: () -> float`` — ``time.perf_counter`` for live serving, a
virtual/fake clock for deterministic replay tests — so the same
instrumentation yields wall timings in production and bit-identical
span streams under replay.

Two usage shapes:

  * stacked spans (the common case) — ``with span("solver.solve", ...)``
    nests under whatever span is currently open on this tracer:

        with span("planner.plan_gemms", rows=64) as sp:
            ...              # solver.solve spans open inside parent here
            if sp: sp.attrs["solved"] = n     # late attributes are fine

  * detached spans — long-lived spans that interleave across ticks and
    therefore cannot live on the stack (per-request admit→finish in the
    scheduler).  ``tracer.start("sched.request", detached=True)`` +
    ``tracer.end(sp)``; point-in-time marks (first token) attach via
    ``tracer.event("first_token", parent=sp)`` as zero-length children.

When no tracer is installed (the default), ``span()`` returns a shared
no-op context manager and ``trace_event`` returns ``None`` — the cost
at every instrumented site is one global read and a dict pack, which is
what keeps the serving overhead gate (benchmarks/bench_obs.py) under
5%.

JSONL schema, one object per span, ordered by ``sid``::

    {"sid": 3, "parent": 1, "name": "solver.solve",
     "t0": 0.013, "t1": 0.192, "attrs": {"dims": [256, 256, 64]}}

``Tracer.to_jsonl`` / ``Tracer.from_jsonl`` round-trip exactly (tested
in tests/test_obs.py).
"""
from __future__ import annotations

import dataclasses
import io
import json
import time
from contextlib import contextmanager
from typing import Any, Callable, Iterator, Optional


@dataclasses.dataclass
class Span:
    sid: int
    name: str
    t0: float
    t1: Optional[float] = None
    parent: Optional[int] = None
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0

    def to_json(self) -> dict:
        return {"sid": self.sid, "parent": self.parent, "name": self.name,
                "t0": self.t0, "t1": self.t1, "attrs": self.attrs}

    @classmethod
    def from_json(cls, obj: dict) -> "Span":
        return cls(sid=obj["sid"], name=obj["name"], t0=obj["t0"],
                   t1=obj.get("t1"), parent=obj.get("parent"),
                   attrs=dict(obj.get("attrs") or {}))


class _NullSpan:
    """Absorbs every span operation; shared singleton for the off path.

    Truthiness is False so call sites can guard late-attribute writes
    with ``if sp: sp.attrs[...] = ...``."""

    attrs: dict[str, Any] = {}

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """Collects spans; single-threaded by design (one tracer per loop,
    matching the scheduler / benchmark harnesses that drive it)."""

    def __init__(self, clock: Callable[[], float] | None = None):
        self.clock = clock if clock is not None else time.perf_counter
        self.spans: list[Span] = []
        self._stack: list[int] = []
        self._next_sid = 0

    # ------------------------------------------------------------ spans
    def start(self, name: str, *, detached: bool = False,
              parent: Span | None = None, **attrs: Any) -> Span:
        """Open a span.  Stacked spans parent under the innermost open
        span; detached spans record the current parent but do not join
        the stack (they may outlive it)."""
        if parent is not None:
            pid: Optional[int] = parent.sid
        else:
            pid = self._stack[-1] if self._stack else None
        sp = Span(sid=self._next_sid, name=name, t0=self.clock(),
                  parent=pid, attrs=dict(attrs))
        self._next_sid += 1
        self.spans.append(sp)
        if not detached:
            self._stack.append(sp.sid)
        return sp

    def end(self, sp: Span, **attrs: Any) -> Span:
        sp.t1 = self.clock()
        if attrs:
            sp.attrs.update(attrs)
        if self._stack and self._stack[-1] == sp.sid:
            self._stack.pop()
        return sp

    @contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Span]:
        sp = self.start(name, **attrs)
        try:
            yield sp
        finally:
            self.end(sp)

    def event(self, name: str, *, parent: Span | None = None,
              **attrs: Any) -> Span:
        """Zero-length span: a point-in-time mark (first token, eviction)."""
        sp = self.start(name, detached=True, parent=parent, **attrs)
        sp.t1 = sp.t0
        return sp

    # ------------------------------------------------------------ export
    def clear(self) -> None:
        self.spans.clear()
        self._stack.clear()
        self._next_sid = 0

    def dumps_jsonl(self) -> str:
        buf = io.StringIO()
        for sp in self.spans:
            buf.write(json.dumps(sp.to_json(), sort_keys=True))
            buf.write("\n")
        return buf.getvalue()

    def to_jsonl(self, path) -> None:
        with open(path, "w") as fh:
            fh.write(self.dumps_jsonl())

    @classmethod
    def from_jsonl(cls, path) -> list[Span]:
        spans = []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    spans.append(Span.from_json(json.loads(line)))
        return spans

    # ----------------------------------------------------------- queries
    def children(self, sp: Span) -> list[Span]:
        return [s for s in self.spans if s.parent == sp.sid]

    def by_name(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]


# --------------------------------------------------------------- global
_TRACER: Tracer | None = None


def set_tracer(tracer: Tracer | None) -> Tracer | None:
    """Install (or clear, with None) the process tracer; returns the
    previous one so callers can restore it."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


def get_tracer() -> Tracer | None:
    return _TRACER


def span(name: str, **attrs: Any):
    """Instrumentation entry point: a context manager that is a shared
    no-op when no tracer is installed."""
    t = _TRACER
    if t is None:
        return NULL_SPAN
    return t.span(name, **attrs)


def trace_event(name: str, **attrs: Any) -> Span | None:
    t = _TRACER
    if t is None:
        return None
    return t.event(name, **attrs)
