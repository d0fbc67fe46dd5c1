"""The port's spans on the device trace's clock: each kernel put down to
the port span that launched it, each idle gap to the port span that was
open.

The port's tracer anchors its clock to the Unix epoch (``obs.clock``
events), and a chrome trace counts ``ts`` in microseconds from its
``baseTimeNanoseconds`` on the same epoch, so a span converts onto the
trace with the tracer's ``to_trace_us``.  A kernel belongs to the
innermost span that holds the host's launch call (the ``cuda_runtime``
or ``cuda_driver`` event with the kernel's correlation id); an idle gap
between kernels to the innermost span open at the gap's middle, or to
``OUTSIDE``.

A stretch's ``Profile`` carries ``launch_us`` (the launch call's time
of each kernel, aligned with ``kernels``, None where no call was found)
and ``base_ns`` when its reader keeps them; without them, or without
anchors in the spans (a program whose tracer does not anchor), nothing
here has anything to read and the functions return None.

Only spans on the stack count: a detached span that outlives its
parent (``sched.request``), a zero-length event and the anchors are
left out.  Stack spans nest, so the innermost span open at a time is the
first of the latest-starting span's ancestors that is still open then.
"""
from __future__ import annotations

import bisect
import collections

from .devtrace import _busy_and_gaps

# the port tracer's anchor name, written out so that a reader finds no
# anchors, and imports nothing, in a program whose tracer has none
CLOCK = "obs.clock"
OUTSIDE = "outside the port's spans"


class Timeline:
    """The stack spans of a stretch, in trace microseconds."""

    def __init__(self, spans: list, base_ns: int):
        from repro_torch.obs.tracing import anchors, to_trace_us
        pairs = anchors(spans)
        by_sid = {s.sid: s for s in spans}
        kept = {}
        for s in sorted(spans, key=lambda s: s.sid):
            if s.name == CLOCK or s.t1 is None or s.t1 <= s.t0:
                continue
            p = by_sid.get(s.parent)
            if p is not None and (p.sid not in kept or s.t1 > p.t1):
                continue
            kept[s.sid] = s
        order = sorted(kept.values(), key=lambda s: (s.t0, s.sid))
        self.spans = order
        self.t0 = [to_trace_us(s.t0, pairs, base_ns) for s in order]
        self.t1 = [to_trace_us(s.t1, pairs, base_ns) for s in order]
        index = {s.sid: i for i, s in enumerate(order)}
        self.parent = [index.get(s.parent) for s in order]

    def innermost(self, t: float) -> int | None:
        """The index of the innermost span open at ``t`` (trace µs)."""
        i = bisect.bisect_right(self.t0, t) - 1
        while i is not None and i >= 0:
            if t <= self.t1[i]:
                return i
            i = self.parent[i]
        return None

    def within(self, i: int | None, names) -> int | None:
        """The index of span ``i`` or of its nearest ancestor named in
        ``names``; None if there is none."""
        while i is not None:
            if self.spans[i].name in names:
                return i
            i = self.parent[i]
        return None

    def roots(self) -> list[int]:
        return [i for i, p in enumerate(self.parent) if p is None]


def timeline(prof, spans) -> Timeline | None:
    """The spans on ``prof``'s clock, or None when the profile has no
    launch times or the spans no anchors."""
    if prof is None or not spans or \
            getattr(prof, "launch_us", None) is None or \
            getattr(prof, "base_ns", None) is None or \
            not any(s.name == CLOCK for s in spans):
        return None
    return Timeline(spans, prof.base_ns)


def owners(prof, tl: Timeline) -> list:
    """Per kernel of ``prof`` (in its order), the index of the innermost
    span that holds its launch call, or None."""
    return [None if t is None else tl.innermost(t) for t in prof.launch_us]


def busy_us(intervals) -> float:
    """The union's length of (start, duration) intervals."""
    return 1e6 * _busy_and_gaps([(None, t0, d) for t0, d in intervals])[0]


def idle_gaps(prof, tl: Timeline) -> list[tuple[float, float]]:
    """The profile's gaps between kernels, and the idle edges from the
    first root span's start to the first kernel and from the last
    kernel's end to the last root span's end."""
    gaps = list(prof.gaps)
    roots = tl.roots()
    if prof.kernels and roots:
        first = min(tl.t0[i] for i in roots)
        last = max(tl.t1[i] for i in roots)
        start = prof.kernels[0][1]
        end = max(k[1] + k[2] for k in prof.kernels)
        if first < start:
            gaps.insert(0, (first, start))
        if end < last:
            gaps.append((end, last))
    return gaps


def idle_by_span(prof, tl: Timeline) -> dict:
    """Idle microseconds summed by the innermost span open at each gap's
    middle (``OUTSIDE`` where none was), keyed by span index or
    ``OUTSIDE``."""
    tot = collections.Counter()
    for g0, g1 in idle_gaps(prof, tl):
        i = tl.innermost((g0 + g1) / 2)
        tot[OUTSIDE if i is None else i] += g1 - g0
    return tot


def idle_account(prof, spans, top: int = 10) -> list | None:
    """Idle seconds by the name of the innermost open port span, for the
    run's account; None without launch times or anchors."""
    tl = timeline(prof, spans)
    if tl is None:
        return None
    tot = collections.Counter()
    for key, us in idle_by_span(prof, tl).items():
        tot[key if key == OUTSIDE else tl.spans[key].name] += us / 1e6
    return [[n, s] for n, s in tot.most_common(top)]


def device_ms_by(prof, spans, phase: str, per: str) -> list[float] | None:
    """For each span named ``per``, the device busy time in ms of the
    kernels launched inside a ``phase`` span (or a span within one)
    inside it; spans ``per`` that launched none are left out."""
    tl = timeline(prof, spans)
    if tl is None:
        return None
    got = collections.defaultdict(list)
    for k, i in zip(prof.kernels, owners(prof, tl)):
        if tl.within(i, (phase,)) is None:
            continue
        top = tl.within(i, (per,))
        if top is not None:
            got[top].append((k[1], k[2]))
    return [busy_us(v) / 1e3 for _, v in sorted(got.items())]


def launches_by(prof, spans, per: str) -> list[int] | None:
    """For each span named ``per``, the kernels, copies and sets
    launched inside it."""
    tl = timeline(prof, spans)
    if tl is None:
        return None
    got = collections.Counter(tl.within(i, (per,))
                              for i in owners(prof, tl))
    return [got[i] for i, s in enumerate(tl.spans) if s.name == per]


def idle_share(prof, spans, names) -> tuple[float, float] | None:
    """(idle inside, idle elsewhere) in percent of the stretch's window:
    idle while the innermost open span was one of ``names`` or within
    one, and at any other time."""
    tl = timeline(prof, spans)
    if tl is None or prof.window_s <= 0:
        return None
    inside = other = 0.0
    for key, us in idle_by_span(prof, tl).items():
        if key != OUTSIDE and tl.within(key, names) is not None:
            inside += us
        else:
            other += us
    w = prof.window_s * 1e6
    return 100.0 * inside / w, 100.0 * other / w


def covered_busy(prof, spans, names) -> float | None:
    """The share of the stretch's busy time launched inside spans named
    in ``names``."""
    tl = timeline(prof, spans)
    if tl is None or not prof.kernels:
        return None
    inside = [(k[1], k[2]) for k, i in zip(prof.kernels, owners(prof, tl))
              if tl.within(i, names) is not None]
    return busy_us(inside) / busy_us((k[1], k[2]) for k in prof.kernels)


def gemm_clock_check(prof, spans, kernel: str = "goma_matmul") -> dict | None:
    """Whether each ``kernel`` launch lies inside a ``kernel.gemm`` span
    and is the span that the launch-order pairing
    (``harness/kernels.py``) gives it, and the smallest margin by which
    a launch lies inside its span (µs; negative: outside)."""
    tl = timeline(prof, spans)
    if tl is None:
        return None
    gemm = [i for i, s in enumerate(tl.spans) if s.name == "kernel.gemm"
            and not s.attrs.get("force_plain")]
    mine, margin = [], None
    for k, t in zip(prof.kernels, prof.launch_us):
        if kernel not in k[0]:
            continue
        i = None if t is None else tl.within(tl.innermost(t),
                                             ("kernel.gemm",))
        mine.append(i)
        if i is not None:
            m = min(t - tl.t0[i], tl.t1[i] - t)
            margin = m if margin is None else min(margin, m)
    return {"kernels": len(mine),
            "inside": sum(i is not None for i in mine),
            "launch_order": mine == gemm,
            "margin_us": margin}
