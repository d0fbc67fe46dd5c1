"""Certified (energy, delay) Pareto frontiers — shared machinery.

The epsilon-constraint method (Haimes 1971) recovers every point of a
discrete Pareto frontier by minimizing one objective under a sweep of
constraints on the other.  Here the constrained objective is the
solver's energy scalar and the constraint is ``num_pe_used >= p``:
delay's compute term is V/num_pe_used, so sweeping the spatial-product
floor over its achievable values enumerates the discrete delay levels
(the bandwidth terms are mapping-dependent and handled by the final
exact non-dominance filter).  Each slice optimum carries the ordinary
zero-gap ``Certificate`` of its constrained solve; soundness of the
frontier therefore reduces to (a) each point being a certified slice
optimum and (b) the post-hoc non-dominance filter under the *exact*
latency model, both independently re-checkable via ``verify_pareto``.

The deterministic non-dominance filter (``pareto_min``) is shared with
``core.codesign.pareto_frontier``: sort ascending by (a, b, tie), keep a
point iff its b strictly improves on everything kept so far.  Ties are
therefore resolved toward the smaller primary key (e.g. smaller area /
smaller energy), and equal-(a, b) duplicates collapse onto the
tie-minimal representative — no epsilon, no sort-order dependence.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence, TypeVar

from .certificate import Certificate, verify
from .edp import evaluate
from .geometry import Gemm, Mapping
from .hardware import AcceleratorSpec, Bandwidth

T = TypeVar("T")


def pareto_min(points: Sequence[T], key_a: Callable[[T], float],
               key_b: Callable[[T], float],
               tie: Callable[[T], object] | None = None) -> list[T]:
    """Deterministic non-dominated subset minimizing (a, b) jointly.

    Returned in ascending a / strictly descending b order.  A point is
    dominated iff another point is <= in both coordinates and < in at
    least one; among mutually equal (a, b) points exactly one survives
    (the ``tie``-minimal one, so callers get a reproducible frontier
    regardless of input order)."""
    def sort_key(p: T):
        k = (key_a(p), key_b(p))
        return k + (tie(p),) if tie is not None else k

    out: list[T] = []
    best_b = math.inf
    for p in sorted(points, key=sort_key):
        if key_b(p) < best_b:
            out.append(p)
            best_b = key_b(p)
    return out


@dataclasses.dataclass(frozen=True)
class ParetoPoint:
    """One certified frontier point: a constrained-solve optimum priced
    under the exact latency model."""

    min_pe: int | None            # the epsilon-constraint floor (None =
    # the unconstrained base solve, i.e. the energy-optimal endpoint)
    mapping: Mapping
    certificate: Certificate      # zero-gap certificate of the slice
    energy_pj: float
    delay_ns: float
    edp: float
    num_pe_used: int


@dataclasses.dataclass
class ParetoCertificate:
    """A verified (energy, delay) frontier for one (GEMM, spec) pair.

    ``points`` is the non-dominated set in ascending energy / strictly
    descending delay order; ``points[0]`` is bit-identical to the
    unconstrained ``solve`` optimum.  ``candidates_seen`` counts the
    slice optima before the non-dominance filter; ``levels_total`` vs
    ``levels_swept`` records epsilon-level thinning (equal when the
    sweep was exhaustive)."""

    gemm: Gemm
    hw_name: str
    objective_kind: str           # objective of the constrained solves
    spatial_mode: str             # effective mode ("le" ⇒ real sweep;
    # "equality"/"fixed" pin num_pe_used ⇒ single-point frontier)
    bandwidth: tuple[float, float, float]   # (dram, sram, rf) words/cycle
    points: tuple[ParetoPoint, ...]
    feasible: bool
    levels_total: int = 0
    levels_swept: int = 0
    candidates_seen: int = 0
    solve_time_s: float = 0.0

    @property
    def energy_optimal(self) -> ParetoPoint | None:
        return self.points[0] if self.points else None


def select_frontier_point(points: Sequence[ParetoPoint],
                          latency_slo_ns: float | None) -> ParetoPoint | None:
    """SLO-driven frontier selection (shared by serving and the CLI).

    No SLO ⇒ the energy-optimal endpoint.  With an SLO, the cheapest
    point meeting ``delay_ns <= latency_slo_ns``; if none meets it, the
    fastest point (best effort — the SLO is infeasible for this GEMM)."""
    if not points:
        return None
    if latency_slo_ns is None:
        return points[0]
    for p in points:              # ascending energy
        if p.delay_ns <= latency_slo_ns:
            return p
    return min(points, key=lambda p: (p.delay_ns, p.energy_pj))


def verify_pareto(pc: ParetoCertificate, hw: AcceleratorSpec,
                  *, bw: Bandwidth | None = None,
                  rel_tol: float = 1e-9) -> bool:
    """Independent re-check of a frontier (not of per-slice optimality —
    that is each point's own zero-gap certificate, re-checked here via
    ``certificate.verify``).

    Checks: every point's certificate verifies against ``hw``; its
    mapping honors its epsilon constraint (num_pe_used >= min_pe); its
    stored (energy, delay, edp) match a fresh oracle evaluation under
    the recorded bandwidth; and the point set is mutually non-dominated
    in ascending-energy / strictly-descending-delay order."""
    if hw.name != pc.hw_name:
        return False
    if not pc.feasible:
        return not pc.points
    if not pc.points:
        return False
    if bw is None:
        bw = Bandwidth(*pc.bandwidth)
    prev_e, prev_t = -math.inf, math.inf
    for p in pc.points:
        if not verify(p.certificate, hw, rel_tol=rel_tol):
            return False
        if p.certificate.objective_kind != pc.objective_kind:
            return False
        if p.min_pe is not None and p.num_pe_used < p.min_pe:
            return False
        rep = evaluate(pc.gemm, p.mapping, hw, bw=bw)
        for got, want in ((p.energy_pj, rep.energy_pj),
                          (p.delay_ns, rep.delay_ns), (p.edp, rep.edp)):
            if abs(got - want) > rel_tol * max(1.0, abs(want)):
                return False
        if rep.num_pe_used != p.num_pe_used:
            return False
        # frontier order: energy nondecreasing, delay strictly improving
        if p.energy_pj < prev_e - rel_tol * max(1.0, abs(prev_e)):
            return False
        if p.delay_ns >= prev_t:
            return False
        prev_e, prev_t = p.energy_pj, p.delay_ns
    return True
