"""Optimality certificate (paper §IV-G2).

The exact branch-and-bound solver terminates only when every node of the
search tree has either been explored or pruned by a *sound* lower bound, so
at termination UB (best feasible objective) equals LB (proved bound over all
unexplored nodes) and the gap is 0.  The certificate records the proof
artifacts and can be independently re-verified:

  * the mapping's objective is recomputed with the scalar closed-form
    evaluator (a different code path from the solver's vectorized one),
  * all hardware/mapping constraints are re-checked,
  * on small instances, `verify_by_enumeration` replays the entire feasible
    space and confirms no better mapping exists.
"""
from __future__ import annotations

import dataclasses

from .energy import analytical_energy
from .geometry import Gemm, Mapping, enumerate_mappings, mapping_space_size
from .hardware import AcceleratorSpec


def objective_value(gemm: Gemm, m: Mapping, hw: AcceleratorSpec,
                    kind: str) -> float:
    """The solver's minimized scalar for a mapping.

    "energy": normalized Ē (eq. 33) plus the per-MAC leakage (eq. 30 —
    leakage burns on the whole chip for V/num_pe_used cycles, so it varies
    with the spatial product when eq. 29 is relaxed to <=).
    "edp": the same divided by num_pe_used, which orders mappings
    identically to EDP = E*T (T ∝ V / num_pe_used)."""
    npe_used = m.num_pe_used
    leak_cycle = hw.ert.sram_leak + hw.ert.rf_leak * hw.num_pe
    e = (analytical_energy(gemm, m, hw).normalized
         + leak_cycle / npe_used)
    if kind == "energy":
        return e
    if kind == "edp":
        return e / npe_used
    raise ValueError(f"unknown objective kind {kind!r}")


@dataclasses.dataclass
class Certificate:
    gemm: Gemm
    hw_name: str
    mapping: Mapping | None
    objective: float              # minimized scalar (see objective_value)
    upper_bound: float
    lower_bound: float
    nodes_explored: int
    nodes_pruned: int
    combos_skipped: int           # discrete combos eliminated by bound
    space_size: int               # |mapping space| before constraints
    solve_time_s: float
    spatial_mode: str             # "equality" | "le" | "fixed"
    feasible: bool
    objective_kind: str = "energy"
    warm_started: bool = False    # branch-and-bound seeded with a cached UB
    # which search engine produced this certificate ("vectorized" frontier
    # engine or the "reference" DFS); pre-engine artifacts default to
    # "reference", which is what they were solved with
    engine: str = "reference"
    # True when solve() hit its time budget (anytime mode): the mapping is
    # the best *incumbent* and lower_bound is a proven global bound — the
    # recorded gap upper-bounds the distance to the unknown optimum.
    # Zero-gap certificates keep the default False.
    bounded: bool = False

    @property
    def gap(self) -> float:
        if self.upper_bound == float("inf"):
            return float("inf")
        return self.upper_bound - self.lower_bound

    def summary(self) -> str:
        return (f"[certificate] {self.hw_name} x {self.gemm.name or self.gemm.dims}: "
                f"obj={self.objective:.6g} pJ/MAC  UB={self.upper_bound:.6g} "
                f"LB={self.lower_bound:.6g} gap={self.gap:.3g}  "
                f"nodes={self.nodes_explored} pruned={self.nodes_pruned} "
                f"combos_skipped={self.combos_skipped} "
                f"space={self.space_size:.3g} t={self.solve_time_s:.3f}s "
                f"mode={self.spatial_mode} engine={self.engine}"
                + (" BOUNDED" if self.bounded else ""))


def effective_spatial_mode(hw: AcceleratorSpec,
                           spatial_mode: str | None = None) -> str:
    """The spatial mode a solve on ``hw`` actually enforces: fixed
    spatial tiles check as equality; otherwise an explicit mode wins
    over the spec's ``spatial_equality`` default.  (The one shared
    definition — solver, planner and chain verification must agree.)"""
    if hw.fixed_spatial is not None:
        return "equality"
    if spatial_mode is not None:
        return spatial_mode
    return "equality" if hw.spatial_equality else "le"


def check_constraints(gemm: Gemm, m: Mapping, hw: AcceleratorSpec,
                      *, spatial_mode: str = "equality") -> bool:
    """Hardware + mapping feasibility (paper eqs. 4, 29, 31, 32)."""
    try:
        m.validate(gemm)
    except ValueError:
        return False
    l1, l3 = m.L1, m.L3
    rf = (m.res3[1] * l3[0] * l3[2]      # A (normal y): x-z footprint
          + m.res3[0] * l3[1] * l3[2]    # B (normal x): y-z footprint
          + m.res3[2] * l3[0] * l3[1])   # P (normal z): x-y footprint
    if rf > hw.rf_words:
        return False
    sram = (m.res1[1] * l1[0] * l1[2] + m.res1[0] * l1[1] * l1[2]
            + m.res1[2] * l1[0] * l1[1])
    if sram > hw.sram_words:
        return False
    if hw.fixed_spatial is not None:
        return m.spatial == hw.fixed_spatial
    npe = m.num_pe_used
    if spatial_mode == "equality":
        return npe == hw.num_pe
    return npe <= hw.num_pe


def verify(cert: Certificate, hw: AcceleratorSpec,
           *, rel_tol: float = 1e-9) -> bool:
    """Independent re-check of the returned solution (not of optimality)."""
    if not cert.feasible:
        return cert.mapping is None
    m = cert.mapping
    if m is None:
        return False
    if not check_constraints(cert.gemm, m, hw, spatial_mode=cert.spatial_mode
                             if cert.spatial_mode != "fixed" else "equality"):
        return False
    obj = objective_value(cert.gemm, m, hw, cert.objective_kind)
    ok_obj = abs(obj - cert.objective) <= rel_tol * max(1.0, abs(obj))
    if cert.bounded:
        # anytime incumbent: the gap is a *claim* (LB <= optimum <= UB),
        # not a contradiction — require only internal consistency
        return (ok_obj and cert.gap >= -rel_tol * max(1.0, abs(obj))
                and cert.upper_bound <= cert.objective
                + rel_tol * max(1.0, abs(obj)))
    return ok_obj and cert.gap <= rel_tol * max(1.0, abs(cert.objective))


def verify_by_enumeration(cert: Certificate, hw: AcceleratorSpec,
                          *, max_space: int = 3_000_000) -> bool:
    """Brute-force optimality check for small instances (tests)."""
    gemm = cert.gemm
    if mapping_space_size(gemm, search_bypass=hw.allow_bypass) > max_space:
        raise ValueError("instance too large for enumeration")
    mode = cert.spatial_mode if cert.spatial_mode != "fixed" else "equality"
    best, best_m = float("inf"), None
    for m in enumerate_mappings(gemm, search_bypass=hw.allow_bypass):
        if not check_constraints(gemm, m, hw, spatial_mode=mode):
            continue
        e = objective_value(gemm, m, hw, cert.objective_kind)
        if e < best:
            best, best_m = e, m
    if best_m is None:
        return not cert.feasible
    return (cert.feasible
            and abs(best - cert.objective) <= 1e-9 * max(1.0, best))
