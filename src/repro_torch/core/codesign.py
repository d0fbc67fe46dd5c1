"""BEYOND-PAPER: hardware/mapping co-design search on top of GOMA.

The paper's conclusion names "software-hardware co-optimization search"
as the capability its fast global solver unlocks — this module implements
it.  Because one (GEMM, hardware) solve takes ~0.1 s with a provable
optimum, an *outer* sweep over hardware parameters (PE count, SRAM size,
regfile size) is exact per point: no mapper noise contaminates the
hardware comparison, which is precisely the paper's §V-B2 argument about
heuristic instability, applied to DSE.

Cost proxies (documented, deliberately simple):
  area  ~ num_pe * (macc_area + rf_words * sram_bit_area * 8)
          + sram_words * sram_bit_area * 8
  EDP   = from the usual oracle evaluation of the per-point optimum.

Returns the swept grid with per-point optima and the Pareto frontier of
(area, workload EDP).
"""
from __future__ import annotations

import dataclasses

from .edp import evaluate
from .hardware import AcceleratorSpec
from .pareto import pareto_min
from .solver import solve
from .workloads import LlmSpec, prefill_gemms

# area proxies (arbitrary units; relative comparisons only)
MACC_AREA = 32.0
SRAM_BIT_AREA = 1.0
RF_BIT_AREA = 2.0          # regfiles are flop-based: costlier per bit


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    num_pe: int
    sram_words: int
    rf_words: int
    area: float
    edp: float               # occurrence-weighted workload EDP (J*s)
    energy_pj: float
    feasible: bool

    @property
    def edp_area(self) -> float:
        return self.edp * self.area


def area_proxy(num_pe: int, sram_words: int, rf_words: int) -> float:
    return (num_pe * (MACC_AREA + rf_words * 8 * RF_BIT_AREA)
            + sram_words * 8 * SRAM_BIT_AREA)


def evaluate_design(base: AcceleratorSpec, num_pe: int, sram_words: int,
                    rf_words: int, workload: list) -> DesignPoint:
    """Solve the whole workload on one hardware instance; exact per-GEMM
    optima (objective='edp' so under-filled arrays are handled)."""
    hw = dataclasses.replace(base, name=f"dse_{num_pe}_{sram_words}_"
                             f"{rf_words}", num_pe=num_pe,
                             sram_words=sram_words, rf_words=rf_words)
    total_edp = total_e = 0.0
    for _, gemm, w in workload:
        res = solve(gemm, hw, objective="edp", spatial_mode="le")
        if res.mapping is None:
            return DesignPoint(num_pe, sram_words, rf_words,
                               area_proxy(num_pe, sram_words, rf_words),
                               float("inf"), float("inf"), False)
        rep = evaluate(gemm, res.mapping, hw)
        total_edp += w * rep.edp
        total_e += w * rep.energy_pj
    return DesignPoint(num_pe, sram_words, rf_words,
                       area_proxy(num_pe, sram_words, rf_words),
                       total_edp, total_e, True)


def sweep(base: AcceleratorSpec, model: LlmSpec, seq: int, *,
          pe_opts=(64, 256, 1024), sram_kib_opts=(64, 162, 512),
          rf_opts=(64, 424, 1024)) -> list[DesignPoint]:
    workload = prefill_gemms(model, seq)
    points = []
    for npe in pe_opts:
        for skib in sram_kib_opts:
            for rf in rf_opts:
                points.append(evaluate_design(
                    base, npe, skib * 1024, rf, workload))
    return points


def pareto_frontier(points: list[DesignPoint]) -> list[DesignPoint]:
    """Non-dominated set under (area ↓, edp ↓).

    Deterministic tie rule via the shared ``core.pareto.pareto_min``
    filter: among equal-EDP designs the smaller-area one survives, and
    exact (area, edp) duplicates collapse onto the lexicographically
    smallest (num_pe, sram, rf) configuration — independent of input
    order (the old ``edp < best - 1e-18`` strict test dropped equal-EDP
    points nondeterministically)."""
    return pareto_min([p for p in points if p.feasible],
                      key_a=lambda p: p.area, key_b=lambda p: p.edp,
                      tie=lambda p: (p.num_pe, p.sram_words, p.rf_words))
