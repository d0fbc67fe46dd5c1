"""Energy-delay evaluation (paper §V-A4, eqs. 35–37) + exact latency model.

Following the paper, a *unified oracle* — the loop-nest reference model
(our timeloop-model stand-in) — reports E, T and EDP for every mapper,
GOMA included.  T is the roofline maximum over

  * compute:  V / num_pe_used cycles (eq. 29 ⇒ GOMA mappings reach 100%
    PE utilization; baselines that under-fill the array pay
    proportionally), and
  * each memory level's traffic over its sustained bandwidth
    (``hardware.Bandwidth``, words/cycle; DRAM and SRAM are chip-wide
    shared ports, regfiles are per-PE so their aggregate rate scales
    with the spatial product).

Specs without a bandwidth table entry get infinite bandwidth, which
recovers the historical compute-only lower bound exactly.  Leakage burns
on the whole chip for the full (stall-inclusive) duration regardless of
utilization.

Aggregation semantics (``EdpReport.aggregate``): a case is a *sequential
schedule* of its member GEMMs, so energy and delay are occurrence-
weighted sums and the case EDP is derived as the product
``(Σ w·E) · (Σ w·T)`` — the report is self-consistent by construction.
The paper's per-GEMM Σ w·EDPᵢ (eq. 35, the Table II scalar) is kept
under the distinct name ``weighted_edp_sum``.
"""
from __future__ import annotations

import dataclasses

from .energy import AccessCounts
from .geometry import Gemm, Mapping
from .hardware import AcceleratorSpec, Bandwidth, bandwidth_for
from .timeloop_ref import reference_counts


@dataclasses.dataclass(frozen=True)
class LatencyBreakdown:
    """Per-term roofline decomposition of one mapping's delay."""

    compute_cycles: float
    dram_cycles: float
    sram_cycles: float
    rf_cycles: float
    cycle_ns: float

    @property
    def cycles(self) -> float:
        return max(self.compute_cycles, self.dram_cycles,
                   self.sram_cycles, self.rf_cycles)

    @property
    def delay_ns(self) -> float:
        return self.cycles * self.cycle_ns

    @property
    def bound(self) -> str:
        """Which term is binding ("compute"|"dram"|"sram"|"rf")."""
        terms = {"compute": self.compute_cycles, "dram": self.dram_cycles,
                 "sram": self.sram_cycles, "rf": self.rf_cycles}
        # deterministic: first max in the fixed level order above
        return max(terms, key=lambda k: (terms[k],))

    def as_dict(self) -> dict[str, float]:
        return {"compute_cycles": self.compute_cycles,
                "dram_cycles": self.dram_cycles,
                "sram_cycles": self.sram_cycles,
                "rf_cycles": self.rf_cycles,
                "cycles": self.cycles, "delay_ns": self.delay_ns}


def latency(gemm: Gemm, m: Mapping, hw: AcceleratorSpec,
            *, counts: AccessCounts | None = None,
            bw: Bandwidth | None = None) -> LatencyBreakdown:
    """Exact per-mapping latency: max(compute, per-level traffic/bw).

    ``counts`` defaults to the loop-nest reference counts (the oracle);
    pass ``analytical_counts`` output for the closed-form variant — the
    two agree wherever ``closed_form_is_exact`` holds."""
    if counts is None:
        counts = reference_counts(gemm, m, full_reuse=True)
    if bw is None:
        bw = bandwidth_for(hw)
    npe_used = m.num_pe_used
    return LatencyBreakdown(
        compute_cycles=gemm.volume / npe_used,
        dram_cycles=(counts.dram_read + counts.dram_write) / bw.dram,
        sram_cycles=(counts.sram_read + counts.sram_write) / bw.sram,
        rf_cycles=(counts.rf_read + counts.rf_write) / (bw.rf * npe_used),
        cycle_ns=hw.cycle_ns)


def delay_ns(gemm: Gemm, m: Mapping, hw: AcceleratorSpec,
             *, counts: AccessCounts | None = None,
             bw: Bandwidth | None = None) -> float:
    return latency(gemm, m, hw, counts=counts, bw=bw).delay_ns


@dataclasses.dataclass(frozen=True)
class EdpReport:
    energy_pj: float
    delay_ns: float
    edp: float                    # J * s == energy_pj*1e-12 * delay_ns*1e-9
    # spatial product of the underlying mapping; None on aggregated
    # reports (a case mixes mappings — there is no single meaningful PE
    # count, and the old 0 sentinel let consumers divide by it)
    num_pe_used: int | None
    cycles: float
    # paper eq. 35: occurrence-weighted Σ w·EDPᵢ over the member GEMMs
    # (the Table II scalar).  None on per-mapping reports.
    weighted_edp_sum: float | None = None

    @property
    def is_aggregate(self) -> bool:
        return self.num_pe_used is None

    @staticmethod
    def aggregate(parts: list[tuple["EdpReport", int]]) -> "EdpReport":
        """Occurrence-count-weighted case aggregation.

        Semantics: the case runs its member GEMMs *sequentially*, so
        energy/delay/cycles sum and ``edp`` is their product — the
        aggregate satisfies the same ``edp == E·T`` identity as a
        per-mapping report.  The paper's Σ w·EDPᵢ (eq. 35) is reported
        separately as ``weighted_edp_sum``."""
        e = sum(p.energy_pj * w for p, w in parts)
        t = sum(p.delay_ns * w for p, w in parts)
        cyc = sum(p.cycles * w for p, w in parts)
        wsum = sum(p.edp * w for p, w in parts)
        return EdpReport(energy_pj=e, delay_ns=t,
                         edp=(e * 1e-12) * (t * 1e-9),
                         num_pe_used=None, cycles=cyc,
                         weighted_edp_sum=wsum)


def evaluate(gemm: Gemm, m: Mapping, hw: AcceleratorSpec,
             *, counts: AccessCounts | None = None,
             bw: Bandwidth | None = None) -> EdpReport:
    """Oracle E / T / EDP for one mapping (bandwidth-aware delay)."""
    if counts is None:
        counts = reference_counts(gemm, m, full_reuse=True)
    lat = latency(gemm, m, hw, counts=counts, bw=bw)
    cycles = lat.cycles
    t_ns = lat.delay_ns
    # leakage burns for the full stall-inclusive duration (eq. 30)
    leak_pj = (hw.ert.sram_leak + hw.ert.rf_leak * hw.num_pe) * cycles
    e_pj = counts.energy(hw) + leak_pj
    edp = (e_pj * 1e-12) * (t_ns * 1e-9)
    return EdpReport(energy_pj=e_pj, delay_ns=t_ns, edp=edp,
                     num_pe_used=m.num_pe_used, cycles=cycles)
