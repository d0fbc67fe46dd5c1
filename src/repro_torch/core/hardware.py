"""Accelerator templates + energy reference tables (paper §V-A2, Table I).

Accelergy/Timeloop are not available offline, so the per-access energies
below are Accelergy-style estimates (pJ per 8-bit word access, matching the
paper's int8 W/A instantiation).  Absolute values only scale the objective;
every algorithmic claim (optimality, fidelity closed-form vs. reference,
relative EDP ordering) is invariant to the constants.  Sources for orders of
magnitude: Eyeriss ISCA'16 energy table (DRAM ~200x RF), Accelergy 65/28/22nm
library scaling, HBM2 ~4 pJ/bit vs LPDDR4 ~20 pJ/bit vs DDR3 ~40 pJ/bit.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Ert:
    """Energy reference table: pJ per word access (word = 8 bit here)."""

    dram_read: float
    dram_write: float
    sram_read: float
    sram_write: float
    rf_read: float
    rf_write: float
    macc: float
    # per-cycle leakage (pJ/cycle) — constant wrt mapping (paper eq. 30)
    sram_leak: float = 0.0
    rf_leak: float = 0.0
    # spatial-reduction adder energy; timeloop default = 0 (paper eq. 22)
    spatial_reduce: float = 0.0
    # inter-chip interconnect (ICI/NVLink-class), pJ per 8-bit word moved
    # over one link hop.  Prices the mesh as one more memory level above
    # DRAM (Moon et al., arxiv 2106.10499): a ring collective charges each
    # moved word one link write (sender) + one link read (receiver).
    # Defaults of 0 keep single-chip objectives and stored-plan identities
    # for legacy ERTs unchanged (Ert(**json) round-trips).
    ici_read: float = 0.0
    ici_write: float = 0.0

    def read(self, level: int) -> float:
        return {0: self.dram_read, 1: self.sram_read, 3: self.rf_read}[level]

    def write(self, level: int) -> float:
        return {0: self.dram_write, 1: self.sram_write, 3: self.rf_write}[level]


@dataclasses.dataclass(frozen=True)
class AcceleratorSpec:
    """A spatial-accelerator instance of the Fig. 1 template."""

    name: str
    sram_words: int          # C^(1): global buffer capacity in words
    rf_words: int            # C^(3): per-PE regfile capacity in words
    num_pe: int              # spatial fanout (eq. 29 product)
    ert: Ert
    cycle_ns: float = 1.0    # for EDP delay term
    # mapping-space policy knobs
    allow_bypass: bool = True    # may the mapper search res1/res3?
    spatial_equality: bool = True  # eq. 29 as equality (100% PE util)
    # fixed spatial shape, e.g. TPU MXU = (128,128,1); None = free fanout
    fixed_spatial: tuple[int, int, int] | None = None

    def capacity(self, level: int) -> int:
        return {1: self.sram_words, 3: self.rf_words}[level]


def _kib_words(kib: float) -> int:
    return int(kib * 1024)  # 8-bit words


# --- the four paper templates (Table I) -----------------------------------

EYERISS_LIKE = AcceleratorSpec(
    name="eyeriss-like",
    sram_words=_kib_words(162), rf_words=424, num_pe=256,
    ert=Ert(dram_read=200.0, dram_write=200.0,
            sram_read=6.1, sram_write=6.8,
            rf_read=1.0, rf_write=1.0, macc=2.2,
            sram_leak=2.0e-1, rf_leak=4.0e-3,
            ici_read=420.0, ici_write=420.0),   # board-level serdes
    cycle_ns=5.0,  # 200 MHz, 65 nm
)

GEMMINI_LIKE = AcceleratorSpec(
    name="gemmini-like",
    sram_words=_kib_words(576), rf_words=1, num_pe=256,
    ert=Ert(dram_read=130.0, dram_write=130.0,
            sram_read=3.1, sram_write=3.4,
            rf_read=0.12, rf_write=0.12, macc=0.55,
            sram_leak=1.0e-1, rf_leak=1.0e-3,
            ici_read=280.0, ici_write=280.0),   # board-level serdes
    cycle_ns=1.0,  # 1 GHz, 22 nm
)

A100_LIKE = AcceleratorSpec(
    name="a100-like",
    sram_words=_kib_words(36864), rf_words=128, num_pe=65536,
    ert=Ert(dram_read=32.0, dram_write=32.0,     # HBM2 ~4 pJ/bit
            sram_read=1.1, sram_write=1.2,
            rf_read=0.06, rf_write=0.06, macc=0.12,
            sram_leak=8.0e-1, rf_leak=2.0e-4,
            ici_read=40.0, ici_write=40.0),     # NVLink ~10 pJ/bit
    cycle_ns=0.7,  # ~1.4 GHz, 7 nm
)

TPUV1_LIKE = AcceleratorSpec(
    name="tpuv1-like",
    sram_words=_kib_words(30720), rf_words=2, num_pe=65536,
    ert=Ert(dram_read=330.0, dram_write=330.0,   # DDR3
            sram_read=2.4, sram_write=2.6,
            rf_read=0.10, rf_write=0.10, macc=0.38,
            sram_leak=5.0e-1, rf_leak=5.0e-4,
            ici_read=700.0, ici_write=700.0),   # PCIe-gen3-class
    cycle_ns=1.4,  # 700 MHz, 28 nm
)

# --- TPU-v5e-like spec used by core/tpu_mapping.py to plan Pallas tiling ---
# HBM -> VMEM -> (MXU 128x128 systolic + accumulators).  The MXU is a
# hard-wired x*y spatial tile: fixed_spatial pins L-hat^(2-3) = (128,128,1).
# VMEM ~= 16 MiB/core is budgeted at 60% for mapper-managed operands (the
# rest: semaphores, double-buffering headroom, spills).
TPUV5E_LIKE = AcceleratorSpec(
    name="tpuv5e-like",
    sram_words=int(16 * 1024 * 1024 * 0.6),   # VMEM words (int8)
    rf_words=512,                             # accumulator VREG budget / lane
    num_pe=128 * 128,
    ert=Ert(dram_read=18.0, dram_write=18.0,  # HBM2e-class
            sram_read=0.9, sram_write=1.0,
            rf_read=0.04, rf_write=0.04, macc=0.08,
            ici_read=22.0, ici_write=22.0),   # ICI ~5.5 pJ/bit
    cycle_ns=1.0 / 0.94,                      # 940 MHz
    allow_bypass=False,        # Mosaic always stages through VMEM
    fixed_spatial=(128, 128, 1),
)

TEMPLATES: dict[str, AcceleratorSpec] = {
    s.name: s for s in
    (EYERISS_LIKE, GEMMINI_LIKE, A100_LIKE, TPUV1_LIKE, TPUV5E_LIKE)
}

EDGE_TEMPLATES = ("eyeriss-like", "gemmini-like")
CENTER_TEMPLATES = ("a100-like", "tpuv1-like")


# --- per-level bandwidths (words/cycle) for the exact latency model --------
# Deliberately NOT fields of AcceleratorSpec/Ert: the planner's
# content-addressed plan keys hash the full spec (`_hw_identity`), so
# adding fields there would silently re-key every stored plan.  Bandwidth
# enters only the *evaluation* side (core/edp.latency) and the Pareto
# plan-store section, which keys it explicitly.  Unknown specs (DSE
# sweeps, tests that synthesize hardware) default to infinite bandwidth,
# i.e. the historical compute-only delay bound.

@dataclasses.dataclass(frozen=True)
class Bandwidth:
    """Sustained words/cycle per memory level (word = 8 bit, as the ERT).

    ``dram`` and ``sram`` are chip-wide shared-port rates; ``rf`` is
    *per-PE* (each PE owns its regfile ports, so aggregate RF bandwidth
    scales with the mapping's spatial product).  ``inf`` = never the
    bottleneck, recovering the compute-only delay lower bound."""

    dram: float = float("inf")
    sram: float = float("inf")
    rf: float = float("inf")

    def as_tuple(self) -> tuple[float, float, float]:
        return (self.dram, self.sram, self.rf)


INFINITE_BANDWIDTH = Bandwidth()

# Order-of-magnitude sustained rates (bus bytes/s ÷ clock), same spirit as
# the ERT constants: absolute values scale the delay term, relative
# ordering across levels is what the latency model exercises.  Calibration
# (obs/calibrate.py) refines these per deployment from measured rows.
BANDWIDTHS: dict[str, Bandwidth] = {
    # 64-bit LPDDR bus @ 200 MHz core clock
    "eyeriss-like": Bandwidth(dram=8.0, sram=64.0, rf=2.0),
    # DDR4-class bus @ 1 GHz
    "gemmini-like": Bandwidth(dram=16.0, sram=64.0, rf=2.0),
    # HBM2 ~1.5 TB/s @ 1.4 GHz ~= 1100 B/cycle
    "a100-like": Bandwidth(dram=1024.0, sram=16384.0, rf=2.0),
    # DDR3 ~34 GB/s @ 700 MHz ~= 48 B/cycle
    "tpuv1-like": Bandwidth(dram=48.0, sram=8192.0, rf=2.0),
    # HBM2e ~820 GB/s @ 940 MHz ~= 870 B/cycle
    "tpuv5e-like": Bandwidth(dram=896.0, sram=8192.0, rf=4.0),
}


def bandwidth_for(hw: AcceleratorSpec,
                  overrides: dict[str, Bandwidth] | None = None) -> Bandwidth:
    """Bandwidth table entry for a spec, by name; infinite when unknown."""
    if overrides is not None and hw.name in overrides:
        return overrides[hw.name]
    return BANDWIDTHS.get(hw.name, INFINITE_BANDWIDTH)
