"""Closed-form analytical energy objective (paper §IV.B–§IV.E, eqs. 10–33).

Evaluation is O(1): a fixed set of substitutions over d in {x,y,z} and the
five-level hierarchy, independent of problem size or tile counts.

The model is organized *receiver-centric* (paper §III.D): for each axis d the
residency chain (DRAM -> SRAM? -> regfile? -> MACC) determines the source of
every transfer; bypassed levels contribute zero accesses and shift load to
the nearest upper resident level, amortized by the PE-array multicast /
spatial-reduction factor L-hat_d^(2-3).

Conventions (all from the paper):
  * traffic unit = one word (one scalar of A/B/P),
  * normal x <-> B, normal y <-> A, normal z <-> P (the reduction axis),
  * timeloop accounting: no lower-level read energy on write-back to an upper
    level, PE-array fabric energy = 0 (eqs. 20–21), spatial-reduce adder
    energy = 0 (eq. 22),
  * reduction-axis boundary: at receiver p the ratio of 'read old partial'
    words to 'write back' words is rho_z^(src-p) = 1 - 1/L~_z^(src-p)
    (eqs. 13–16; the first step of an accumulation chain initializes from
    zero).
"""
from __future__ import annotations

import dataclasses

from .geometry import AXES, AXIS_INDEX, Gemm, Mapping
from .hardware import AcceleratorSpec

LEVEL_KEY = {0: "dram", 1: "sram", 3: "rf"}


@dataclasses.dataclass
class AccessCounts:
    """Word-granular access counts per memory level and direction."""

    dram_read: float = 0.0
    dram_write: float = 0.0
    sram_read: float = 0.0
    sram_write: float = 0.0
    rf_read: float = 0.0
    rf_write: float = 0.0
    macc: float = 0.0

    def add(self, level: int, direction: str, words: float) -> None:
        key = f"{LEVEL_KEY[level]}_{direction}"
        setattr(self, key, getattr(self, key) + words)

    def as_dict(self) -> dict[str, float]:
        return dataclasses.asdict(self)

    def energy(self, hw: AcceleratorSpec) -> float:
        """Total absolute energy in pJ under the ERT."""
        e = hw.ert
        return (self.dram_read * e.dram_read + self.dram_write * e.dram_write
                + self.sram_read * e.sram_read + self.sram_write * e.sram_write
                + self.rf_read * e.rf_read + self.rf_write * e.rf_write
                + self.macc * e.macc)

    def isclose(self, other: "AccessCounts", rel: float = 1e-9) -> bool:
        a, b = self.as_dict(), other.as_dict()
        return all(abs(a[k] - b[k]) <= rel * max(1.0, abs(a[k]), abs(b[k]))
                   for k in a)


@dataclasses.dataclass(frozen=True)
class EnergyBreakdown:
    """Normalized (per-MAC, eq. 24) energies by source term + totals (pJ)."""

    src1: float          # E^(src-1)/V : ... <-> SRAM          (eq. 25)
    src3: float          # E^(src-3)/V : ... <-> regfile       (eq. 26)
    src4: float          # E^(src-4)/V : ... <-> MACC          (eq. 27)
    compute: float       # e^MACC                              (eq. 28)
    leak: float          # eq. 30 — constant per hardware instance
    volume: int
    counts: AccessCounts

    @property
    def normalized(self) -> float:
        """Ē_total (eq. 33); leakage excluded (constant, see paper §IV.E5)."""
        return self.src1 + self.src3 + self.src4 + self.compute

    @property
    def total(self) -> float:
        return self.normalized * self.volume

    @property
    def total_with_leak(self) -> float:
        return (self.normalized + self.leak) * self.volume


def rho_terms(gemm: Gemm, m: Mapping) -> dict[str, float]:
    """Effective global z-column counts & boundary coefficients (eqs. 13–16)."""
    L0z, L1z, L2z = gemm.Lz, m.L1[2], m.L2[2]
    sz = m.L2[2] // m.L3[2]
    Lt1 = 1.0 if m.alpha01 == "z" else L0z / L1z                 # eq. 13
    Lt3 = (L0z / L1z) if m.alpha12 == "z" else (L0z / L2z)       # eq. 14
    Lt4 = L0z / sz                                               # eq. 15
    return {"src1": 1.0 - 1.0 / Lt1, "src3": 1.0 - 1.0 / Lt3,
            "src4": 1.0 - 1.0 / Lt4}                             # eq. 16


def _link_counts(counts: AccessCounts, axis: str, n_recv: float,
                 src_level: int, recv_level: int, rho_p: float,
                 multicast: float) -> None:
    """Account one receiver link: n_recv receiver-side words of axis-d data.

    Inputs (x,y): source read (amortized by multicast) + receiver write (if
    the receiver is storage).  Partial sums (z): every receiver-side update
    is written back up (source write, amortized — spatial reduction merges
    the z-lanes), and rho_p of them re-fetch the old value (source read,
    amortized + receiver write, per-lane).  Eqs. 17–23 + 25–27.
    """
    recv_is_storage = recv_level in (1, 3)
    if axis in ("x", "y"):
        counts.add(src_level, "read", n_recv / multicast)
        if recv_is_storage:
            counts.add(recv_level, "write", n_recv)
    else:  # z — the reduction axis
        counts.add(src_level, "write", n_recv / multicast)
        counts.add(src_level, "read", rho_p * n_recv / multicast)
        if recv_is_storage:
            counts.add(recv_level, "write", rho_p * n_recv)


def analytical_counts(gemm: Gemm, m: Mapping) -> AccessCounts:
    """Closed-form access counts (the N_d's of §IV.B weighted into levels)."""
    V = gemm.volume
    rho = rho_terms(gemm, m)
    spatial = m.spatial
    counts = AccessCounts(macc=float(V))

    for axis in AXES:
        d = AXIS_INDEX[axis]
        res1, res3 = m.res1[d], m.res3[d]
        s_d = spatial[d]

        # ---- src-1: DRAM <-> SRAM (eq. 10) -------------------------------
        if res1:
            denom = gemm.dims[d] if axis == m.alpha01 else m.L1[d]
            _link_counts(counts, axis, V / denom, src_level=0, recv_level=1,
                         rho_p=rho["src1"], multicast=1.0)

        # ---- src-3: (SRAM|DRAM) <-> regfile (eq. 11) ---------------------
        if res3:
            comp = (m.L1[d] // m.L2[d]) if axis == m.alpha12 else 1
            n3 = V / (m.L3[d] * comp)
            _link_counts(counts, axis, n3, src_level=1 if res1 else 0,
                         recv_level=3, rho_p=rho["src3"], multicast=s_d)

        # ---- src-4: (regfile|SRAM|DRAM) <-> MACC (eqs. 12, 27) -----------
        if res3:
            _link_counts(counts, axis, float(V), src_level=3, recv_level=4,
                         rho_p=rho["src4"], multicast=1.0)
        else:
            _link_counts(counts, axis, float(V), src_level=1 if res1 else 0,
                         recv_level=4, rho_p=rho["src4"], multicast=s_d)
    return counts


def analytical_energy(gemm: Gemm, m: Mapping,
                      hw: AcceleratorSpec) -> EnergyBreakdown:
    """The paper's closed-form objective; O(1) per evaluation.

    Term split (src1/src3/src4) recomputed alongside the flat counts so both
    views are available; they agree by construction.
    """
    V = gemm.volume
    rho = rho_terms(gemm, m)
    spatial = m.spatial
    ert = hw.ert

    def down(level, axis, rho_p):       # e_d^(p, down) — eqs. 17, 19, 23
        if axis in ("x", "y"):
            return ert.read(level)
        return ert.write(level) + rho_p * ert.read(level)

    def up(level, axis, rho_p):         # e_d^(p, up)   — eqs. 18, 22
        if axis in ("x", "y"):
            return ert.write(level)
        e = rho_p * ert.write(level)
        if level == 3:
            e += ert.spatial_reduce
        return e

    src1 = src3 = src4 = 0.0
    for axis in AXES:
        d = AXIS_INDEX[axis]
        res1, res3 = m.res1[d], m.res3[d]
        s_d = spatial[d]
        if res1:                                            # eq. 25
            denom = gemm.dims[d] if axis == m.alpha01 else m.L1[d]
            src1 += (down(0, axis, rho["src1"]) + up(1, axis, rho["src1"])) \
                / denom
        if res3:                                            # eq. 26
            comp = (m.L1[d] // m.L2[d]) if axis == m.alpha12 else 1
            src_lvl = 1 if res1 else 0
            src3 += (up(3, axis, rho["src3"])
                     + down(src_lvl, axis, rho["src3"]) / s_d) \
                / (m.L3[d] * comp)
        if res3:                                            # eq. 27
            src4 += down(3, axis, rho["src4"])
        else:
            src4 += down(1 if res1 else 0, axis, rho["src4"]) / s_d

    npe = m.num_pe_used
    leak = (ert.sram_leak + ert.rf_leak * npe) / npe        # eq. 30
    return EnergyBreakdown(src1=src1, src3=src3, src4=src4,
                           compute=ert.macc, leak=leak, volume=V,
                           counts=analytical_counts(gemm, m))


def energy(gemm: Gemm, m: Mapping, hw: AcceleratorSpec,
           *, include_leak: bool = False) -> float:
    """Absolute energy in pJ."""
    bd = analytical_energy(gemm, m, hw)
    return bd.total_with_leak if include_leak else bd.total


def closed_form_is_exact(gemm: Gemm, m: Mapping) -> bool:
    """True when the closed form provably equals full loop-nest reuse
    analysis (see DESIGN.md §3).  The closed form compresses temporal reuse
    only along each stage's walking axis; extra reuse appears exactly when
    (a/b) a stage's walking-axis trip count is 1 (the *effective* innermost
    loop differs), or (c) both non-walking trip counts of stage 1-2 are 1
    (reuse chains across the stage boundary).  These degenerate mappings are
    the analog of the paper's 0.74% timeloop-mismatch tail.
    """
    r01 = [gemm.dims[i] // m.L1[i] for i in range(3)]
    r12 = [m.L1[i] // m.L2[i] for i in range(3)]
    a01, a12 = AXIS_INDEX[m.alpha01], AXIS_INDEX[m.alpha12]
    if r01[a01] == 1 and any(r01[i] > 1 for i in range(3)):
        return False                                   # (a)
    if r12[a12] == 1 and any(r12[i] > 1 for i in range(3)):
        return False                                   # (b)
    others = [i for i in range(3) if i != a12]
    if all(r12[i] == 1 for i in others) and any(r01[i] > 1 for i in range(3)):
        return False                                   # (c)
    return True
