"""Loop-nest reuse-analysis reference model (the paper's proxy oracle).

Timeloop/Accelergy are not available offline; this module re-implements the
*computation timeloop-model performs* — generic loop-nest reuse analysis —
sharing no formulas with the closed-form model in ``energy.py``:

  * the mapping is expanded into an explicit temporal loop nest
    (stage 0-1 then stage 1-2; non-walking axes outer in canonical order,
    walking axis innermost) plus the spatial stage 2-3,
  * deliveries into a storage level for a datatype are
    ``footprint x product of trip counts of the loops outside that level``,
    compressed by the *leading consecutive irrelevant* loops (scanning from
    the innermost loop outward, loops over the datatype's normal axis — and
    trip-count-1 loops, which are transparent — are skipped until the first
    relevant loop; everything outer multiplies: interleaved relevant
    iterations evict the tile),
  * partial sums additionally distinguish first-touch (accumulation chains
    initialize from zero): reads-of-old = write-backs - distinct word slots,
  * multicast / spatial reduction amortize source-side accesses by s_d.

With ``full_reuse=True`` (default) this is the timeloop-equivalent analysis:
it exploits trip-1 transparency and cross-stage reuse that GOMA's closed
form deliberately folds away, reproducing the paper's ~0.7% mismatch tail.
With ``full_reuse=False`` the compression is restricted to exactly the
stage walking axis — the closed form's semantics — giving an independent
derivation that must match ``analytical_counts`` bit-for-bit on every
mapping (tested).
"""
from __future__ import annotations

import dataclasses

from .energy import AccessCounts
from .geometry import AXES, AXIS_INDEX, Gemm, Mapping
from .hardware import AcceleratorSpec


@dataclasses.dataclass(frozen=True)
class _Loop:
    axis: int      # 0=x, 1=y, 2=z
    trips: int
    stage: int     # 0 = stage 0-1, 1 = stage 1-2
    is_walk: bool  # is this its stage's walking axis?


def _stage_loops(trips: tuple[int, int, int], walk: str,
                 stage: int) -> list[_Loop]:
    w = AXIS_INDEX[walk]
    outer = [i for i in range(3) if i != w]
    return ([_Loop(i, trips[i], stage, False) for i in outer]
            + [_Loop(w, trips[w], stage, True)])


def _deliveries(loops_outside: list[_Loop], axis_i: int,
                full_reuse: bool) -> int:
    """Number of tile versions delivered to a level whose outside temporal
    nest is ``loops_outside`` (outer -> inner), for the datatype with normal
    ``axis_i``.  See module docstring for the two compression modes."""
    mult = 1
    scanning = True
    for lp in reversed(loops_outside):          # innermost outward
        if scanning:
            if full_reuse:
                if lp.axis == axis_i or lp.trips == 1:
                    continue                     # transparent / reused
                scanning = False
            else:
                # closed-form semantics: compress only the stage walking
                # axis itself, then stop scanning at the stage boundary.
                if lp.is_walk and lp.axis == axis_i:
                    continue
                scanning = False
        mult *= lp.trips
    return mult


def reference_counts(gemm: Gemm, m: Mapping,
                     *, full_reuse: bool = True) -> AccessCounts:
    m.validate(gemm)
    V = float(gemm.volume)
    L0, L1, L2, L3 = gemm.dims, m.L1, m.L2, m.L3
    r01 = tuple(L0[i] // L1[i] for i in range(3))
    r12 = tuple(L1[i] // L2[i] for i in range(3))
    s = tuple(L2[i] // L3[i] for i in range(3))
    num_lanes = s[0] * s[1] * s[2]

    loops01 = _stage_loops(r01, m.alpha01, 0)
    loops12 = _stage_loops(r12, m.alpha12, 1)

    fp1 = [L1[(i + 1) % 3] * L1[(i + 2) % 3] for i in range(3)]
    fp3 = [L3[(i + 1) % 3] * L3[(i + 2) % 3] for i in range(3)]

    counts = AccessCounts(macc=V)
    rf_src = [1 if m.res1[i] else 0 for i in range(3)]
    macc_src = [3 if m.res3[i] else (1 if m.res1[i] else 0) for i in range(3)]

    for axis_i in range(3):
        is_p = axis_i == 2
        s_d = s[axis_i]

        # ---- receiver: SRAM (loops outside = stage 0-1) -------------------
        if m.res1[axis_i]:
            versions = _deliveries(loops01, axis_i, full_reuse)
            words = versions * fp1[axis_i]
            if not is_p:
                counts.add(0, "read", words)
                counts.add(1, "write", words)
            else:
                first = float(gemm.Lx * gemm.Ly)     # distinct P words
                counts.add(0, "write", words)        # every eviction
                counts.add(0, "read", words - first)  # resumes re-fetch
                counts.add(1, "write", words - first)

        # ---- receiver: regfile (outside = stage 0-1 + 1-2, per lane) ------
        if m.res3[axis_i]:
            versions = _deliveries(loops01 + loops12, axis_i, full_reuse)
            words = versions * fp3[axis_i] * num_lanes
            src = rf_src[axis_i]
            if not is_p:
                counts.add(src, "read", words / s_d)
                counts.add(3, "write", words)
            else:
                first = float(gemm.Lx * gemm.Ly * s[2])  # per z-lane slot
                counts.add(src, "write", words / s_d)
                counts.add(src, "read", (words - first) / s_d)
                counts.add(3, "write", words - first)

        # ---- receiver: MACC (one word per MAC; order-independent) ---------
        src = macc_src[axis_i]
        amort = 1.0 if src == 3 else float(s_d)
        if not is_p:
            counts.add(src, "read", V / amort)
        else:
            first = float(gemm.Lx * gemm.Ly * s[2])
            counts.add(src, "write", V / amort)
            counts.add(src, "read", (V - first) / amort)
    return counts


def reference_energy(gemm: Gemm, m: Mapping, hw: AcceleratorSpec,
                     *, full_reuse: bool = True) -> float:
    """Absolute energy in pJ under the reference reuse analysis."""
    return reference_counts(gemm, m, full_reuse=full_reuse).energy(hw)
