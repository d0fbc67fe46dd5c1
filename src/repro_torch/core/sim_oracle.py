"""Literal event-driven mapping simulator (ground-truth oracle, tiny GEMMs).

Executes the 5-level tiled loop nest *step by step*, maintaining per-level
resident-tile state for every datatype and counting each word moved, under
exactly the accounting conventions of the paper / timeloop (see energy.py).
It shares no formulas with the closed-form model or the loop-nest reference
model — counts emerge from simulated state transitions:

  * stage 0-1 temporal loops move the SRAM tile over the grid (non-walking
    axes outer in canonical order, walking axis alpha01 innermost),
  * stage 1-2 temporal loops move the PE-array tile within the SRAM tile
    (alpha12 innermost),
  * stage 2-3 is spatial: s = L2/L3 lanes execute concurrently; lanes that
    differ only along a datatype's normal axis share its words (multicast
    for inputs, spatial reduction for partial sums) — source-side accesses
    are amortized by s_d,
  * inputs (A, B) are delivered on resident-tile change: source read +
    receiver write per word,
  * partial sums (P) follow read-modify-write chains: every eviction writes
    the tile up to its source level; every re-residency re-fetches the old
    value (source read + receiver write) UNLESS it is the first touch of
    that word slot (accumulation starts from zero),
  * the MACC consumes one A and B word and updates one P word per MAC from
    the nearest resident level of each axis.

Intended for small grids (V up to ~1e5 MACs); tests and the fidelity
benchmark use it as the judge for both analytical models.
"""
from __future__ import annotations

import itertools

from .energy import AccessCounts
from .geometry import AXES, AXIS_INDEX, Gemm, Mapping


def _stage_positions(trips: tuple[int, int, int], walk: str):
    """Iteration positions of one temporal stage: non-walking axes outer in
    canonical (x,y,z) order, walking axis innermost."""
    w = AXIS_INDEX[walk]
    outer = [i for i in range(3) if i != w]
    order = outer + [w]  # outer -> inner
    for idx in itertools.product(*(range(trips[i]) for i in order)):
        pos = [0, 0, 0]
        for axis_i, v in zip(order, idx):
            pos[axis_i] = v
        yield tuple(pos)


def _proj(pos: tuple[int, int, int], axis_i: int) -> tuple[int, int]:
    """Drop the normal axis: the projected tile id of datatype axis_i."""
    return tuple(p for i, p in enumerate(pos) if i != axis_i)


def simulate_counts(gemm: Gemm, m: Mapping) -> AccessCounts:
    m.validate(gemm)
    counts = AccessCounts(macc=float(gemm.volume))
    L0, L1, L2, L3 = gemm.dims, m.L1, m.L2, m.L3
    r01 = tuple(L0[i] // L1[i] for i in range(3))
    r12 = tuple(L1[i] // L2[i] for i in range(3))
    s = tuple(L2[i] // L3[i] for i in range(3))
    lanes = list(itertools.product(range(s[0]), range(s[1]), range(s[2])))

    fp1 = [L1[(i + 1) % 3] * L1[(i + 2) % 3] for i in range(3)]  # SRAM proj
    fp3 = [L3[(i + 1) % 3] * L3[(i + 2) % 3] for i in range(3)]  # RF proj

    # per-axis source level for the regfile and for the MACC
    rf_src = [1 if m.res1[i] else 0 for i in range(3)]
    macc_src = [3 if m.res3[i] else (1 if m.res1[i] else 0) for i in range(3)]

    sram_tile: list[tuple | None] = [None, None, None]
    rf_tile: dict[tuple[int, tuple], tuple | None] = {
        (i, lane): None for i in range(3) for lane in lanes}
    touched_sram_p: set[tuple] = set()
    touched_rf_p: set[tuple] = set()
    touched_macc_p: set[tuple] = set()

    def sram_event(axis_i: int, new_id: tuple) -> None:
        """SRAM resident tile of datatype axis_i becomes new_id."""
        old = sram_tile[axis_i]
        if old == new_id:
            return
        fp = float(fp1[axis_i])
        if axis_i != 2:  # inputs A/B
            counts.add(0, "read", fp)
            counts.add(1, "write", fp)
        else:            # partial sums
            if old is not None:
                counts.add(0, "write", fp)           # evict old partials
            if new_id in touched_sram_p:             # resume a chain
                counts.add(0, "read", fp)
                counts.add(1, "write", fp)
            touched_sram_p.add(new_id)
        sram_tile[axis_i] = new_id

    def rf_event(axis_i: int, lane: tuple, new_id: tuple) -> None:
        """Lane's RF resident tile of datatype axis_i becomes new_id.

        Source-side accesses are amortized by s_d: the s_d lanes differing
        only along the normal axis share the same words (multicast in,
        spatial reduction out)."""
        key = (axis_i, lane)
        old = rf_tile[key]
        if old == new_id:
            return
        fp = float(fp3[axis_i])
        src = rf_src[axis_i]
        amort = s[axis_i]
        if axis_i != 2:
            counts.add(src, "read", fp / amort)
            counts.add(3, "write", fp)
        else:
            lz = lane[2]
            if old is not None:
                counts.add(src, "write", fp / amort)
            tkey = new_id + (lz,)
            if tkey in touched_rf_p:
                counts.add(src, "read", fp / amort)
                counts.add(3, "write", fp)
            touched_rf_p.add(tkey)
        rf_tile[key] = new_id

    # ---- MACC-side input consumption: one word per MAC per operand -------
    V = float(gemm.volume)
    for axis_i in (0, 1):
        src = macc_src[axis_i]
        if src == 3:
            counts.add(3, "read", V)
        else:
            counts.add(src, "read", V / s[axis_i])

    # ---- main traversal ---------------------------------------------------
    for t1 in _stage_positions(r01, m.alpha01):
        for axis_i in range(3):
            if m.res1[axis_i]:
                sram_event(axis_i, _proj(t1, axis_i))
        for t2 in _stage_positions(r12, m.alpha12):
            # absolute PE-array tile position in L2 units
            arr = tuple(t1[i] * r12[i] + t2[i] for i in range(3))
            for lane in lanes:
                # absolute regfile tile position in L3 units
                pos3 = tuple(arr[i] * s[i] + lane[i] for i in range(3))
                for axis_i in range(3):
                    if m.res3[axis_i]:
                        rf_event(axis_i, lane, _proj(pos3, axis_i))
                # ---- MACC-level partial-sum chain (axis z) ---------------
                src = macc_src[2]
                amort = 1.0 if src == 3 else float(s[2])
                lz = lane[2]
                for ox in range(L3[0]):
                    ax = pos3[0] * L3[0] + ox
                    for oy in range(L3[1]):
                        ay = pos3[1] * L3[1] + oy
                        nz = L3[2]
                        counts.add(src, "write", nz / amort)
                        mkey = (ax, ay, lz)
                        reads = nz if mkey in touched_macc_p else nz - 1
                        touched_macc_p.add(mkey)
                        if reads:
                            counts.add(src, "read", reads / amort)

    # ---- final flush of partial sums --------------------------------------
    if m.res3[2]:
        for lane in lanes:
            if rf_tile[(2, lane)] is not None:
                counts.add(rf_src[2], "write", float(fp3[2]) / s[2])
    if m.res1[2] and sram_tile[2] is not None:
        counts.add(0, "write", float(fp1[2]))
    return counts
