"""GOMA exact solver: globally optimal mapping via branch-and-bound.

Implements the integer optimization of paper eq. 34.  Gurobi is unavailable
offline, so optimality is established by our own exhaustive-with-sound-
pruning search (a *stronger* artifact: the certificate is produced by
first-principles bounding, not a black-box solver).

Structure exploited (see DESIGN.md §3):
  * For fixed discrete choices (alpha01, alpha12, res1, res3) the objective
    separates per axis:  Ē = Σ_d g_d(chain_d).  Per-axis energies for ALL
    divisor chains are evaluated at once with numpy (the closed form is O(1)
    per chain).  Only 16 variant keys (walk01?, walk12?, res1, res3) exist
    per axis, so the 576 discrete combos share 48 precomputed arrays —
    and because the arrays depend only on (axis extent, ERT, variant key,
    fixed-spatial mask), they are memoized *across* solves in a
    process-level cache (`_AXIS_MEMO`): scenario batches whose shapes share
    d_model/d_ff axes compute each axis once per model, not once per GEMM.
  * Coupling across axes is only (a) the PE-count product constraint
    (eq. 29) and (b) the two bilinear capacity constraints (eqs. 31–32).
    We enumerate spatial fanout triples (s_x, s_y, s_z) with the admissible
    bound g_partial + Σ min g_remaining; capacity feasibility of the last
    axis reduces to thresholds on l1_z / l3_z.
  * A single incumbent (UB) is shared across all combos and triples; any
    node pruned had provable LB >= UB-at-prune-time >= final UB, so at
    termination UB = LB and the gap is 0 (certificate).

Two search engines share these bounds (`solve(..., engine=...)`):
  * "vectorized" (default): the frontier engine.  Per discrete combo all
    spatial-triple lower bounds are formed as one broadcast grid and
    bulk-masked against the incumbent; per surviving triple the x×y
    candidate cross-join is built as numpy arrays, capacity thresholds
    (t_rf, t_sr) are computed for all pairs at once, and the best feasible
    z chain per pair is resolved with a searchsorted lookup into a 2-D
    prefix-min table (`_ZTable`).  Incumbent updates replay the reference
    engine's acceptance sequence exactly (an EPS-improvement scan in DFS
    visit order), so results are bit-identical — enforced by the
    differential corpus in tests/test_solver_engines.py.
  * "reference": the original per-node Python DFS, kept as the
    differential-testing oracle.

Objectives: "energy" (paper's Ē, eq. 33) or "edp" (Ē / num_pe_used, which
orders mappings identically to EDP = E·T since T ∝ V / num_pe_used).  Under
the paper's default equality constraint (100% PE utilization) the two
coincide (paper §V-A4).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import os
import time

import numpy as np

from ..faults import inject
from ..obs.registry import get_registry
from ..obs.tracing import get_tracer
from ..obs.tracing import span as _span
from .certificate import Certificate, check_constraints
from .edp import evaluate
from .energy import analytical_energy
from .geometry import (AXES, Gemm, Mapping, divisor_chains, divisors,
                       mapping_space_size)
from .hardware import AcceleratorSpec, Bandwidth, Ert, bandwidth_for
from .pareto import ParetoCertificate, ParetoPoint, pareto_min

_REG = get_registry()

_EPS = 1e-12

# Bumped whenever the search/objective semantics change; part of the
# planner's content-addressed plan-store key, so stale on-disk plans are
# never served for a newer solver (planner/store.py).  The vectorized
# engine is differentially tested bit-identical to the reference DFS, so
# it shares the version (cached plans stay valid across the engine swap).
SOLVER_VERSION = "goma-bb-1"

ENGINES = ("vectorized", "reference")
# Process default; overridable per call or via $GOMA_SOLVER_ENGINE.
DEFAULT_ENGINE = os.environ.get("GOMA_SOLVER_ENGINE", "vectorized")

# Process-level invocation counting lives in the observability registry
# (``repro.obs.registry``) under ``solver.calls``; the two functions
# below are back-compat shims so callers asserting zero-solve
# properties (e.g. the serving scheduler's steady state runs entirely
# from the plan database — tests/test_serving_sched.py) keep working
# unchanged.  ``solve_many`` routes through ``solve``, so one counter
# covers both entry points.


def solver_stats() -> dict:
    """Snapshot of process-level solver counters ({"calls": n})."""
    return {"calls": _REG.get("solver.calls")}


def reset_solver_stats() -> None:
    _REG.reset("solver.calls")


_BIG = 1 << 62          # "no threshold" sentinel (larger than any l1/l3)
# x*y join sizes at or below this run the per-node DFS instead of the
# bulk join (numpy call overhead dominates tiny joins)
_JOIN_DFS_CUTOFF = 512


@dataclasses.dataclass
class _ZTable:
    """2-D prefix-min over the z s-group for O(1) best-feasible-z lookup.

    For the candidates of one z s-group (sorted by energy, Pareto
    filtered), ``pos[r, c]`` is the smallest candidate *position* (index
    into ``zidx``) among candidates with l3 <= l3_vals[r] and
    l1 <= l1_vals[c] — exactly the z chain the reference DFS would accept
    first under thresholds (t_rf, t_sr), since positions refine the
    energy order.  ``npos`` is the "none feasible" sentinel.
    """

    l3_vals: np.ndarray   # ascending distinct l3 over the group
    l1_vals: np.ndarray   # ascending distinct l1 over the group
    pos: np.ndarray       # (len(l3_vals), len(l1_vals)) min position
    g_sorted: np.ndarray  # g in group order (ascending)
    zidx: np.ndarray      # group candidate indices (by_s order)
    npos: int


@dataclasses.dataclass
class _AxisCands:
    """Per-axis chain candidates under one variant key."""

    l1: np.ndarray
    l2: np.ndarray
    l3: np.ndarray
    s: np.ndarray            # l2 // l3
    g: np.ndarray            # normalized energy contribution per chain
    by_s: dict[int, np.ndarray]   # s value -> candidate indices sorted by g
    min_g_by_s: dict[int, float]
    s_vals: np.ndarray       # ascending distinct s values (== by_s keys)
    min_gs: np.ndarray       # min g per s value, aligned with s_vals
    g_min: float             # min g over all candidates (combo bound)
    ztabs: dict[int, _ZTable] = dataclasses.field(default_factory=dict)


def _axis_energy_kind(kind: str, L0d: int, l1: np.ndarray, l2: np.ndarray,
                      l3: np.ndarray, w01: bool, w12: bool, r1: bool,
                      r3: bool, ert: Ert) -> np.ndarray:
    """Vectorized per-axis normalized energy g_d over all chains.

    Mirrors energy.analytical_energy exactly (tested for equality).
    ``kind`` is "xy" (non-reduction axes share one formula) or "z"."""
    l1f, l2f, l3f = l1.astype(float), l2.astype(float), l3.astype(float)
    s = l2f / l3f
    g = np.zeros(len(l1), dtype=float)
    if kind == "xy":
        d0, d1, d3 = ert.dram_read, ert.sram_read, ert.rf_read
        u1, u3 = ert.sram_write, ert.rf_write
        if r1:
            g += (d0 + u1) / (float(L0d) if w01 else l1f)
        src_down = d1 if r1 else d0
        if r3:
            comp = (l1f / l2f) if w12 else 1.0
            g += (u3 + src_down / s) / (l3f * comp)
            g += d3
        else:
            g += src_down / s
    else:  # z — the reduction axis (partial sums)
        rho1 = 0.0 if w01 else (1.0 - l1f / L0d)            # eq. 13/16
        rho3 = (1.0 - l1f / L0d) if w12 else (1.0 - l2f / L0d)  # eq. 14/16
        rho4 = 1.0 - s / L0d                                 # eq. 15/16
        if r1:
            e_down0 = ert.dram_write + rho1 * ert.dram_read
            e_up1 = rho1 * ert.sram_write
            g += (e_down0 + e_up1) / (float(L0d) if w01 else l1f)
        if r1:
            src_w, src_r = ert.sram_write, ert.sram_read
        else:
            src_w, src_r = ert.dram_write, ert.dram_read
        if r3:
            comp = (l1f / l2f) if w12 else 1.0
            e_up3 = rho3 * ert.rf_write + ert.spatial_reduce
            e_src = src_w + rho3 * src_r
            g += (e_up3 + e_src / s) / (l3f * comp)
            g += ert.rf_write + rho4 * ert.rf_read
        else:
            g += (src_w + rho4 * src_r) / s
    return g


def _axis_energy(axis: str, L0d: int, l1: np.ndarray, l2: np.ndarray,
                 l3: np.ndarray, w01: bool, w12: bool, r1: bool, r3: bool,
                 hw: AcceleratorSpec) -> np.ndarray:
    """Back-compat wrapper (axis name + full spec) around the kind form."""
    kind = "xy" if axis in ("x", "y") else "z"
    return _axis_energy_kind(kind, L0d, l1, l2, l3, w01, w12, r1, r3, hw.ert)


# ---------------------------------------------------------------------------
# cross-solve axis-candidate cache
# ---------------------------------------------------------------------------
# _AxisCands arrays depend only on (axis kind, axis extent, ERT, variant
# key, fixed-spatial mask) — NOT on capacities, the companion axes, or the
# objective — so they are shared process-wide across solves.  A batch of
# scenario shapes (planner/batch.py, solve_many) re-derives each distinct
# axis once; everything else is a dict hit.

_AXIS_MEMO: "collections.OrderedDict[tuple, _AxisCands]" = \
    collections.OrderedDict()
_AXIS_MEMO_CAP = 4096


def axis_cache_stats() -> dict:
    """Observability for benchmarks/tests: {hits, misses, entries}.

    Registry-backed shim (``solver.axis_cache.*``); the entry count is
    a live property of the memo, not a counter."""
    return {"hits": _REG.get("solver.axis_cache.hits"),
            "misses": _REG.get("solver.axis_cache.misses"),
            "entries": len(_AXIS_MEMO)}


def clear_axis_cache() -> None:
    _AXIS_MEMO.clear()
    _REG.reset("solver.axis_cache.")
    _chain_arrays.cache_clear()


def _pareto_mask(ranks: np.ndarray, l3g: np.ndarray,
                 m: int) -> np.ndarray | None:
    """Vectorized Pareto filter within one s-group (exactness-preserving).

    Inputs are in ascending-g order (stable): ``ranks`` are the chains'
    dense l1-ranks, ``l3g`` their l3 extents, ``m`` the rank count.
    Within an s-group the objective depends only on this axis's chain,
    and constraints are monotone nondecreasing in (l1, l3); a chain
    dominated in (g, l1, l3) by any earlier chain can never be required
    by an optimal solution.  Dominance by *any* earlier chain equals
    dominance by a *kept* earlier chain (dominance is transitive), so
    the filter is order-independent of the kept set and vectorizes as a
    running 2-D prefix-min.  Returns the keep mask (None = keep all).
    """
    n = ranks.size
    if n <= 1:
        return None
    if n == 2:
        if ranks[0] <= ranks[1] and l3g[0] <= l3g[1]:
            return _KEEP_FIRST
        return None
    l3f = l3g.astype(float)
    # mat[j, c] = l3 of chain j if it constrains l1-rank c (rank_j <= c)
    mat = np.where(ranks[:, None] <= np.arange(m)[None, :],
                   l3f[:, None], np.inf)
    pref = np.minimum.accumulate(mat, axis=0)
    dominated = np.empty(n, dtype=bool)
    dominated[0] = False
    dominated[1:] = pref[np.arange(n - 1), ranks[1:]] <= l3f[1:]
    if not dominated.any():
        return None
    return ~dominated


_KEEP_FIRST = np.array([True, False])


@functools.lru_cache(maxsize=1024)
def _chain_arrays(L0d: int, fixed_s: int | None, fixed_l1: int | None = None):
    """Variant-independent chain geometry of one axis extent: the divisor
    chains as int64 columns, the spatial values, and the s-group index
    partition with per-group dense l1-ranks.  Shared by all variant keys
    (and across solves).  ``fixed_l1`` restricts to chains whose SRAM
    tile equals it (the chain solver's tiling-compatibility pin)."""
    arr = np.array(divisor_chains(L0d), dtype=np.int64)
    l1, l2, l3 = (np.ascontiguousarray(arr[:, 0]),
                  np.ascontiguousarray(arr[:, 1]),
                  np.ascontiguousarray(arr[:, 2]))
    s = l2 // l3
    if fixed_l1 is not None:
        mask = l1 == fixed_l1
        l1, l2, l3, s = l1[mask], l2[mask], l3[mask], s[mask]
    if fixed_s is not None:
        mask = s == fixed_s
        l1, l2, l3, s = l1[mask], l2[mask], l3[mask], s[mask]
    s_vals = np.unique(s)
    groups = []
    for sv in s_vals:
        grp = np.nonzero(s == sv)[0]
        u1 = np.unique(l1[grp])
        groups.append((grp, np.searchsorted(u1, l1[grp]), u1.size))
    return l1, l2, l3, s, s_vals, tuple(groups)


def _axis_cands(kind: str, L0d: int, ert: Ert, w01: bool, w12: bool,
                r1: bool, r3: bool, fixed_s: int | None,
                fixed_l1: int | None = None) -> _AxisCands:
    # Canonical variant key: the walking bits only enter the energy under
    # the matching residency bit (w01 via the r1 terms, w12 via the r3
    # compensation/rho terms, for both axis kinds), so 16 raw keys
    # collapse to 9 distinct candidate arrays.
    w01, w12 = w01 and r1, w12 and r3
    key = (kind, L0d, ert, w01, w12, r1, r3, fixed_s, fixed_l1)
    c = _AXIS_MEMO.get(key)
    if c is not None:
        _AXIS_MEMO.move_to_end(key)
        _REG.inc("solver.axis_cache.hits")
        return c
    _REG.inc("solver.axis_cache.misses")
    l1, l2, l3, s, s_vals, groups = _chain_arrays(L0d, fixed_s, fixed_l1)
    g = _axis_energy_kind(kind, L0d, l1, l2, l3, w01, w12, r1, r3, ert)
    by_s: dict[int, np.ndarray] = {}
    min_g_by_s: dict[int, float] = {}
    min_gs = np.empty(s_vals.size, dtype=float)
    for k, sv in enumerate(s_vals):
        grp, granks, m = groups[k]
        order = np.argsort(g[grp], kind="stable")
        idx = grp[order]
        keep = _pareto_mask(granks[order], l3[idx], m)
        if keep is not None:
            idx = idx[keep]
        by_s[int(sv)] = idx
        mg = float(g[idx[0]]) if len(idx) else np.inf
        min_g_by_s[int(sv)] = mg
        min_gs[k] = mg
    g_min = float(np.min(g)) if g.size else float("inf")
    c = _AxisCands(l1, l2, l3, s, g, by_s, min_g_by_s, s_vals, min_gs,
                   g_min)
    _AXIS_MEMO[key] = c
    while len(_AXIS_MEMO) > _AXIS_MEMO_CAP:
        _AXIS_MEMO.popitem(last=False)
    return c


def _ztable(c: _AxisCands, sv: int) -> _ZTable:
    """Lazily build (and cache on the cands) the s-group's prefix-min."""
    tab = c.ztabs.get(sv)
    if tab is not None:
        return tab
    idx = c.by_s[sv]
    l3g, l1g = c.l3[idx], c.l1[idx]
    l3v, l1v = np.unique(l3g), np.unique(l1g)
    npos = int(idx.size)
    pos = np.full((l3v.size, l1v.size), npos, dtype=np.int64)
    rows = np.searchsorted(l3v, l3g)
    cols = np.searchsorted(l1v, l1g)
    np.minimum.at(pos, (rows, cols), np.arange(npos))
    pos = np.minimum.accumulate(np.minimum.accumulate(pos, axis=0), axis=1)
    tab = _ZTable(l3_vals=l3v, l1_vals=l1v, pos=pos,
                  g_sorted=c.g[idx], zidx=idx, npos=npos)
    c.ztabs[sv] = tab
    return tab


@dataclasses.dataclass
class SolveResult:
    mapping: Mapping | None
    certificate: Certificate
    breakdown: object | None = None   # EnergyBreakdown of the optimum


@dataclasses.dataclass
class _SearchState:
    """Running branch-and-bound state shared by both engines."""

    best: float
    best_state: tuple | None = None
    nodes: int = 0
    pruned: int = 0
    combos_skipped: int = 0
    # anytime mode: wall-clock deadline (perf_counter) after which the
    # search stops improving the incumbent; never honored before the
    # first incumbent exists, so a feasible instance always returns a
    # feasible (if bounded) result
    deadline: float | None = None
    expired: bool = False


def _check_budget(st: _SearchState) -> bool:
    """True once the anytime deadline has passed (sticky).  Cheap when
    no deadline is set; with one, costs a perf_counter() read."""
    if st.expired:
        return True
    if (st.deadline is not None and st.best_state is not None
            and time.perf_counter() >= st.deadline):
        st.expired = True
    return st.expired


# ---------------------------------------------------------------------------
# reference engine: the original per-node DFS (differential oracle)
# ---------------------------------------------------------------------------

def _dfs_triple(st: _SearchState, combo, cx, cy, cz, sx: int, sy: int,
                sz: int, hw: AcceleratorSpec, macc: float,
                leak_term: float, scale: float) -> None:
    """Per-node DFS over one spatial triple: x then y sorted by g; z by
    threshold scan.  The acceptance semantics the frontier engine
    replays (and its small-join fast path)."""
    a01, a12, r1, r3 = combo
    min_gy = cy.min_g_by_s[sy]
    min_gz = cz.min_g_by_s[sz]
    zi = cz.by_s[sz]
    for ix in cx.by_s[sx]:
        if _check_budget(st):
            return
        gx = cx.g[ix] + macc + leak_term
        if (gx + min_gy + min_gz) * scale >= st.best - _EPS:
            break
        l1x, l3x = int(cx.l1[ix]), int(cx.l3[ix])
        for iy in cy.by_s[sy]:
            gy = cy.g[iy]
            if (gx + gy + min_gz) * scale >= st.best - _EPS:
                break
            l1y, l3y = int(cy.l1[iy]), int(cy.l3[iy])
            # capacity thresholds for axis z (eqs. 31-32)
            rf_fix = r3[2] * l3x * l3y
            rf_lin = r3[1] * l3x + r3[0] * l3y
            sr_fix = r1[2] * l1x * l1y
            sr_lin = r1[1] * l1x + r1[0] * l1y
            if rf_fix > hw.rf_words or sr_fix > hw.sram_words:
                continue
            t_rf = ((hw.rf_words - rf_fix) // rf_lin
                    if rf_lin else None)
            t_sr = ((hw.sram_words - sr_fix) // sr_lin
                    if sr_lin else None)
            for iz in zi:
                st.nodes += 1
                gz = cz.g[iz]
                o = (gx + gy + gz) * scale
                if o >= st.best - _EPS:
                    break
                if t_rf is not None and cz.l3[iz] > t_rf:
                    continue
                if t_sr is not None and cz.l1[iz] > t_sr:
                    continue
                st.best = o
                st.best_state = (combo, (cx, cy, cz), (ix, iy, iz))
                break


def _triples_reference(st: _SearchState, combo, cx, cy, cz,
                       spatial_mode: str, hw: AcceleratorSpec,
                       macc: float, leak_cycle: float,
                       objective: str, min_pe: int = 1) -> None:
    npe = hw.num_pe
    sx_vals = sorted(cx.by_s)
    sy_vals = sorted(cy.by_s)
    for sx in sx_vals:
        if spatial_mode in ("equality", "fixed") and npe % sx:
            continue
        if sx > npe:
            continue
        for sy in sy_vals:
            prod_xy = sx * sy
            if prod_xy > npe:
                break
            if spatial_mode in ("equality", "fixed"):
                if npe % prod_xy:
                    continue
                sz_opts = [npe // prod_xy]
            else:
                sz_opts = [sz for sz in cz.by_s if prod_xy * sz <= npe]
            for sz in sz_opts:
                if sz not in cz.by_s:
                    continue
                s_prod = prod_xy * sz
                if s_prod < min_pe:       # epsilon-constraint floor
                    continue
                scale = 1.0 if objective == "energy" else 1.0 / s_prod
                leak_term = leak_cycle / s_prod
                lb_triple = (cx.min_g_by_s[sx] + cy.min_g_by_s[sy]
                             + cz.min_g_by_s[sz] + macc
                             + leak_term) * scale
                if lb_triple >= st.best - _EPS:
                    st.pruned += 1
                    continue
                if _check_budget(st):
                    return
                _dfs_triple(st, combo, cx, cy, cz, sx, sy, sz, hw, macc,
                            leak_term, scale)


# ---------------------------------------------------------------------------
# vectorized frontier engine
# ---------------------------------------------------------------------------

def _accept_scan(st: _SearchState, flat_o: np.ndarray, on_accept) -> None:
    """Replay the reference DFS's incumbent-acceptance sequence.

    ``flat_o`` is the pair objectives in DFS visit order.  The DFS accepts
    a node iff o < best - EPS *at visit time*, so acceptances form a
    strictly EPS-decreasing chain; each vectorized step finds the next
    improvement with nonzero on the remaining suffix (few iterations:
    exactly as many as the DFS performed incumbent updates here)."""
    p = 0
    while True:
        rel = np.nonzero(flat_o[p:] < st.best - _EPS)[0]
        if rel.size == 0:
            return
        j = p + int(rel[0])
        st.best = float(flat_o[j])
        on_accept(j)
        p = j + 1


def _frontier_join(st: _SearchState, combo, cx, cy, cz, sx: int, sy: int,
                   sz: int, hw: AcceleratorSpec, macc: float,
                   leak_term: float, scale: float) -> None:
    """Bulk x×y cross-join for one surviving spatial triple.

    Chunked over x rows: each chunk is bounded against the *current*
    incumbent before materializing, so the reference engine's dynamic
    pruning power is preserved while the join itself is numpy-wide.

    Tiny joins fall back to the per-node DFS: below ~a few hundred pairs
    the numpy call overhead exceeds the Python loop, and the DFS *is*
    the acceptance semantics the bulk path replays, so the fast path is
    exact by construction."""
    a01, a12, r1, r3 = combo
    X, Y = cx.by_s[sx], cy.by_s[sy]
    if X.size * Y.size <= _JOIN_DFS_CUTOFF:
        _dfs_triple(st, combo, cx, cy, cz, sx, sy, sz, hw, macc,
                    leak_term, scale)
        return
    ztab = _ztable(cz, sz)
    gx = cx.g[X] + macc + leak_term          # ascending in g
    gy = cy.g[Y]                             # ascending in g
    min_gy = cy.min_g_by_s[sy]
    min_gz = cz.min_g_by_s[sz]
    bound_x = (gx + min_gy + min_gz) * scale   # ascending
    l1x, l3x = cx.l1[X], cx.l3[X]
    l1y, l3y = cy.l1[Y], cy.l3[Y]
    rmax, cmax = ztab.pos.shape[0] - 1, ztab.pos.shape[1] - 1
    chunk = 128
    xpos = 0
    nx = X.size
    while xpos < nx:
        if _check_budget(st):
            return
        # dynamic x prune (the DFS's break): ascending bound => prefix
        keep = int(np.searchsorted(bound_x[xpos:], st.best - _EPS,
                                   side="left"))
        if keep == 0:
            return
        k = min(keep, chunk)
        xs = slice(xpos, xpos + k)
        # y prune against the chunk's smallest gx (the DFS's inner break;
        # pairs beyond it cannot beat the incumbent for any row here)
        by = (gx[xpos] + gy + min_gz) * scale
        ny = int(np.searchsorted(by, st.best - _EPS, side="left"))
        if ny == 0:
            return
        gxy = gx[xs, None] + gy[None, :ny]
        # capacity thresholds for axis z, all pairs at once (eqs. 31-32)
        rf_fix = r3[2] * l3x[xs, None] * l3y[None, :ny]
        rf_lin = r3[1] * l3x[xs, None] + r3[0] * l3y[None, :ny]
        sr_fix = r1[2] * l1x[xs, None] * l1y[None, :ny]
        sr_lin = r1[1] * l1x[xs, None] + r1[0] * l1y[None, :ny]
        feas = (rf_fix <= hw.rf_words) & (sr_fix <= hw.sram_words)
        t_rf = np.where(rf_lin > 0,
                        (hw.rf_words - rf_fix) // np.maximum(rf_lin, 1),
                        _BIG)
        t_sr = np.where(sr_lin > 0,
                        (hw.sram_words - sr_fix) // np.maximum(sr_lin, 1),
                        _BIG)
        r = np.searchsorted(ztab.l3_vals, t_rf, side="right") - 1
        c = np.searchsorted(ztab.l1_vals, t_sr, side="right") - 1
        feas &= (r >= 0) & (c >= 0)
        pos = ztab.pos[np.clip(r, 0, rmax), np.clip(c, 0, cmax)]
        feas &= pos < ztab.npos
        gz = np.where(feas, ztab.g_sorted[np.minimum(pos, ztab.npos - 1)],
                      np.inf)
        o = np.where(feas, (gxy + gz) * scale, np.inf)
        st.nodes += o.size
        flat = o.ravel()                      # row-major == DFS visit order
        pos_flat = pos.ravel()

        def on_accept(j: int, xs=xs, pos_flat=pos_flat, ny=ny):
            ii, jj = divmod(j, ny)
            st.best_state = (combo, (cx, cy, cz),
                             (int(X[xs.start + ii]), int(Y[jj]),
                              int(ztab.zidx[int(pos_flat[j])])))

        _accept_scan(st, flat, on_accept)
        xpos += k


@dataclasses.dataclass
class _TripleGrid:
    """Combo-invariant spatial-triple machinery, built once per solve.

    The s-value partition of each axis is variant-independent, so the
    (sx, sy, sz) product grid, its structural-feasibility mask, and the
    leakage/scale fields depend only on (extents, npe, mode, objective)
    and are shared by all 576 discrete combos of one solve."""

    equality: bool
    sx: np.ndarray           # filtered x s-values
    sy: np.ndarray
    xsel: np.ndarray         # indices into the axis s_vals (min_gs gather)
    # equality: 2-D (sx, sy) grid; forced sz + its index into z s_vals
    ok: np.ndarray | None = None
    szv: np.ndarray | None = None
    zsel: np.ndarray | None = None
    scale_g: float = 1.0
    leak_term: float = 0.0
    # le: flat arrays over structurally valid triples, in reference visit
    # order (sx asc, sy asc, sz asc)
    vsx: np.ndarray | None = None    # s values per valid triple
    vsy: np.ndarray | None = None
    vsz: np.ndarray | None = None
    gix: np.ndarray | None = None    # min_gs gather indices per axis
    giy: np.ndarray | None = None
    giz: np.ndarray | None = None
    sprods: np.ndarray | None = None
    leak: np.ndarray | None = None   # leak_cycle / s_prod
    scale: np.ndarray | float = 1.0


def _make_grid(cx, cy, cz, spatial_mode: str, npe: int, leak_cycle: float,
               objective: str, min_pe: int = 1) -> _TripleGrid:
    sx = cx.s_vals
    okx = sx <= npe
    equality = spatial_mode in ("equality", "fixed")
    if equality:
        okx &= (npe % np.maximum(sx, 1)) == 0
    xsel = np.nonzero(okx)[0]
    sx = sx[xsel]
    sy = cy.s_vals
    energy = objective == "energy"
    if equality:
        pxy = sx[:, None] * sy[None, :]
        ok = (pxy <= npe) & (npe % np.maximum(pxy, 1) == 0)
        ok &= npe >= min_pe           # s_prod == npe in equality mode
        szv = np.where(ok, npe // np.maximum(pxy, 1), -1)
        zp = np.searchsorted(cz.s_vals, np.maximum(szv, 0))
        zsel = np.clip(zp, 0, cz.s_vals.size - 1)
        ok &= cz.s_vals[zsel] == szv
        return _TripleGrid(
            equality=True, sx=sx, sy=sy, xsel=xsel, ok=ok, szv=szv,
            zsel=zsel, scale_g=1.0 if energy else 1.0 / float(npe),
            leak_term=leak_cycle / npe)
    zax = np.nonzero(cz.s_vals <= npe)[0]
    sz = cz.s_vals[zax]
    sprod = sx[:, None, None] * sy[None, :, None] * sz[None, None, :]
    # row-major == visit order; min_pe is the Pareto sweep's
    # epsilon-constraint floor (1 = unconstrained, identical mask)
    vi, vj, vk = np.nonzero((sprod <= npe) & (sprod >= min_pe))
    sprods = sprod[vi, vj, vk]
    spf = sprods.astype(float)
    return _TripleGrid(
        equality=False, sx=sx, sy=sy, xsel=xsel,
        vsx=sx[vi], vsy=sy[vj], vsz=sz[vk],
        gix=xsel[vi], giy=vj, giz=zax[vk], sprods=sprods,
        leak=leak_cycle / spf,
        scale=1.0 if energy else 1.0 / spf)


def _triples_vectorized(st: _SearchState, combo, cx, cy, cz,
                        spatial_mode: str, hw: AcceleratorSpec,
                        macc: float, leak_cycle: float,
                        objective: str, grid: _TripleGrid) -> None:
    """Bulk-mask all spatial triples of one combo, then join survivors.

    The triple lower-bound grid is computed with the incumbent at combo
    entry; survivors are re-checked against the *running* incumbent at
    visit time (identical float expression), so the explored/pruned
    partition matches the reference engine exactly."""
    energy = objective == "energy"
    if grid.equality:
        mgx = cx.min_gs[grid.xsel]
        mgy = cy.min_gs
        mgz = np.where(grid.ok, cz.min_gs[grid.zsel], np.inf)
        lb = (mgx[:, None] + mgy[None, :] + mgz + macc
              + grid.leak_term) * grid.scale_g
        lb = np.where(grid.ok, lb, np.inf)
        improving = lb < st.best - _EPS
        for i, j in np.argwhere(improving):
            l = float(lb[i, j])
            if l >= st.best - _EPS:            # incumbent moved since
                st.pruned += 1
                continue
            if _check_budget(st):
                return
            _frontier_join(st, combo, cx, cy, cz, int(grid.sx[i]),
                           int(grid.sy[j]), int(grid.szv[i, j]), hw, macc,
                           grid.leak_term, grid.scale_g)
        st.pruned += int(np.count_nonzero(grid.ok & ~improving))
    else:
        lb = (cx.min_gs[grid.gix] + cy.min_gs[grid.giy]
              + cz.min_gs[grid.giz] + macc + grid.leak) * grid.scale
        improving = lb < st.best - _EPS
        for p in np.nonzero(improving)[0]:
            if float(lb[p]) >= st.best - _EPS:  # incumbent moved since
                st.pruned += 1
                continue
            if _check_budget(st):
                return
            s_prod = int(grid.sprods[p])
            _frontier_join(st, combo, cx, cy, cz, int(grid.vsx[p]),
                           int(grid.vsy[p]), int(grid.vsz[p]), hw, macc,
                           leak_cycle / s_prod,
                           1.0 if energy else 1.0 / s_prod)
        st.pruned += int(improving.size - np.count_nonzero(improving))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def solve(gemm: Gemm, hw: AcceleratorSpec, *,
          objective: str = "energy",
          spatial_mode: str | None = None,
          allowed_walk01: tuple[str, ...] | None = None,
          incumbent: float | None = None,
          engine: str | None = None,
          fixed_l1: tuple[int | None, int | None, int | None] | None = None,
          require_res1: tuple[bool, bool, bool] | None = None,
          budget_s: float | None = None,
          min_pe: int | None = None) -> SolveResult:
    """Globally optimal mapping for (gemm, hw) with certificate.

    Observability wrapper: counts the call (``solver.calls``) and opens
    a ``solver.solve`` span when a tracer is installed, then delegates
    to the branch-and-bound body.  Internal fallback re-solves (warm
    start pruned everything, equality infeasible) recurse through this
    wrapper, so each attempted search is one counted call with its own
    span — matching the original counter semantics.
    See ``_solve_impl`` for the full parameter documentation.
    """
    _REG.inc("solver.calls")
    tr = get_tracer()
    if tr is None:
        res = _solve_impl(gemm, hw, objective=objective,
                          spatial_mode=spatial_mode,
                          allowed_walk01=allowed_walk01,
                          incumbent=incumbent, engine=engine,
                          fixed_l1=fixed_l1, require_res1=require_res1,
                          budget_s=budget_s, min_pe=min_pe)
        if res.certificate.bounded:
            _REG.inc("degraded.solver.bounded")
        return res
    with tr.span("solver.solve", dims=list(gemm.dims), hw=hw.name,
                 objective=objective,
                 engine=engine if engine is not None
                 else DEFAULT_ENGINE) as sp:
        res = _solve_impl(gemm, hw, objective=objective,
                          spatial_mode=spatial_mode,
                          allowed_walk01=allowed_walk01,
                          incumbent=incumbent, engine=engine,
                          fixed_l1=fixed_l1, require_res1=require_res1,
                          budget_s=budget_s, min_pe=min_pe)
        cert = res.certificate
        sp.attrs.update(feasible=cert.feasible,
                        solve_time_s=cert.solve_time_s,
                        nodes=cert.nodes_explored)
        if cert.feasible:
            sp.attrs["objective_value"] = cert.objective
        if cert.bounded:
            _REG.inc("degraded.solver.bounded")
            sp.attrs.update(bounded=True, gap=cert.gap)
        return res


def _solve_impl(gemm: Gemm, hw: AcceleratorSpec, *,
                objective: str = "energy",
                spatial_mode: str | None = None,
                allowed_walk01: tuple[str, ...] | None = None,
                incumbent: float | None = None,
                engine: str | None = None,
                fixed_l1: tuple[int | None, int | None, int | None]
                | None = None,
                require_res1: tuple[bool, bool, bool] | None = None,
                budget_s: float | None = None,
                min_pe: int | None = None) -> SolveResult:
    """Branch-and-bound search body behind ``solve``.

    objective: "energy" (paper default) or "edp".
    spatial_mode: "equality" (eq. 29), "le", or None = hw default with
    automatic fallback to "le" if equality is infeasible (recorded).
    allowed_walk01: optionally restrict the stage 0-1 walking axis (used
    by the TPU adapter, where a non-z outer walk with partial reduction
    would imply partial-sum HBM traffic Pallas cannot express).
    incumbent: optional initial upper bound seeding branch-and-bound (the
    planner's warm start from a cached near-neighbor plan).  Soundness is
    unconditional: the incumbent only prunes, so if it lies at or below
    the true optimum no feasible state survives and we transparently
    re-solve cold; when a state *is* found every pruned node had a
    provable LB >= the final UB, so the zero-gap certificate is intact.
    engine: "vectorized" (default, the frontier engine) or "reference"
    (the original DFS).  Both produce bit-identical optima; the engine
    used is recorded on the certificate.  Node/prune counters are
    comparable at triple granularity; ``nodes_explored`` counts candidate
    pairs for the frontier engine vs z-visits for the DFS.
    fixed_l1: per-axis SRAM tile pin (None = free).  Restricts the axis's
    divisor chains to those with L1 equal to the pinned extent — the chain
    solver's tiling-compatibility constraint (core/fusion.py): both
    engines share the restricted candidate arrays, so the differential
    bit-identity guarantee extends to constrained solves unchanged.
    require_res1: per-axis SRAM residency force (True = the datatype with
    that normal axis must be SRAM-resident).  Restricts the res1 combo
    set; used by the chain solver so the fused intermediate's footprint
    is charged against capacity.
    min_pe: spatial-product floor ``num_pe_used >= min_pe`` (None/1 =
    unconstrained, bit-identical search).  The epsilon-constraint lever
    of ``solve_pareto``: under "le" it slices the mapping space by the
    compute-delay level; under "equality"/"fixed" the product is pinned
    at num_pe, so any ``min_pe <= num_pe`` is vacuous and larger values
    are infeasible.  Both engines apply the identical triple filter, so
    the differential bit-identity guarantee extends to constrained
    solves.
    budget_s: anytime mode — a wall-clock budget after which the search
    stops and returns the best *incumbent* with ``certificate.bounded``
    set and a sound proven gap.  Soundness of the recorded lower bound:
    combos are visited in ascending order of their per-axis bound
    (``combo_lb``), every fully-searched combo was explored or pruned
    against an incumbent >= the final UB, and the in-progress combo plus
    every remaining one is lower-bounded by the current ``combo_lb``
    (times the best-case objective scale) — so
    LB = min(UB, combo_lb * max_scale) bounds the true optimum from
    below.  The deadline is never honored before the first incumbent
    exists: a feasible instance always returns a feasible result.
    """
    t0 = time.perf_counter()
    eng = engine if engine is not None else DEFAULT_ENGINE
    if eng not in ENGINES:
        raise ValueError(f"unknown engine {eng!r}; expected one of {ENGINES}")
    requested_mode = spatial_mode
    if spatial_mode is None:
        spatial_mode = "equality" if hw.spatial_equality else "le"
    if hw.fixed_spatial is not None:
        spatial_mode = "fixed"
    mp = 1 if min_pe is None else int(min_pe)

    local_cands: dict[tuple, _AxisCands] = {}

    def cands(axis: str, w01: bool, w12: bool, r1: bool, r3: bool):
        key = (axis, w01 and r1, w12 and r3, r1, r3)
        c = local_cands.get(key)
        if c is None:
            kind = "xy" if axis in ("x", "y") else "z"
            fixed_s = (hw.fixed_spatial[AXES.index(axis)]
                       if hw.fixed_spatial is not None else None)
            fl1 = (fixed_l1[AXES.index(axis)]
                   if fixed_l1 is not None else None)
            c = _axis_cands(kind, gemm.dim(axis), hw.ert, w01, w12, r1, r3,
                            fixed_s, fl1)
            local_cands[key] = c
        return c

    # --- discrete combos --------------------------------------------------
    bools = (True, False)
    if hw.allow_bypass:
        res_opts = list(itertools.product(bools, repeat=3))
    else:
        res_opts = [(True, True, True)]
    res1_opts = res_opts
    if require_res1 is not None:
        res1_opts = [r for r in res_opts
                     if all(r[d] for d in range(3) if require_res1[d])]
    walk01_opts = AXES if allowed_walk01 is None else allowed_walk01
    combos = [(a01, a12, r1, r3)
              for a01 in walk01_opts for a12 in AXES
              for r1 in res1_opts for r3 in res_opts]

    npe = hw.num_pe
    macc = hw.ert.macc          # eq. 28 — inside the objective: under the
    # "edp" scale it is NOT constant.  Leakage burns on the whole chip for
    # all V/num_pe_used cycles (eq. 30); it depends on the spatial product,
    # so it lives inside the objective whenever num_pe_used is free.
    leak_cycle = hw.ert.sram_leak + hw.ert.rf_leak * npe
    if incumbent is not None and np.isfinite(incumbent):
        # Seed with a hair of slack so a mapping matching the incumbent
        # exactly (e.g. re-planning a shape whose optimum equals the
        # neighbor's) is still discovered rather than pruned.
        best = float(incumbent) * (1.0 + 1e-9) + 1e-9
    else:
        incumbent = None
        best = np.inf
    deadline = None
    if budget_s is not None:
        deadline = t0 + float(budget_s)
    if inject("solver.over_budget") is not None:
        # forced anytime expiry: deadline already in the past, so the
        # search stops as soon as the first incumbent exists
        deadline = t0
    st = _SearchState(best=best, deadline=deadline)
    vectorized = eng == "vectorized"
    grid: _TripleGrid | None = None
    # lower bound over the in-progress combo and (by the ascending combo
    # order) everything after it, valid whenever the budget expires
    expiry_lb = np.inf

    # Enumerate spatial triples lazily per combo (s-value sets are variant
    # independent, but candidate g's are not).  The sort is ascending in
    # the per-combo bound, which the anytime lower bound relies on.
    for combo in sorted(
            combos,
            key=lambda c: sum(
                cands(a, a == c[0], a == c[1], c[2][i], c[3][i]).g_min
                for i, a in enumerate(AXES))):
        a01, a12, r1, r3 = combo
        cx = cands("x", a01 == "x", a12 == "x", r1[0], r3[0])
        cy = cands("y", a01 == "y", a12 == "y", r1[1], r3[1])
        cz = cands("z", a01 == "z", a12 == "z", r1[2], r3[2])
        if not (len(cx.g) and len(cy.g) and len(cz.g)):
            continue
        combo_lb = ((cx.g_min + cy.g_min + cz.g_min)
                    + macc + leak_cycle / npe)
        # best possible objective scale: largest feasible s product
        max_scale = (1.0 / npe) if objective == "edp" else 1.0
        if combo_lb * max_scale >= st.best - _EPS:
            st.combos_skipped += 1
            continue
        expiry_lb = combo_lb * max_scale
        if _check_budget(st):
            break
        if vectorized:
            if grid is None:
                grid = _make_grid(cx, cy, cz, spatial_mode, npe,
                                  leak_cycle, objective, mp)
            _triples_vectorized(st, combo, cx, cy, cz, spatial_mode, hw,
                                macc, leak_cycle, objective, grid)
        else:
            _triples_reference(st, combo, cx, cy, cz, spatial_mode, hw,
                               macc, leak_cycle, objective, mp)
        if st.expired:
            break

    elapsed = time.perf_counter() - t0
    space = mapping_space_size(gemm, search_bypass=hw.allow_bypass)

    if st.best_state is None:
        if incumbent is not None:
            # The warm-start UB pruned everything: either the instance is
            # infeasible or its optimum exceeds the neighbor's objective.
            # Re-solve cold — exactness never depends on the incumbent.
            # Anytime note: the fallback gets a *fresh* budget window.
            return solve(gemm, hw, objective=objective,
                         spatial_mode=requested_mode,
                         allowed_walk01=allowed_walk01, engine=eng,
                         fixed_l1=fixed_l1, require_res1=require_res1,
                         budget_s=budget_s, min_pe=min_pe)
        if spatial_mode == "equality" and requested_mode is None:
            # eq. 29 infeasible for this (gemm, hw): documented fallback
            return solve(gemm, hw, objective="edp", spatial_mode="le",
                         allowed_walk01=allowed_walk01, engine=eng,
                         fixed_l1=fixed_l1, require_res1=require_res1,
                         budget_s=budget_s, min_pe=min_pe)
        cert = Certificate(gemm=gemm, hw_name=hw.name, mapping=None,
                           objective=np.inf, upper_bound=np.inf,
                           lower_bound=np.inf, nodes_explored=st.nodes,
                           nodes_pruned=st.pruned,
                           combos_skipped=st.combos_skipped,
                           space_size=space,
                           solve_time_s=elapsed, spatial_mode=spatial_mode,
                           feasible=False, objective_kind=objective,
                           engine=eng)
        return SolveResult(mapping=None, certificate=cert)

    (a01, a12, r1, r3), (cx, cy, cz), (ix, iy, iz) = st.best_state
    m = Mapping(
        L1=(int(cx.l1[ix]), int(cy.l1[iy]), int(cz.l1[iz])),
        L2=(int(cx.l2[ix]), int(cy.l2[iy]), int(cz.l2[iz])),
        L3=(int(cx.l3[ix]), int(cy.l3[iy]), int(cz.l3[iz])),
        alpha01=a01, alpha12=a12, res1=r1, res3=r3)
    bd = analytical_energy(gemm, m, hw)
    # Full search: UB == LB (zero gap).  Budget expiry: LB is the bound
    # covering the in-progress combo and all remaining (ascending) ones,
    # clamped by the incumbent — the recorded gap bounds the true gap.
    lower = float(st.best)
    if st.expired:
        lower = float(min(lower, expiry_lb))
    cert = Certificate(gemm=gemm, hw_name=hw.name, mapping=m,
                       objective=float(st.best), upper_bound=float(st.best),
                       lower_bound=lower, nodes_explored=st.nodes,
                       nodes_pruned=st.pruned,
                       combos_skipped=st.combos_skipped,
                       space_size=space, solve_time_s=elapsed,
                       spatial_mode=spatial_mode, feasible=True,
                       objective_kind=objective,
                       warm_started=incumbent is not None, engine=eng,
                       bounded=st.expired)
    assert check_constraints(gemm, m, hw, spatial_mode=(
        "equality" if spatial_mode == "fixed" else spatial_mode))
    return SolveResult(mapping=m, certificate=cert, breakdown=bd)


@dataclasses.dataclass(frozen=True)
class SolveRequest:
    """One solve of a batch (duck-typed: any object with these attributes
    works, e.g. the planner's pool task)."""

    gemm: Gemm
    hw: AcceleratorSpec
    objective: str = "energy"
    spatial_mode: str | None = None
    allowed_walk01: tuple[str, ...] | None = None
    incumbent: float | None = None
    budget_s: float | None = None
    min_pe: int | None = None


def _request_identity(r) -> tuple:
    """Semantic identity of one batch request (the single-flight key).

    Gemm names are metadata, not identity — two requests differing only
    in the name are the same solve (matching the planner's plan-key
    semantics, which hash extents only)."""
    return (r.gemm.dims, r.hw, r.objective, r.spatial_mode,
            r.allowed_walk01, r.incumbent,
            getattr(r, "fixed_l1", None), getattr(r, "require_res1", None),
            getattr(r, "budget_s", None), getattr(r, "min_pe", None))


def solve_many(requests, *, engine: str | None = None) -> list[SolveResult]:
    """Batch entry point: sequential solves sharing the axis-cands memo.

    Scenario batches (planner/batch.py) repeat d_model/d_ff axis extents
    across most shapes, so per-axis candidate construction — the dominant
    per-solve setup cost — is computed once per distinct axis for the
    whole batch instead of once per GEMM.

    Identical requests are single-flighted: N copies of the same
    (gemm, hw, objective, mode, walk, incumbent) tuple cost exactly one
    ``solve`` invocation (observable via ``solver_stats()``); every copy
    receives the same SolveResult object."""
    requests = list(requests)
    _REG.inc("solver.solve_many.calls")
    with _span("solver.solve_many", n=len(requests)) as sp:
        flights: dict[tuple, SolveResult] = {}
        out: list[SolveResult] = []
        for r in requests:
            key = _request_identity(r)
            res = flights.get(key)
            if res is None:
                res = solve(r.gemm, r.hw, objective=r.objective,
                            spatial_mode=r.spatial_mode,
                            allowed_walk01=r.allowed_walk01,
                            incumbent=r.incumbent, engine=engine,
                            fixed_l1=getattr(r, "fixed_l1", None),
                            require_res1=getattr(r, "require_res1", None),
                            budget_s=getattr(r, "budget_s", None),
                            min_pe=getattr(r, "min_pe", None))
                flights[key] = res
            out.append(res)
        if sp:
            sp.attrs["unique"] = len(flights)
        return out


# ---------------------------------------------------------------------------
# certified (energy, delay) Pareto frontiers — the epsilon-constraint sweep
# ---------------------------------------------------------------------------

def achievable_spatial_levels(gemm: Gemm, npe: int) -> list[int]:
    """All spatial products dx*dy*dz <= npe with each factor dividing its
    axis extent — the discrete ``num_pe_used`` values any "le"-mode
    mapping can realize.  These are the epsilon levels of the Pareto
    sweep: delay's compute term V/num_pe_used only changes across them."""
    dx = [d for d in divisors(gemm.dim("x")) if d <= npe]
    dy = [d for d in divisors(gemm.dim("y")) if d <= npe]
    dz = [d for d in divisors(gemm.dim("z")) if d <= npe]
    levels: set[int] = set()
    for a in dx:
        for b in dy:
            ab = a * b
            if ab > npe:
                break
            for c in dz:
                p = ab * c
                if p > npe:
                    break
                levels.add(p)
    return sorted(levels)


@dataclasses.dataclass
class ParetoSolveResult:
    """``solve_pareto`` output: the frontier plus its certificate."""

    points: tuple[ParetoPoint, ...]
    certificate: ParetoCertificate
    n_solves: int = 0


def solve_pareto(gemm: Gemm, hw: AcceleratorSpec, *,
                 objective: str = "energy",
                 spatial_mode: str | None = None,
                 allowed_walk01: tuple[str, ...] | None = None,
                 engine: str | None = None,
                 bw: Bandwidth | None = None,
                 max_points: int | None = 24) -> ParetoSolveResult:
    """Certified (energy, delay) Pareto frontier via epsilon-constraint.

    The first solve is the *unchanged* unconstrained ``solve`` call —
    the frontier's energy-optimal endpoint is bit-identical to what
    ``cached_solve``/serving already produce (stored plan identities
    untouched).  Under effective mode "le" the sweep then minimizes the
    same objective subject to ``num_pe_used >= p`` for each achievable
    spatial-product level above the incumbent's, each slice a zero-gap
    ``Certificate``; capacity feasibility is antitone in the floor, so
    the first infeasible level terminates the walk.  Under
    "equality"/"fixed" the spatial product is pinned and the frontier
    is the single energy-optimal point (delay has no free lever).

    The candidate set is filtered to the exact non-dominated frontier
    under the bandwidth-aware latency model (``core.edp.latency``) with
    the shared deterministic tie rule.  ``max_points`` caps the number
    of swept levels (thinned evenly, the largest level always kept);
    ``levels_total`` vs ``levels_swept`` on the certificate records any
    thinning — every returned point is still a certified slice optimum
    and the returned set is still mutually non-dominated.
    """
    t0 = time.perf_counter()
    _REG.inc("solver.pareto.calls")
    if bw is None:
        bw = bandwidth_for(hw)
    with _span("solver.solve_pareto", dims=list(gemm.dims), hw=hw.name):
        base = solve(gemm, hw, objective=objective,
                     spatial_mode=spatial_mode,
                     allowed_walk01=allowed_walk01, engine=engine)
        n_solves = 1
        cert0 = base.certificate
        if not cert0.feasible:
            pc = ParetoCertificate(
                gemm=gemm, hw_name=hw.name, objective_kind=objective,
                spatial_mode=cert0.spatial_mode, bandwidth=bw.as_tuple(),
                points=(), feasible=False,
                solve_time_s=time.perf_counter() - t0)
            return ParetoSolveResult(points=(), certificate=pc,
                                     n_solves=n_solves)
        # the base solve may have auto-fallen back (equality infeasible
        # => edp/le); constrained slices must live in the same family
        okind, mode = cert0.objective_kind, cert0.spatial_mode

        def mk_point(floor: int | None, res: SolveResult) -> ParetoPoint:
            rep = evaluate(gemm, res.mapping, hw, bw=bw)
            return ParetoPoint(min_pe=floor, mapping=res.mapping,
                               certificate=res.certificate,
                               energy_pj=rep.energy_pj,
                               delay_ns=rep.delay_ns, edp=rep.edp,
                               num_pe_used=rep.num_pe_used)

        candidates = [mk_point(None, base)]
        levels_total = levels_swept = 0
        if mode == "le":
            levels = [p for p in achievable_spatial_levels(gemm, hw.num_pe)
                      if p > base.mapping.num_pe_used]
            levels_total = len(levels)
            if max_points is not None and len(levels) > max_points:
                sel = np.unique(np.round(np.linspace(
                    0, len(levels) - 1, max_points)).astype(int))
                levels = [levels[i] for i in sel]
            levels_swept = len(levels)
            cur = base.mapping.num_pe_used
            for floor in levels:
                if floor <= cur:
                    continue   # already realized by a previous slice
                res = solve(gemm, hw, objective=okind, spatial_mode=mode,
                            allowed_walk01=allowed_walk01, engine=engine,
                            min_pe=floor)
                n_solves += 1
                if not res.certificate.feasible:
                    break      # feasibility is antitone in the floor
                candidates.append(mk_point(floor, res))
                cur = max(cur, res.mapping.num_pe_used)
        frontier = tuple(pareto_min(
            candidates, key_a=lambda q: q.energy_pj,
            key_b=lambda q: q.delay_ns, tie=lambda q: q.num_pe_used))
        pc = ParetoCertificate(
            gemm=gemm, hw_name=hw.name, objective_kind=okind,
            spatial_mode=mode, bandwidth=bw.as_tuple(), points=frontier,
            feasible=True, levels_total=levels_total,
            levels_swept=levels_swept, candidates_seen=len(candidates),
            solve_time_s=time.perf_counter() - t0)
        _REG.inc("solver.pareto.points", len(frontier))
        return ParetoSolveResult(points=frontier, certificate=pc,
                                 n_solves=n_solves)
