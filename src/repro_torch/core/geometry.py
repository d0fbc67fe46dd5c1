"""Geometric abstraction of GEMM mapping (paper §III–IV.A).

A GEMM ``P(x,y) = sum_z A(x,z) B(y,z)`` is a 3-D compute grid
``G = [Lx] x [Ly] x [Lz]``.  The three operands are the orthogonal
projections of ``G``:

    normal x  <->  B   (y-z projection)
    normal y  <->  A   (x-z projection)
    normal z  <->  P   (x-y projection; the reduction axis)

A *mapping* is a hierarchical tiling of ``G`` over the 5-level hierarchy
(DRAM=0, SRAM=1, PE-array=2, regfile=3, MACC=4), a walking axis per
temporal stage (alpha_{0-1}, alpha_{1-2}: the innermost advancing loop of
that stage) and per-axis residency bits at SRAM and regfile (paper's
bypass matrix B, eq. 7-8; here called ``res`` to avoid clashing with the
B operand).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Iterator, Sequence

AXES = ("x", "y", "z")
AXIS_INDEX = {"x": 0, "y": 1, "z": 2}
# Datatype associated with each normal axis (paper §IV.A.1).
NORMAL_TO_OPERAND = {"x": "B", "y": "A", "z": "P"}
LEVELS = ("DRAM", "SRAM", "PE-array", "regfile", "MACC")


@dataclasses.dataclass(frozen=True)
class Gemm:
    """A GEMM workload: the global compute-grid extents (eq. 1-2)."""

    Lx: int  # M   rows of P (and of A)
    Ly: int  # N   cols of P (rows of B in the B(y,z) convention)
    Lz: int  # K   reduction extent
    name: str = ""

    def __post_init__(self):
        if min(self.Lx, self.Ly, self.Lz) < 1:
            raise ValueError(f"GEMM extents must be >= 1: {self}")

    @property
    def dims(self) -> tuple[int, int, int]:
        return (self.Lx, self.Ly, self.Lz)

    @property
    def volume(self) -> int:
        """V = total MAC count (eq. 5)."""
        return self.Lx * self.Ly * self.Lz

    def dim(self, axis: str) -> int:
        return self.dims[AXIS_INDEX[axis]]

    # word counts of the three operand projections
    @property
    def words_A(self) -> int:
        return self.Lx * self.Lz

    @property
    def words_B(self) -> int:
        return self.Ly * self.Lz

    @property
    def words_P(self) -> int:
        return self.Lx * self.Ly


@dataclasses.dataclass(frozen=True)
class Mapping:
    """A full mapping point (decision variables of eq. 34).

    ``L1``/``L2``/``L3`` are (x, y, z) tile extents at SRAM / PE-array /
    regfile.  Level 0 extents are the GEMM dims; level 4 is (1, 1, 1).
    ``res1[d]`` / ``res3[d]`` are the residency (non-bypass) bits of the
    datatype with normal axis d at SRAM / regfile.  DRAM, PE-array and
    MACC never bypass (eq. 8).
    """

    L1: tuple[int, int, int]
    L2: tuple[int, int, int]
    L3: tuple[int, int, int]
    alpha01: str
    alpha12: str
    res1: tuple[bool, bool, bool] = (True, True, True)
    res3: tuple[bool, bool, bool] = (True, True, True)

    def __post_init__(self):
        if self.alpha01 not in AXES or self.alpha12 not in AXES:
            raise ValueError(f"walking axes must be in {AXES}: {self}")

    def tiles(self, level: int) -> tuple[int, int, int]:
        return {1: self.L1, 2: self.L2, 3: self.L3}[level]

    def ratio(self, axis: str, outer: int, inner: int, gemm: Gemm) -> int:
        """L-hat between two levels along one axis (eq. 4)."""
        d = AXIS_INDEX[axis]
        levels = {0: gemm.dims, 1: self.L1, 2: self.L2, 3: self.L3,
                  4: (1, 1, 1)}
        num, den = levels[outer][d], levels[inner][d]
        if num % den:
            raise ValueError(
                f"divisibility violated on axis {axis} between levels "
                f"{outer}/{inner}: {num} % {den} != 0")
        return num // den

    @property
    def spatial(self) -> tuple[int, int, int]:
        """Per-axis PE-array fanout L-hat^(2-3)."""
        return tuple(l2 // l3 for l2, l3 in zip(self.L2, self.L3))

    @property
    def num_pe_used(self) -> int:
        sx, sy, sz = self.spatial
        return sx * sy * sz

    def validate(self, gemm: Gemm) -> None:
        """Check divisibility nesting (eq. 4) — raises on violation."""
        for axis in AXES:
            d = AXIS_INDEX[axis]
            chain = (gemm.dims[d], self.L1[d], self.L2[d], self.L3[d], 1)
            for outer, inner in zip(chain, chain[1:]):
                if inner < 1 or outer % inner:
                    raise ValueError(
                        f"invalid divisor chain on axis {axis}: {chain}")

    def describe(self, gemm: Gemm) -> str:
        rows = [f"GEMM {gemm.name or ''} (M,N,K)=({gemm.Lx},{gemm.Ly},{gemm.Lz})"]
        rows.append(f"  SRAM tile    L1={self.L1}  walk(0-1)={self.alpha01}")
        rows.append(f"  array tile   L2={self.L2}  walk(1-2)={self.alpha12}")
        rows.append(f"  regfile tile L3={self.L3}  spatial={self.spatial} "
                    f"(#PE={self.num_pe_used})")
        res = lambda bits: "".join(
            NORMAL_TO_OPERAND[a] if b else "-" for a, b in zip(AXES, bits))
        rows.append(f"  resident@SRAM={res(self.res1)}  @RF={res(self.res3)}")
        return "\n".join(rows)


# ---------------------------------------------------------------------------
# divisor-lattice utilities
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def divisors(n: int) -> tuple[int, ...]:
    """Sorted divisors of n."""
    small, large = [], []
    i = 1
    while i * i <= n:
        if n % i == 0:
            small.append(i)
            if i != n // i:
                large.append(n // i)
        i += 1
    return tuple(small + large[::-1])


@functools.lru_cache(maxsize=1024)
def divisor_chains(n: int, length: int = 3) -> tuple[tuple[int, ...], ...]:
    """All non-increasing divisor chains (l_1 >= l_2 >= ... >= l_len) with
    l_len | ... | l_1 | n.  Chain element i is the tile extent at level i+1,
    so for GOMA: (L1, L2, L3) per axis."""
    if length == 0:
        return ((),)
    out = []
    for d in divisors(n):
        for rest in divisor_chains(d, length - 1):
            out.append((d,) + rest)
    return tuple(out)


def num_divisor_chains(n: int, length: int = 3) -> int:
    return len(divisor_chains(n, length))


def enumerate_mappings(gemm: Gemm,
                       *,
                       search_bypass: bool = True,
                       max_count: int | None = None) -> Iterator[Mapping]:
    """Exhaustive mapping enumeration (for brute-force oracles and tests).

    Yields every (tiling x walking-axes x residency) combination satisfying
    divisibility.  Capacity / PE constraints are NOT applied here — callers
    filter with `solver.check_constraints`.
    """
    chains = [divisor_chains(gemm.dim(a)) for a in AXES]
    res_opts = [(True,), (True,)] if not search_bypass else None
    bools = (False, True)
    count = 0
    for cx in chains[0]:
        for cy in chains[1]:
            for cz in chains[2]:
                L1 = (cx[0], cy[0], cz[0])
                L2 = (cx[1], cy[1], cz[1])
                L3 = (cx[2], cy[2], cz[2])
                for a01 in AXES:
                    for a12 in AXES:
                        if search_bypass:
                            res_iter = (
                                ((r1x, r1y, r1z), (r3x, r3y, r3z))
                                for r1x in bools for r1y in bools
                                for r1z in bools for r3x in bools
                                for r3y in bools for r3z in bools)
                        else:
                            res_iter = ((((True,) * 3), ((True,) * 3)),)
                        for res1, res3 in res_iter:
                            yield Mapping(L1, L2, L3, a01, a12, res1, res3)
                            count += 1
                            if max_count is not None and count >= max_count:
                                return


def mapping_space_size(gemm: Gemm, *, search_bypass: bool = True) -> int:
    """|mapping space| before hardware constraints (for reporting)."""
    n = 1
    for a in AXES:
        n *= num_divisor_chains(gemm.dim(a))
    n *= 9  # walking axes
    if search_bypass:
        n *= 64  # residency bits
    return n


def canonical_walk(gemm: Gemm, m: Mapping) -> Mapping:
    """Fold walking-axis encoding aliases (timeloop semantics).

    A stage whose walking axis has trip count 1 executes identically to
    walking the innermost non-unit loop of that stage (unit loops are not
    loops).  The closed form prices such aliases conservatively; every
    physical execution has a canonical encoding — returned here — on which
    the closed form is exact outside the cross-stage-reuse tail (see
    energy.closed_form_is_exact)."""
    def canon(trips: tuple[int, int, int], walk: str) -> str:
        w = AXIS_INDEX[walk]
        if trips[w] > 1:
            return walk
        order = [i for i in range(3) if i != w] + [w]   # outer -> inner
        for i in reversed(order):
            if trips[i] > 1:
                return AXES[i]
        return walk
    r01 = tuple(gemm.dims[i] // m.L1[i] for i in range(3))
    r12 = tuple(m.L1[i] // m.L2[i] for i in range(3))
    a01 = canon(r01, m.alpha01)
    a12 = canon(r12, m.alpha12)
    if (a01, a12) == (m.alpha01, m.alpha12):
        return m
    return dataclasses.replace(m, alpha01=a01, alpha12=a12)


def pad_to_divisor_rich(n: int, *, overhead: float = 0.10) -> int:
    """Smallest m >= n within (1+overhead)*n maximizing divisor count.

    Optional preprocessing for prime-ish dims (off by default — the paper's
    eq. 4 divisibility semantics are the default)."""
    best, best_tau = n, len(divisors(n))
    m = n
    while m <= int(n * (1 + overhead)) + 1:
        tau = len(divisors(m))
        if tau > best_tau:
            best, best_tau = m, tau
        m += 1
    return best
