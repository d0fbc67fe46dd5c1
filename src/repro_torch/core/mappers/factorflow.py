"""FactorFlow-style baseline: greedy factor allocation + local search.

Mechanism modeled on FactorFlow (ASPDAC'25): start from a greedy seed
(all factors resident in SRAM, capacity-repaired; spatial fanout filled
greedily), then steepest-descent local search moving one prime factor at a
time between adjacent levels of one axis, re-deriving the best walking
axes each round.  Terminates at a local optimum — the adaptive-programming
analog.  Bypass fixed to the hardware default.
"""
from __future__ import annotations

from ..geometry import AXES, Gemm, Mapping
from ..hardware import AcceleratorSpec
from .base import Mapper, feasible, hw_default_residency, oracle_edp


def _primes(n: int) -> list[int]:
    out = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


class FactorFlowMapper(Mapper):
    name = "factorflow"

    def __init__(self, seed: int = 0, max_rounds: int = 200):
        super().__init__(seed, max_rounds=max_rounds)
        self.max_rounds = max_rounds

    def _seed_mapping(self, gemm: Gemm, hw: AcceleratorSpec,
                      res1, res3) -> Mapping | None:
        # all factors at SRAM, shrink largest axis until capacity fits
        l1 = list(gemm.dims)
        while (l1[0] * l1[2] + l1[1] * l1[2] + l1[0] * l1[1]
               > hw.sram_words):
            i = max(range(3), key=lambda j: l1[j])
            ps = _primes(l1[i])
            if not ps:
                return None
            l1[i] //= max(ps)
            if l1[i] == 0:
                return None
        # fill spatial fanout greedily from L1 factors
        l2 = [1, 1, 1]
        npe = 1
        changed = True
        while changed:
            changed = False
            for i in range(3):
                for p in sorted(_primes(l1[i] // l2[i])):
                    if npe * p <= hw.num_pe:
                        l2[i] *= p
                        npe *= p
                        changed = True
                        break
        m = Mapping(L1=tuple(l1), L2=tuple(l2), L3=(1, 1, 1),
                    alpha01="y", alpha12="y", res1=res1, res3=res3)
        return m if feasible(gemm, m, hw) else None

    def search(self, gemm: Gemm, hw: AcceleratorSpec):
        res1, res3 = hw_default_residency(hw)
        evals = 0
        cur = self._seed_mapping(gemm, hw, res1, res3)
        if cur is None:
            return None, evals
        cur_cost = oracle_edp(gemm, cur, hw)
        evals += 1

        def moves(m: Mapping):
            tiles = [list(m.L1), list(m.L2), list(m.L3)]
            outer_of = lambda lv, i: (gemm.dims[i] if lv == 0
                                      else tiles[lv - 1][i])
            for i in range(3):
                for lv in range(3):
                    # grow tile at level lv by a prime of the outer ratio
                    for p in set(_primes(outer_of(lv, i) // tiles[lv][i])):
                        t = [list(r) for r in tiles]
                        t[lv][i] *= p
                        yield t
                    # shrink by a prime of the inner ratio
                    inner = 1 if lv == 2 else tiles[lv + 1][i]
                    for p in set(_primes(tiles[lv][i] // inner)):
                        t = [list(r) for r in tiles]
                        t[lv][i] //= p
                        yield t

        for _ in range(self.max_rounds):
            best_m, best_c = None, cur_cost
            for t in moves(cur):
                for a01 in AXES:
                    for a12 in AXES:
                        m = Mapping(L1=tuple(t[0]), L2=tuple(t[1]),
                                    L3=tuple(t[2]), alpha01=a01,
                                    alpha12=a12, res1=res1, res3=res3)
                        if not feasible(gemm, m, hw):
                            continue
                        evals += 1
                        c = oracle_edp(gemm, m, hw)
                        if c < best_c:
                            best_m, best_c = m, c
            if best_m is None:
                break
            cur, cur_cost = best_m, best_c
        return cur, evals
