"""SALSA-style baseline: simulated-annealing loop-ordering scheduler.

Mechanism modeled on SALSA (AICAS'23): a state is (per-axis divisor chains,
walking axes); neighbors perturb one tile extent along its divisor lattice
or flip a walking axis; Metropolis acceptance with geometric cooling and a
few restarts.  Bypass is fixed to the hardware default (paper §V-A3).
"""
from __future__ import annotations

import math
import random

from ..geometry import AXES, Gemm, Mapping, divisors
from ..hardware import AcceleratorSpec
from .base import Mapper, feasible, oracle_edp, random_mapping


def _neighbor(rng: random.Random, gemm: Gemm, m: Mapping) -> Mapping:
    kind = rng.random()
    if kind < 0.15:
        return Mapping(m.L1, m.L2, m.L3, rng.choice(AXES), m.alpha12,
                       m.res1, m.res3)
    if kind < 0.30:
        return Mapping(m.L1, m.L2, m.L3, m.alpha01, rng.choice(AXES),
                       m.res1, m.res3)
    d = rng.randrange(3)
    level = rng.randrange(3)        # 0->L1, 1->L2, 2->L3
    tiles = [list(m.L1), list(m.L2), list(m.L3)]
    outer = gemm.dims[d] if level == 0 else tiles[level - 1][d]
    inner = 1 if level == 2 else tiles[level + 1][d]
    opts = [v for v in divisors(outer) if v % inner == 0]
    tiles[level][d] = rng.choice(opts)
    return Mapping(tuple(tiles[0]), tuple(tiles[1]), tuple(tiles[2]),
                   m.alpha01, m.alpha12, m.res1, m.res3)


class SalsaMapper(Mapper):
    name = "salsa"

    def __init__(self, seed: int = 0, iters: int = 2500, restarts: int = 2,
                 t0_frac: float = 0.3, cooling: float = 0.995):
        super().__init__(seed, iters=iters, restarts=restarts)
        self.iters = iters
        self.restarts = restarts
        self.t0_frac = t0_frac
        self.cooling = cooling

    def search(self, gemm: Gemm, hw: AcceleratorSpec):
        rng = random.Random((self.seed, gemm.dims, hw.name).__hash__())
        best, best_cost = None, float("inf")
        evals = 0
        for _ in range(self.restarts):
            cur = random_mapping(rng, gemm, hw, search_bypass=False)
            if cur is None:
                continue
            cur_cost = oracle_edp(gemm, cur, hw)
            evals += 1
            temp = cur_cost * self.t0_frac
            for _ in range(self.iters):
                cand = _neighbor(rng, gemm, cur)
                if not feasible(gemm, cand, hw):
                    continue
                c = oracle_edp(gemm, cand, hw)
                evals += 1
                if c < cur_cost or (temp > 0 and
                                    rng.random() < math.exp(
                                        (cur_cost - c) / temp)):
                    cur, cur_cost = cand, c
                temp *= self.cooling
                if cur_cost < best_cost:
                    best, best_cost = cur, cur_cost
        return best, evals
