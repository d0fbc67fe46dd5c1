"""Timeloop-mapper (Hybrid)-style baseline: pruned random search.

Mechanism modeled on timeloop-mapper's hybrid threads: uniform random
sampling over (tiling chains x loop permutations x bypass bits), feasibility
rejection, and a *victory condition* — terminate after a window of
consecutive non-improving samples.  It is the only baseline that searches
bypass (paper §V-A3).  Cost feedback = the reference oracle, as the real
tool queries timeloop-model.
"""
from __future__ import annotations

import random

from ..geometry import Gemm, Mapping
from ..hardware import AcceleratorSpec
from .base import Mapper, oracle_edp, random_mapping


class TimeloopHybridMapper(Mapper):
    name = "timeloop-hybrid"

    def __init__(self, seed: int = 0, budget: int = 1500,
                 victory: int = 400):
        super().__init__(seed, budget=budget, victory=victory)
        self.budget = budget
        self.victory = victory

    def search(self, gemm: Gemm, hw: AcceleratorSpec):
        rng = random.Random((self.seed, gemm.dims, hw.name).__hash__())
        best: Mapping | None = None
        best_cost = float("inf")
        evals = 0
        since_improve = 0
        while evals < self.budget and since_improve < self.victory:
            m = random_mapping(rng, gemm, hw, search_bypass=hw.allow_bypass)
            if m is None:
                break
            evals += 1
            c = oracle_edp(gemm, m, hw)
            if c < best_cost:
                best, best_cost = m, c
                since_improve = 0
            else:
                since_improve += 1
        return best, evals
