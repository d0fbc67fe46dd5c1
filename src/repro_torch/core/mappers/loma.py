"""LOMA-style baseline: loop-order-based pruned enumeration.

Mechanism modeled on LOMA (AICAS'21): outer enumeration over loop orderings
(the walking-axis pair), inner enumeration over tiling allocations with
capacity pruning.  Exhaustive given unlimited time; practical runs use an
evaluation budget (the paper's "heuristic variants ... trade part of
optimality for usable search speed"), so solution quality degrades on
large spaces.  Bypass fixed to the hardware default.
"""
from __future__ import annotations

import itertools

from ..geometry import AXES, Gemm, Mapping, divisor_chains
from ..hardware import AcceleratorSpec
from .base import Mapper, feasible, hw_default_residency, oracle_edp


class LomaMapper(Mapper):
    name = "loma"

    def __init__(self, seed: int = 0, budget: int = 20000,
                 scan_factor: int = 40):
        super().__init__(seed, budget=budget)
        self.budget = budget
        self.scan_factor = scan_factor   # cap on visited (incl. infeasible)

    def search(self, gemm: Gemm, hw: AcceleratorSpec):
        res1, res3 = hw_default_residency(hw)
        best, best_cost = None, float("inf")
        evals = 0
        per_order = max(1, self.budget // 9)
        scan_cap = per_order * self.scan_factor
        # memory-allocation ordering (LOMA's loop-order-based allocation):
        # prefer SRAM tiles near the per-datatype capacity share, then
        # larger spatial fanout, then larger regfile tiles.
        import math
        t1 = max(2.0, math.sqrt(hw.sram_words / 3.0))
        # small regfile tiles first (feasible even on 1-word-RF templates),
        # near-balanced spatial fanout (cube root of the PE budget)
        starget = max(1.0, hw.num_pe ** (1.0 / 3.0))
        chains = {a: sorted(divisor_chains(gemm.dim(a)),
                            key=lambda c: (abs(math.log(c[0] / t1)), c[2],
                                           abs((c[1] // max(c[2], 1))
                                               - starget)))
                  for a in AXES}
        for a01, a12 in itertools.product(AXES, AXES):
            n = 0
            scanned = 0
            for cx in chains["x"]:
                if n >= per_order or scanned >= scan_cap:
                    break
                sx = cx[1] // max(cx[2], 1)
                if sx > hw.num_pe:
                    continue
                for cy in chains["y"]:
                    if n >= per_order or scanned >= scan_cap:
                        break
                    # capacity / fanout prune before expanding z
                    scanned += 1
                    if cx[0] * cy[0] > hw.sram_words:
                        continue
                    if sx * (cy[1] // max(cy[2], 1)) > hw.num_pe:
                        continue
                    for cz in chains["z"]:
                        if n >= per_order or scanned >= scan_cap:
                            break
                        scanned += 1
                        m = Mapping(
                            L1=(cx[0], cy[0], cz[0]),
                            L2=(cx[1], cy[1], cz[1]),
                            L3=(cx[2], cy[2], cz[2]),
                            alpha01=a01, alpha12=a12,
                            res1=res1, res3=res3)
                        if not feasible(gemm, m, hw):
                            continue
                        n += 1
                        evals += 1
                        c = oracle_edp(gemm, m, hw)
                        if c < best_cost:
                            best, best_cost = m, c
        return best, evals
