"""CoSA-style baseline: mathematical programming on a *proxy* objective.

Mechanism modeled on CoSA (ISCA'21) and the first limitation the paper
identifies (§II-5): a *misaligned objective*.  CoSA optimizes surrogate
costs (resource utilization / buffer occupancy) rather than energy.  Here
the surrogate is solved exactly, lexicographically:

  1. maximize PE-array utilization (spatial fanout product),
  2. then minimize a naive traffic proxy sum_d V / L1_d — no walking-axis
     compression, no reduction-axis boundary, no bypass modeling,
  3. a second pass derives the loop permutation (best of the nine
     walking-axis pairs) and keeps hardware-default residency.

E/T/EDP are reported through the unified oracle like every mapper.  The
paper's second CoSA limitation (redundant prime-factor encoding slowing
large problems) concerns the original tool's solve times; our runtime
comparison therefore reports our reimplementations' wall-clock honestly
and checks scaling trends in benchmarks/bench_solver_scaling.py rather
than claiming the paper's absolute ratios (see EXPERIMENTS.md).
"""
from __future__ import annotations

from ..geometry import AXES, Gemm, Mapping, divisors
from ..hardware import AcceleratorSpec
from .base import Mapper, feasible, hw_default_residency, oracle_edp


class CosaLikeMapper(Mapper):
    name = "cosa"

    def __init__(self, seed: int = 0):
        super().__init__(seed)

    def search(self, gemm: Gemm, hw: AcceleratorSpec):
        res1, res3 = hw_default_residency(hw)
        evals = 0

        # --- stage 1: maximize PE utilization ----------------------------
        # spatial options per axis: s_d = L2_d/L3_d must divide L0_d
        s_opts = {a: sorted(divisors(gemm.dim(a))) for a in AXES}
        best_npe = 0
        best_sp: list[tuple[int, int, int]] = []
        for sx in s_opts["x"]:
            if sx > hw.num_pe:
                break
            for sy in s_opts["y"]:
                if sx * sy > hw.num_pe:
                    break
                for sz in s_opts["z"]:
                    npe = sx * sy * sz
                    if npe > hw.num_pe:
                        break
                    evals += 1
                    if npe > best_npe:
                        best_npe, best_sp = npe, [(sx, sy, sz)]
                    elif npe == best_npe:
                        best_sp.append((sx, sy, sz))
        if not best_sp:
            return None, evals

        # --- stage 2: minimize naive traffic proxy under SRAM capacity ---
        best_key, best_cfg = None, None
        for sp in best_sp:
            # L1 candidates per axis: must admit a chain through s_d
            l1c = {a: sorted((v for v in divisors(gemm.dim(a))
                              if v % sp[i] == 0), reverse=True)
                   for i, a in enumerate(AXES)}
            for l1x in l1c["x"]:
                for l1y in l1c["y"]:
                    if l1x * l1y > hw.sram_words:
                        continue
                    for l1z in l1c["z"]:
                        evals += 1
                        occ = l1x * l1z + l1y * l1z + l1x * l1y
                        if occ > hw.sram_words:
                            continue
                        traffic = (gemm.volume / l1x + gemm.volume / l1y
                                   + gemm.volume / l1z)
                        key = (traffic, -occ)
                        if best_key is None or key < best_key:
                            best_key = key
                            best_cfg = (sp, (l1x, l1y, l1z))
                        break  # l1z sorted desc: first feasible is best
        if best_cfg is None:
            return None, evals
        sp, l1 = best_cfg
        # regfile tiles: smallest chain (L3 = 1), L2 = spatial fanout
        l2 = tuple(sp)
        l3 = (1, 1, 1)

        # --- permutation pass (oracle-scored, as CoSA's scheduling pass) --
        best, best_cost = None, float("inf")
        for a01 in AXES:
            for a12 in AXES:
                m = Mapping(L1=l1, L2=l2, L3=l3, alpha01=a01, alpha12=a12,
                            res1=res1, res3=res3)
                if not feasible(gemm, m, hw):
                    continue
                evals += 1
                c = oracle_edp(gemm, m, hw)
                if c < best_cost:
                    best, best_cost = m, c
        return best, evals
