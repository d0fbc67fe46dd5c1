"""Mapper interface shared by GOMA and the five baselines (paper §V-A3).

Every mapper returns a `MapperResult`; E/T/EDP are always reported through
the unified oracle (`core.edp.evaluate`, backed by the loop-nest reference
model), mirroring the paper's methodology.  Baselines other than
Timeloop-Hybrid do not search residency/bypass — they use the hardware's
default chain (`hw_default_residency`), as in §V-A3.
"""
from __future__ import annotations

import abc
import dataclasses
import random
import time

from ..edp import EdpReport, evaluate
from ..geometry import AXES, Gemm, Mapping, divisor_chains
from ..hardware import AcceleratorSpec
from ..certificate import check_constraints
from ..timeloop_ref import reference_counts


@dataclasses.dataclass
class MapperResult:
    mapper: str
    gemm: Gemm
    hw_name: str
    mapping: Mapping | None
    report: EdpReport | None
    runtime_s: float
    evals: int
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def feasible(self) -> bool:
        return self.mapping is not None

    @property
    def edp(self) -> float:
        return self.report.edp if self.report else float("inf")


def hw_default_residency(hw: AcceleratorSpec) -> tuple[tuple, tuple]:
    """Hardware-specified residency for bypass-unaware baselines.

    SRAM holds everything it can; the regfile keeps datatypes in priority
    order P (accumulator), A, B while one word each still fits."""
    res1 = (True, True, True)
    order = [2, 1, 0]  # P, A, B by normal-axis index z,y,x
    keep = []
    budget = hw.rf_words
    for d in order:
        if budget >= 1:
            keep.append(d)
            budget -= 1
    res3 = tuple(i in keep for i in range(3))
    return res1, res3


class Mapper(abc.ABC):
    name = "base"

    def __init__(self, seed: int = 0, **params):
        self.seed = seed
        self.params = params

    @abc.abstractmethod
    def search(self, gemm: Gemm, hw: AcceleratorSpec) -> tuple[
            Mapping | None, int]:
        """Return (best mapping or None, #cost-model evaluations)."""

    def map(self, gemm: Gemm, hw: AcceleratorSpec) -> MapperResult:
        t0 = time.perf_counter()
        mapping, evals = self.search(gemm, hw)
        dt = time.perf_counter() - t0
        report = evaluate(gemm, mapping, hw) if mapping is not None else None
        return MapperResult(mapper=self.name, gemm=gemm, hw_name=hw.name,
                            mapping=mapping, report=report, runtime_s=dt,
                            evals=evals)


def oracle_energy(gemm: Gemm, m: Mapping, hw: AcceleratorSpec) -> float:
    """Search-time cost feedback used by the black-box baselines (they all
    query the reference model, as the real tools query timeloop-model)."""
    return reference_counts(gemm, m, full_reuse=True).energy(hw)


def oracle_edp(gemm: Gemm, m: Mapping, hw: AcceleratorSpec) -> float:
    return evaluate(gemm, m, hw).edp


def feasible(gemm: Gemm, m: Mapping, hw: AcceleratorSpec) -> bool:
    return check_constraints(gemm, m, hw, spatial_mode="le")


def _small_prime(n: int) -> int:
    for p in (2, 3, 5, 7, 11, 13):
        if n % p == 0:
            return p
    d = 17
    while d * d <= n:
        if n % d == 0:
            return d
        d += 2
    return n


def random_mapping(rng: random.Random, gemm: Gemm, hw: AcceleratorSpec,
                   *, search_bypass: bool, max_tries: int = 50
                   ) -> Mapping | None:
    """Random feasible mapping with constraint-aware repair (as
    timeloop-mapper's sampler shrinks violating tiles instead of
    rejecting outright)."""
    res1_d, res3_d = hw_default_residency(hw)
    for _ in range(max_tries):
        chains = [list(rng.choice(divisor_chains(gemm.dim(a))))
                  for a in AXES]
        if search_bypass:
            res1 = tuple(rng.random() < 0.8 for _ in range(3))
            res3 = tuple(rng.random() < 0.8 for _ in range(3))
        else:
            res1, res3 = res1_d, res3_d
        for _repair in range(64):
            l1 = [c[0] for c in chains]
            l2 = [c[1] for c in chains]
            l3 = [c[2] for c in chains]
            # spatial overflow: shrink a random l2 (keeping l3 | l2)
            sp = [a // b for a, b in zip(l2, l3)]
            if sp[0] * sp[1] * sp[2] > hw.num_pe:
                i = max(range(3), key=lambda j: sp[j])
                chains[i][1] //= _small_prime(sp[i])
                if chains[i][2] > chains[i][1]:
                    chains[i][2] = chains[i][1]
                continue
            # regfile overflow: shrink the largest l3
            rf = (res3[1] * l3[0] * l3[2] + res3[0] * l3[1] * l3[2]
                  + res3[2] * l3[0] * l3[1])
            if rf > hw.rf_words:
                i = max(range(3), key=lambda j: l3[j])
                if l3[i] == 1:
                    break
                chains[i][2] //= _small_prime(l3[i])
                continue
            # SRAM overflow: shrink the largest l1 (keeping l2 | l1)
            sram = (res1[1] * l1[0] * l1[2] + res1[0] * l1[1] * l1[2]
                    + res1[2] * l1[0] * l1[1])
            if sram > hw.sram_words:
                i = max(range(3), key=lambda j: l1[j])
                ratio = l1[i] // l2[i]
                if ratio == 1:
                    i = max(range(3), key=lambda j: l1[j] // l2[j])
                    ratio = l1[i] // l2[i]
                    if ratio == 1:
                        break
                chains[i][0] //= _small_prime(ratio)
                continue
            m = Mapping(
                L1=tuple(l1), L2=tuple(l2), L3=tuple(l3),
                alpha01=rng.choice(AXES), alpha12=rng.choice(AXES),
                res1=res1, res3=res3)
            if feasible(gemm, m, hw):
                return m
            break
    return None
