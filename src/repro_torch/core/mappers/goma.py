"""GOMA as a Mapper (the paper's contribution, wrapping core.solver)."""
from __future__ import annotations

from ..geometry import Gemm
from ..hardware import AcceleratorSpec
from ..solver import solve
from .base import Mapper


class GomaMapper(Mapper):
    """objective="edp" (default): globally optimal EDP over the full space
    including under-utilized spatial fanouts (eq. 29 relaxed to <=, leakage
    inside the objective) — certificate intact.  objective="energy" is the
    paper-faithful formulation (eq. 29 equality, energy objective; §V-A4
    argues the two coincide — bench_edp reports both so the cases where the
    relaxation wins are visible; see EXPERIMENTS.md).

    The reported ``evals`` is ``certificate.nodes_explored`` — an
    engine-specific search-node count (candidate pairs for the frontier
    engine, z-visits for the reference DFS), a throughput proxy not
    comparable across engines; compare wall time (BENCH_solver.json) for
    cross-engine/PR trajectories."""

    name = "goma"

    def __init__(self, seed: int = 0, objective: str = "edp",
                 engine: str | None = None):
        super().__init__(seed, objective=objective)
        self.objective = objective
        # None = core.solver.DEFAULT_ENGINE ("vectorized"); "reference"
        # selects the DFS oracle (benchmarks compare the two)
        self.engine = engine

    def search(self, gemm: Gemm, hw: AcceleratorSpec):
        if self.objective == "edp":
            res = solve(gemm, hw, objective="edp", spatial_mode="le",
                        engine=self.engine)
        else:
            res = solve(gemm, hw, objective="energy", engine=self.engine)
        self.last_certificate = res.certificate
        return res.mapping, res.certificate.nodes_explored

    def map(self, gemm, hw):
        out = super().map(gemm, hw)
        out.extra["certificate"] = self.last_certificate
        return out


class GomaEqMapper(GomaMapper):
    """Paper-faithful GOMA: energy objective under eq. 29 equality."""

    name = "goma-eq"

    def __init__(self, seed: int = 0):
        super().__init__(seed, objective="energy")
