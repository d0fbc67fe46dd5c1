"""Joint (mesh partition, per-chip tiling) solve with zero-gap certificate.

The paper's walking-axis argument, applied one level above DRAM: a mesh
factorization (cx, cy, cz) with cx*cy*cz = n_chips tiles the GEMM's
compute grid spatially across chips — each chip owns the sub-problem
(Lx/cx, Ly/cy, Lz/cz), and the ring collectives of the partition move
exactly the projection areas that change when walking each mesh axis
(core.dist_mapping.collective_words).  The joint objective per chip is

    E(counts) = link_energy(sub_gemm, chip_mapping, hw)       # on-chip pJ
              + collective_energy(gemm, counts, hw)           # ICI pJ

and the search space is the full divisor lattice of n_chips restricted
to counts that divide the GEMM dims (the mesh-level analogue of the
paper's eq. 4 divisor-chain constraint).  Every branch's on-chip term is
an exact zero-gap ``core.solver.solve`` and the ICI term is closed form,
so exhaustive enumeration yields UB == LB: the certificate brackets the
true joint optimum with zero gap.

Soundness of the joint-vs-independent gate: the *independent*
composition — pick a single mesh axis by ICI bytes alone
(dist_mapping ranking, first choice that divides), then tile the
resulting sub-problem optimally — is itself one of the enumerated
branches, so ``objective <= independent_objective`` is a theorem, not an
observation.  Mixed factorizations can be strictly cheaper (for
words_A == words_B = w, (2,2,1) moves w/2 over ICI vs 0.75*w for any
single axis), which is exactly the win the benchmark measures.
"""
from __future__ import annotations

import dataclasses
import time

from ..core.certificate import Certificate, check_constraints
from ..core.dist_mapping import (collective_energy, describe_collectives,
                                 plan_shard_axis)
from ..core.fusion import link_energy
from ..core.geometry import Gemm, Mapping, divisors
from ..core.hardware import AcceleratorSpec
from ..core.solver import DEFAULT_ENGINE, SolveResult, solve
from ..obs.registry import get_registry
from ..obs.tracing import get_tracer

_REG = get_registry()

# jax.sharding axis names for the three mesh rings; chosen to line up
# with sharding/rules.py ("data" batch ring, "model" TP ring) so pure-x
# partitions reproduce the DP specs and pure-y partitions the TP specs.
AXIS_NAMES = ("data", "model", "reduce")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A chip-mesh factorization: counts[i] chips walk GEMM axis 'xyz'[i]."""

    counts: tuple[int, int, int]          # (cx, cy, cz)

    @property
    def n_chips(self) -> int:
        cx, cy, cz = self.counts
        return cx * cy * cz

    @property
    def axis_names(self) -> tuple[str, ...]:
        """Mesh axis names for the rings actually present (count > 1)."""
        return tuple(n for n, c in zip(AXIS_NAMES, self.counts) if c > 1)

    def describe(self) -> str:
        cx, cy, cz = self.counts
        return f"mesh(x{cx} * y{cy} * z{cz})"


def enumerate_partitions(gemm: Gemm, n_chips: int
                         ) -> list[tuple[int, int, int]]:
    """All ordered factorizations (cx, cy, cz) of n_chips whose counts
    divide the matching GEMM dims — the outer-level divisor-chain
    constraint (sub-problems must stay integral)."""
    out = []
    for cx in divisors(n_chips):
        if gemm.Lx % cx:
            continue
        rest = n_chips // cx
        for cy in divisors(rest):
            if gemm.Ly % cy:
                continue
            cz = rest // cy
            if gemm.Lz % cz:
                continue
            out.append((cx, cy, cz))
    return out


def partition_specs(counts: tuple[int, int, int]) -> dict[str, tuple]:
    """jax.sharding.PartitionSpec layouts (as JSON-able tuples of axis
    name | None) for the three operands under partition ``counts``.

    A is (M, K) = (x, z); B is stored (K, N) = (z, y) — the jax weight
    convention, matching sharding/rules.py; P is (M, N) = (x, y).  A
    pure-y partition yields B: (None, "model"), P: (None, "model") —
    exactly the TP rules — and a pure-x partition the DP batch specs.
    """
    cx, cy, cz = counts
    x = AXIS_NAMES[0] if cx > 1 else None
    y = AXIS_NAMES[1] if cy > 1 else None
    z = AXIS_NAMES[2] if cz > 1 else None
    return {"A": (x, z), "B": (z, y), "P": (x, y)}


@dataclasses.dataclass(frozen=True)
class ShardedCertificate:
    """Zero-gap certificate for one joint (partition, tiling) solve.

    ``objective`` is absolute per-chip pJ: on-chip link energy of the
    sub-GEMM under its optimal mapping + per-chip ring-collective ICI
    energy.  Per-chip (not aggregate) keeps partitions comparable at
    fixed n_chips, and n_chips == 1 degenerates to the single-chip
    absolute energy (collective term exactly 0).
    """

    gemm_dims: tuple[int, int, int]
    gemm_name: str
    hw_name: str
    n_chips: int
    dtype_bytes: int
    counts: tuple[int, int, int] | None   # None iff infeasible
    collectives: str                      # describe_collectives() of counts
    objective: float                      # joint optimum, per-chip pJ
    upper_bound: float
    lower_bound: float
    chip_pj: float                        # on-chip share of objective
    collective_pj: float                  # ICI share of objective
    independent_objective: float          # best single-axis composition
    independent_counts: tuple[int, int, int] | None
    feasible: bool
    n_solves: int                         # per-chip solves performed
    n_partitions: int                     # factorizations enumerated
    solve_time_s: float
    engine: str
    objective_kind: str = "energy"
    chip_certificate: Certificate | None = None

    @property
    def gap(self) -> float:
        if self.upper_bound == float("inf"):
            return float("inf")
        return self.upper_bound - self.lower_bound

    @property
    def savings(self) -> float:
        """Fractional win of the joint solve over the independent
        (single-axis sharding x per-chip tiling) composition; 0.0 when
        the independent choice is already jointly optimal or when no
        single axis divides."""
        if (not self.feasible
                or self.independent_objective in (0.0, float("inf"))):
            return 0.0
        return 1.0 - self.objective / self.independent_objective

    def summary(self) -> str:
        if not self.feasible:
            return (f"{self.gemm_name}@{self.hw_name} x{self.n_chips}: "
                    f"infeasible ({self.n_partitions} partitions)")
        mesh = MeshSpec(self.counts).describe()
        return (f"{self.gemm_name}@{self.hw_name} x{self.n_chips}: "
                f"{mesh} [{self.collectives}] {self.objective:.3e} pJ/chip "
                f"(chip {self.chip_pj:.3e} + ici {self.collective_pj:.3e}; "
                f"vs independent {self.independent_objective:.3e}, "
                f"saves {100 * self.savings:.1f}%)")


@dataclasses.dataclass
class ShardedSolveResult:
    mapping: Mapping | None               # per-chip mapping of the optimum
    certificate: ShardedCertificate
    chip_result: SolveResult | None = None

    @property
    def mesh(self) -> MeshSpec | None:
        c = self.certificate.counts
        return MeshSpec(c) if c is not None else None

    @property
    def specs(self) -> dict[str, tuple] | None:
        c = self.certificate.counts
        return partition_specs(c) if c is not None else None


def sub_gemm(gemm: Gemm, counts: tuple[int, int, int]) -> Gemm:
    cx, cy, cz = counts
    return Gemm(gemm.Lx // cx, gemm.Ly // cy, gemm.Lz // cz,
                f"{gemm.name}/x{cx}y{cy}z{cz}")


def _independent_counts(gemm: Gemm, n_chips: int,
                        dtype_bytes: int) -> tuple[int, int, int] | None:
    """The baseline composition's partition: the cheapest single-axis
    choice by ICI bytes alone (dist_mapping ranking) among those whose
    axis dim is divisible — sharding chosen with no view of the on-chip
    tiling cost."""
    for choice in plan_shard_axis(gemm, n_chips, dtype_bytes=dtype_bytes):
        i = "xyz".index(choice.axis)
        if gemm.dims[i] % n_chips == 0:
            counts = [1, 1, 1]
            counts[i] = n_chips
            return tuple(counts)
    return None


def solve_sharded(gemm: Gemm, hw: AcceleratorSpec, n_chips: int, *,
                  dtype_bytes: int = 1,
                  objective: str = "energy",
                  spatial_mode: str | None = None,
                  allowed_walk01: tuple[str, ...] | None = None,
                  engine: str | None = None,
                  chip_solve=None) -> ShardedSolveResult:
    """Jointly optimal (mesh partition, per-chip mapping) for ``gemm``
    on ``n_chips`` copies of ``hw``; see the module docstring for the
    objective and the zero-gap / joint<=independent argument.

    ``chip_solve`` (optional) replaces the per-branch single-chip solve
    — planner.batch passes a store-backed ``cached_solve`` closure so
    every branch's sub-plan lands in (or is served from) the plan
    database.  It must accept (gemm, hw, *, objective, spatial_mode,
    allowed_walk01) and return a ``SolveResult``.
    """
    _REG.inc("dist.solves")
    tr = get_tracer()
    if tr is None:
        return _solve_sharded_impl(
            gemm, hw, n_chips, dtype_bytes=dtype_bytes, objective=objective,
            spatial_mode=spatial_mode, allowed_walk01=allowed_walk01,
            engine=engine, chip_solve=chip_solve)
    with tr.span("dist.solve_sharded", gemm=list(gemm.dims),
                 hw=hw.name, n_chips=n_chips):
        return _solve_sharded_impl(
            gemm, hw, n_chips, dtype_bytes=dtype_bytes, objective=objective,
            spatial_mode=spatial_mode, allowed_walk01=allowed_walk01,
            engine=engine, chip_solve=chip_solve)


def _solve_sharded_impl(gemm, hw, n_chips, *, dtype_bytes, objective,
                        spatial_mode, allowed_walk01, engine, chip_solve):
    if objective != "energy":
        raise ValueError(
            "solve_sharded prices collectives in absolute pJ and needs the "
            "per-chip term in the same currency; only objective='energy' "
            f"is supported (got {objective!r})")
    if n_chips < 1:
        raise ValueError(f"n_chips must be >= 1, got {n_chips}")
    t0 = time.perf_counter()
    eng = engine if engine is not None else DEFAULT_ENGINE

    def _solve_one(sub: Gemm) -> SolveResult:
        if chip_solve is not None:
            return chip_solve(sub, hw, objective=objective,
                              spatial_mode=spatial_mode,
                              allowed_walk01=allowed_walk01)
        return solve(sub, hw, objective=objective, spatial_mode=spatial_mode,
                     allowed_walk01=allowed_walk01, engine=engine)

    partitions = enumerate_partitions(gemm, n_chips)
    ind_counts = _independent_counts(gemm, n_chips, dtype_bytes)

    best = float("inf")
    best_counts = None
    best_chip = None           # (SolveResult, chip_pj, coll_pj)
    independent = float("inf")
    n_solves = 0
    chip_cache: dict[tuple[int, int, int], tuple[SolveResult, float]] = {}
    for counts in partitions:
        sub = sub_gemm(gemm, counts)
        if sub.dims in chip_cache:
            res, chip_pj = chip_cache[sub.dims]
        else:
            res = _solve_one(sub)
            n_solves += 1
            chip_pj = (link_energy(sub, res.mapping, hw)
                       if res.mapping is not None else float("inf"))
            chip_cache[sub.dims] = (res, chip_pj)
        if res.mapping is None:
            continue
        coll_pj = collective_energy(gemm, counts, hw,
                                    dtype_bytes=dtype_bytes)
        total = chip_pj + coll_pj
        if counts == ind_counts:
            independent = total
        if total < best:
            best, best_counts = total, counts
            best_chip = (res, chip_pj, coll_pj)

    dt = time.perf_counter() - t0
    if best_counts is None:
        _REG.inc("dist.infeasible")
        cert = ShardedCertificate(
            gemm_dims=gemm.dims, gemm_name=gemm.name, hw_name=hw.name,
            n_chips=n_chips, dtype_bytes=dtype_bytes, counts=None,
            collectives="", objective=float("inf"),
            upper_bound=float("inf"), lower_bound=float("inf"),
            chip_pj=float("inf"), collective_pj=float("inf"),
            independent_objective=independent, independent_counts=ind_counts,
            feasible=False, n_solves=n_solves,
            n_partitions=len(partitions), solve_time_s=dt, engine=eng)
        return ShardedSolveResult(mapping=None, certificate=cert)

    res, chip_pj, coll_pj = best_chip
    cert = ShardedCertificate(
        gemm_dims=gemm.dims, gemm_name=gemm.name, hw_name=hw.name,
        n_chips=n_chips, dtype_bytes=dtype_bytes, counts=best_counts,
        collectives=describe_collectives(gemm, best_counts),
        objective=best, upper_bound=best, lower_bound=best,
        chip_pj=chip_pj, collective_pj=coll_pj,
        independent_objective=independent, independent_counts=ind_counts,
        feasible=True, n_solves=n_solves, n_partitions=len(partitions),
        solve_time_s=dt, engine=eng,
        chip_certificate=res.certificate)
    return ShardedSolveResult(mapping=res.mapping, certificate=cert,
                              chip_result=res)


def verify_sharded(cert: ShardedCertificate, hw: AcceleratorSpec,
                   mapping: Mapping | None) -> bool:
    """Independent re-check of a joint certificate: the per-chip mapping
    is feasible for the claimed sub-problem, the claimed objective
    re-derives as on-chip + collective energy, the bracket is zero-gap,
    and the joint optimum does not exceed the independent composition.
    Mirrors fusion.verify_chain; O(1) — no solver invocation."""
    if hw.name != cert.hw_name:
        return False
    if not cert.feasible:
        return (mapping is None and cert.counts is None
                and cert.objective == float("inf"))
    if mapping is None or cert.counts is None:
        return False
    cx, cy, cz = cert.counts
    if cx * cy * cz != cert.n_chips:
        return False
    gemm = Gemm(*cert.gemm_dims, cert.gemm_name)
    if gemm.Lx % cx or gemm.Ly % cy or gemm.Lz % cz:
        return False
    sub = sub_gemm(gemm, cert.counts)
    # per-chip feasibility under the solve's (or the less strict "le")
    # spatial regime — stored certs don't record spatial_mode, so accept
    # either, like chain verification does for equality-fallback links
    if not (check_constraints(sub, mapping, hw, spatial_mode=None)
            or check_constraints(sub, mapping, hw, spatial_mode="le")):
        return False
    chip_pj = link_energy(sub, mapping, hw)
    coll_pj = collective_energy(gemm, cert.counts, hw,
                                dtype_bytes=cert.dtype_bytes)
    tol = 1e-9 * max(1.0, abs(cert.objective))
    if abs(chip_pj - cert.chip_pj) > tol:
        return False
    if abs(coll_pj - cert.collective_pj) > tol:
        return False
    if abs((chip_pj + coll_pj) - cert.objective) > tol:
        return False
    if cert.gap != 0.0:
        return False
    if cert.independent_objective != float("inf") and \
            cert.objective > cert.independent_objective + tol:
        return False
    return True
