"""Batch planner: whole-model GEMM extraction, dedup, parallel solving.

Turns a model scenario (prefill sequence sweep + decode step shapes) into
a populated plan store and a ``ModelMappingManifest``:

  1. extract every (type, Gemm, weight) via ``core.workloads``;
  2. deduplicate by content-addressed plan key (a prefill sweep of one
     model collapses to a handful of distinct shapes per seq);
  3. serve hits from the store; solve misses in parallel with a process
     pool, optionally warm-starting branch-and-bound with the best cached
     near-neighbor objective as the initial incumbent UB (sound: the
     solver re-solves cold if the incumbent over-prunes, see
     ``core.solver.solve``);
  4. write every fresh solve back and emit the manifest artifact.

Also hosts the read-through primitives consumed by
``core.hopper_mapping`` and ``serving.Engine``: ``cached_solve``
(store-backed ``solve``), ``prewarm_tpu_plans`` and
``tile_plan_from_store`` (manifest/store-driven kernel tile plans with zero
solver invocations).  The prewarm helpers keep the reference's names and
plan under ``hopper_mapping``'s dispatch identity: ``H100_LIKE``, padded to
64, unless the caller plans through ``hopper_mapping`` with another spec.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import multiprocessing
import os
import time
from typing import Iterable, Sequence

from ..core.certificate import (check_constraints, effective_spatial_mode,
                                objective_value)
from ..core.energy import analytical_energy
from ..core.fusion import ChainSolveResult, GemmChain, solve_chain
from ..core.geometry import Gemm
from ..core.hardware import AcceleratorSpec
from ..core.solver import SOLVER_VERSION, SolveResult, solve
from ..core.solver import solve_many as core_solve_many
from ..core.workloads import LlmSpec, scenario_gemms
from ..obs.registry import get_registry
from ..obs.tracing import span as _obs_span
from .manifest import ManifestEntry, ModelMappingManifest
from .store import (FusedPlanEntry, ParetoPlanEntry, PlanEntry, PlanKey,
                    PlanStore, ShardedPlanEntry, chain_plan_key,
                    pareto_plan_key, plan_key, sharded_plan_key)




def warm_incumbent(gemm: Gemm, hw: AcceleratorSpec, key: PlanKey,
                   store: PlanStore) -> float | None:
    """Initial branch-and-bound UB from the best cached near-neighbor.

    Preferred: transplant the neighbor's *mapping* — when it is feasible
    for the new GEMM its re-evaluated objective is a guaranteed-valid UB.
    Fallback: the neighbor's raw objective as a speculative UB (the solver
    re-solves cold if it over-prunes, so exactness is never at risk).
    """
    nb = store.nearest_neighbor(key)
    if nb is None or nb.mapping is None:
        return None
    mode = effective_spatial_mode(hw, key.spatial_mode)
    try:
        if check_constraints(gemm, nb.mapping, hw, spatial_mode=mode):
            return objective_value(gemm, nb.mapping, hw, key.objective)
    except (ValueError, KeyError):
        pass
    return float(nb.certificate.objective)


def result_from_entry(entry: PlanEntry, gemm: Gemm,
                      hw: AcceleratorSpec) -> SolveResult:
    """Rehydrate a cached solve; the certificate round-trips bit-exactly,
    the energy breakdown is recomputed (cheap closed form)."""
    bd = (analytical_energy(gemm, entry.mapping, hw)
          if entry.mapping is not None else None)
    return SolveResult(mapping=entry.mapping,
                       certificate=entry.certificate, breakdown=bd)


def cached_solve(gemm: Gemm, hw: AcceleratorSpec, *,
                 objective: str = "energy",
                 spatial_mode: str | None = None,
                 allowed_walk01: tuple[str, ...] | None = None,
                 store: PlanStore | None = None,
                 warm_start: bool = False,
                 budget_s: float | None = None) -> SolveResult:
    """Read-through ``core.solver.solve``: store hit -> no solve; miss ->
    solve (optionally warm-started, optionally budgeted) and write back.

    A hit whose certificate is ``bounded`` (anytime incumbent) is served
    as-is — a feasible plan beats a deadline miss — and counted under
    ``degraded.plans.bounded_served`` so ``upgrade_bounded`` work can be
    scheduled."""
    if store is None:
        return solve(gemm, hw, objective=objective,
                     spatial_mode=spatial_mode,
                     allowed_walk01=allowed_walk01, budget_s=budget_s)
    key = plan_key(gemm, hw, objective=objective, spatial_mode=spatial_mode,
                   allowed_walk01=allowed_walk01)
    entry = store.get(key)
    if entry is not None:
        if entry.certificate.bounded:
            get_registry().inc("degraded.plans.bounded_served")
        return result_from_entry(entry, gemm, hw)
    incumbent = warm_incumbent(gemm, hw, key, store) if warm_start else None
    res = solve(gemm, hw, objective=objective, spatial_mode=spatial_mode,
                allowed_walk01=allowed_walk01, incumbent=incumbent,
                budget_s=budget_s)
    store.put(PlanEntry.from_solve(key, res.certificate, hw))
    return res


def upgrade_bounded(store: PlanStore, *, jobs: int | None = 1,
                    engine: str | None = None) -> int:
    """Background upgrade pass: re-solve every ``bounded`` (anytime)
    entry to a zero-gap certificate, warm-started with its own UB, and
    overwrite it under the same digest.  Returns the number upgraded.

    Entries whose stored key parameters no longer reproduce their digest
    (foreign solver version, legacy format) are skipped — never
    corrupted.  Counted under ``planner.upgraded``."""
    upgraded = 0
    for e in list(store.entries()):
        if not e.certificate.bounded:
            continue
        key = PlanKey(gemm_dims=e.gemm_dims, hw=e.hw,
                      objective=e.key_objective or "energy",
                      spatial_mode=e.key_spatial_mode,
                      allowed_walk01=e.key_allowed_walk01)
        if key.digest != e.digest:
            get_registry().inc("planner.upgrade_skipped")
            continue
        gemm = Gemm(*e.gemm_dims)
        res = solve(gemm, e.hw, objective=key.objective,
                    spatial_mode=key.spatial_mode,
                    allowed_walk01=key.allowed_walk01,
                    incumbent=float(e.certificate.upper_bound),
                    engine=engine)
        cert = res.certificate
        if cert.bounded or not cert.feasible:
            continue        # shouldn't happen without a budget; be safe
        assert cert.objective <= e.certificate.upper_bound \
            * (1.0 + 1e-9) + 1e-9, \
            "upgrade must never regress past the bounded UB"
        store.put(PlanEntry.from_solve(key, cert, e.hw))
        upgraded += 1
        get_registry().inc("planner.upgraded")
    return upgraded


def cached_solve_chain(chain: GemmChain, hw: AcceleratorSpec, *,
                       objective: str = "energy",
                       spatial_mode: str | None = None,
                       allowed_walk01: tuple[str, ...] | None = None,
                       store: PlanStore | None = None) -> ChainSolveResult:
    """Read-through ``core.fusion.solve_chain``: fused-plan store hit ->
    no solves; miss -> chain solve and write back under the chain-hash
    key."""
    if store is None:
        return solve_chain(chain, hw, objective=objective,
                           spatial_mode=spatial_mode,
                           allowed_walk01=allowed_walk01)
    key = chain_plan_key(chain, hw, objective=objective,
                         spatial_mode=spatial_mode,
                         allowed_walk01=allowed_walk01)
    entry = store.get_fused(key)
    if entry is not None:
        return ChainSolveResult(producer_mapping=entry.producer_mapping,
                                consumer_mapping=entry.consumer_mapping,
                                certificate=entry.certificate)
    res = solve_chain(chain, hw, objective=objective,
                      spatial_mode=spatial_mode,
                      allowed_walk01=allowed_walk01)
    store.put_fused(FusedPlanEntry.from_solve(key, res, hw))
    return res


def cached_solve_sharded(gemm: Gemm, hw: AcceleratorSpec, n_chips: int, *,
                         dtype_bytes: int = 1,
                         objective: str = "energy",
                         spatial_mode: str | None = None,
                         allowed_walk01: tuple[str, ...] | None = None,
                         store: PlanStore | None = None):
    """Read-through ``dist.mesh_solve.solve_sharded``: sharded-plan store
    hit -> no solves; miss -> joint (mesh, tiling) solve and write back
    under the sharded key.  On a miss each enumerated partition's
    per-chip solve ALSO flows through ``cached_solve`` against the same
    store, so one sharded miss leaves every sub-GEMM plan individually
    cached (the single-chip dispatch path benefits too)."""
    from ..dist.mesh_solve import ShardedSolveResult, solve_sharded
    if store is None:
        return solve_sharded(gemm, hw, n_chips, dtype_bytes=dtype_bytes,
                             objective=objective, spatial_mode=spatial_mode,
                             allowed_walk01=allowed_walk01)
    key = sharded_plan_key(gemm, hw, n_chips, dtype_bytes=dtype_bytes,
                           objective=objective, spatial_mode=spatial_mode,
                           allowed_walk01=allowed_walk01)
    entry = store.get_sharded(key)
    if entry is not None:
        get_registry().inc("dist.store_hits")
        return ShardedSolveResult(mapping=entry.mapping,
                                  certificate=entry.certificate)
    get_registry().inc("dist.store_misses")

    def chip_solve(sub, sub_hw, **kw):
        return cached_solve(sub, sub_hw, store=store, **kw)

    res = solve_sharded(gemm, hw, n_chips, dtype_bytes=dtype_bytes,
                        objective=objective, spatial_mode=spatial_mode,
                        allowed_walk01=allowed_walk01,
                        chip_solve=chip_solve)
    store.put_sharded(ShardedPlanEntry.from_solve(key, res, hw))
    return res


def cached_solve_pareto(gemm: Gemm, hw: AcceleratorSpec, *,
                        objective: str = "energy",
                        spatial_mode: str | None = None,
                        allowed_walk01: tuple[str, ...] | None = None,
                        bw=None, max_points: int | None = 24,
                        store: PlanStore | None = None):
    """Read-through ``core.solver.solve_pareto``: pareto-section store
    hit -> zero solves (the whole certified frontier rehydrates); miss ->
    epsilon-constraint sweep and write back under the bandwidth-keyed
    frontier key.  Because the key embeds the (dram, sram, rf) bandwidth
    triple, recalibrating the latency model re-keys frontiers instead of
    silently serving stale delay numbers."""
    from ..core.solver import ParetoSolveResult, solve_pareto
    if store is None:
        return solve_pareto(gemm, hw, objective=objective,
                            spatial_mode=spatial_mode,
                            allowed_walk01=allowed_walk01, bw=bw,
                            max_points=max_points)
    key = pareto_plan_key(gemm, hw, bw=bw, objective=objective,
                          spatial_mode=spatial_mode,
                          allowed_walk01=allowed_walk01,
                          max_points=max_points)
    entry = store.get_pareto(key)
    if entry is not None:
        get_registry().inc("pareto.store_hits")
        return ParetoSolveResult(points=entry.certificate.points,
                                 certificate=entry.certificate)
    get_registry().inc("pareto.store_misses")
    res = solve_pareto(gemm, hw, objective=objective,
                       spatial_mode=spatial_mode,
                       allowed_walk01=allowed_walk01, bw=bw,
                       max_points=max_points)
    store.put_pareto(ParetoPlanEntry.from_solve(key, res, hw))
    return res


# ---------------------------------------------------------------------------
# parallel batch solving
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _SolveTask:
    """Picklable unit of work for the process pool."""

    digest: str
    gemm: Gemm
    hw: AcceleratorSpec
    objective: str
    spatial_mode: str | None
    allowed_walk01: tuple[str, ...] | None
    incumbent: float | None
    budget_s: float | None = None


def _solve_task(task: _SolveTask) -> tuple[str, "object"]:
    res = solve(task.gemm, task.hw, objective=task.objective,
                spatial_mode=task.spatial_mode,
                allowed_walk01=task.allowed_walk01,
                incumbent=task.incumbent, budget_s=task.budget_s)
    return task.digest, res.certificate


def solve_many(tasks: Sequence[_SolveTask], *,
               jobs: int | None = None) -> dict[str, "object"]:
    """Solve a batch of deduplicated tasks, in-process or via a pool.

    Returns {digest: Certificate}.  jobs None/0 -> os.cpu_count(); 1 ->
    sequential in-process (identical results by construction: each task
    is an independent exact solve).

    The sequential path goes through ``core.solver.solve_many`` (the
    tasks duck-type its request protocol), which shares the process-level
    axis-candidate memo: scenario shapes repeat d_model/d_ff extents, so
    per-axis candidate construction happens once per distinct axis for
    the whole batch.  The pool path sorts tasks by GEMM extents and hands
    each worker one contiguous chunk, so neighboring shapes land in the
    same worker's memo.
    """
    if jobs is None or jobs <= 0:
        jobs = os.cpu_count() or 1
    if jobs == 1 or len(tasks) <= 1:
        results = core_solve_many(tasks)
        return {t.digest: res.certificate
                for t, res in zip(tasks, results)}
    out: dict[str, object] = {}
    # spawn, not fork: the parent typically has jax (multithreaded)
    # loaded; workers only ever import numpy-level repro.core
    ctx = multiprocessing.get_context("spawn")
    tasks = sorted(tasks, key=lambda t: t.gemm.dims)
    # ~4 chunks per worker: contiguous enough for memo locality, small
    # enough that one slow chunk doesn't serialize the tail
    chunk = max(1, -(-len(tasks) // (jobs * 4)))
    with concurrent.futures.ProcessPoolExecutor(max_workers=jobs,
                                                mp_context=ctx) as pool:
        for digest, cert in pool.map(_solve_task, tasks, chunksize=chunk):
            out[digest] = cert
    return out


@dataclasses.dataclass
class BatchReport:
    """Outcome of one BatchPlanner run (bench_planner's measurable)."""

    total_gemms: int              # (type, gemm, weight) rows pre-dedup
    unique_gemms: int
    hits: int
    solved: int
    warm_started: int
    wall_time_s: float
    solve_time_s: float           # sum of per-solve times (CPU work)

    @property
    def hit_rate(self) -> float:
        return self.hits / self.unique_gemms if self.unique_gemms else 0.0


class BatchPlanner:
    """Plans whole models/scenarios against one accelerator spec.

    ``store=None`` plans without persistence: every shape still goes
    through the same dedup + one ``solve_many`` pass, but nothing is
    read from or written to disk (capture benchmarks, throwaway runs).
    """

    def __init__(self, store: PlanStore | None, *, jobs: int | None = 1,
                 warm_start: bool = True):
        self.store = store
        self.jobs = jobs
        self.warm_start = warm_start
        self.last_report: BatchReport | None = None

    def plan_gemms(self, gemms: Iterable[tuple[str, Gemm, int]],
                   hw: AcceleratorSpec, *, objective: str = "energy",
                   spatial_mode: str | None = None,
                   allowed_walk01: tuple[str, ...] | None = None,
                   budget_s: float | None = None,
                   ) -> list[ManifestEntry]:
        """Dedup -> hit/miss split -> parallel solve -> write-back.

        ``budget_s``: per-solve anytime budget — misses past it are
        stored as ``bounded`` incumbents, to be finished later by
        ``upgrade_bounded``.  Counted as ``planner.batches``; under a
        tracer the whole build is one ``planner.plan_gemms`` span (store
        lookups and inline solves nest inside it) whose attributes
        mirror the ``BatchReport``."""
        get_registry().inc("planner.batches")
        with _obs_span("planner.plan_gemms", hw=hw.name,
                       objective=objective) as sp:
            entries = self._plan_gemms_impl(
                gemms, hw, objective=objective, spatial_mode=spatial_mode,
                allowed_walk01=allowed_walk01, budget_s=budget_s)
            if sp:
                rep = self.last_report
                sp.attrs.update(rows=rep.total_gemms,
                                unique=rep.unique_gemms, hits=rep.hits,
                                solved=rep.solved,
                                warm_started=rep.warm_started)
        return entries

    def _plan_gemms_impl(self, gemms: Iterable[tuple[str, Gemm, int]],
                         hw: AcceleratorSpec, *, objective: str = "energy",
                         spatial_mode: str | None = None,
                         allowed_walk01: tuple[str, ...] | None = None,
                         budget_s: float | None = None,
                         ) -> list[ManifestEntry]:
        t0 = time.perf_counter()
        rows = list(gemms)
        # aggregate weights of identical shapes, keep first-seen type name
        by_digest: dict[str, dict] = {}
        for gtype, gemm, w in rows:
            key = plan_key(gemm, hw, objective=objective,
                           spatial_mode=spatial_mode,
                           allowed_walk01=allowed_walk01)
            slot = by_digest.setdefault(key.digest, {
                "type": gtype, "gemm": gemm, "key": key, "weight": 0})
            slot["weight"] += w
        # hit/miss split
        hits, misses = {}, {}
        for digest, slot in by_digest.items():
            entry = (self.store.get(slot["key"])
                     if self.store is not None else None)
            if entry is not None:
                hits[digest] = entry
            else:
                misses[digest] = slot
        # warm starts are computed against the pre-batch store state (the
        # pool workers cannot see each other's incumbents)
        tasks = []
        warm = 0
        for digest, slot in misses.items():
            inc = (warm_incumbent(slot["gemm"], hw, slot["key"], self.store)
                   if self.warm_start and self.store is not None else None)
            warm += inc is not None
            tasks.append(_SolveTask(
                digest=digest, gemm=slot["gemm"], hw=hw,
                objective=objective, spatial_mode=spatial_mode,
                allowed_walk01=allowed_walk01, incumbent=inc,
                budget_s=budget_s))
        certs = solve_many(tasks, jobs=self.jobs)
        if self.store is not None:
            for digest, cert in certs.items():
                self.store.put(PlanEntry.from_solve(
                    misses[digest]["key"], cert, hw))
        # manifest rows
        entries: list[ManifestEntry] = []
        solve_time = 0.0
        for digest, slot in by_digest.items():
            cached = digest in hits
            cert = hits[digest].certificate if cached else certs[digest]
            if not cached:
                solve_time += cert.solve_time_s
            entries.append(ManifestEntry(
                gemm_type=slot["type"], dims=slot["gemm"].dims,
                weight=slot["weight"], digest=digest,
                objective=cert.objective, feasible=cert.feasible,
                solve_time_s=cert.solve_time_s, cached=cached,
                warm_started=getattr(cert, "warm_started", False),
                gap=cert.gap if cert.gap != float("inf") else -1.0))
        self.last_report = BatchReport(
            total_gemms=len(rows), unique_gemms=len(by_digest),
            hits=len(hits), solved=len(misses), warm_started=warm,
            wall_time_s=time.perf_counter() - t0, solve_time_s=solve_time)
        return entries

    def plan_model(self, spec: LlmSpec, hw: AcceleratorSpec, *,
                   prefill_seqs: Sequence[int] = (1024,),
                   decode_batches: Sequence[int] = (),
                   cache_len: int = 4096,
                   objective: str = "energy") -> ModelMappingManifest:
        """One LlmSpec scenario -> populated store + manifest."""
        gemms = scenario_gemms(spec, prefill_seqs=prefill_seqs,
                               decode_batches=decode_batches,
                               cache_len=cache_len)
        entries = self.plan_gemms(gemms, hw, objective=objective)
        return ModelMappingManifest(
            model=spec.name, hw_name=hw.name, objective=objective,
            prefill_seqs=tuple(prefill_seqs),
            decode_batches=tuple(decode_batches), cache_len=cache_len,
            entries=entries, solver_version=SOLVER_VERSION)


# ---------------------------------------------------------------------------
# TPU / Pallas integration: store-driven tile plans
# ---------------------------------------------------------------------------

def prewarm_tpu_plans(shapes: Iterable[tuple[int, int, int]],
                      store: PlanStore, *, dtype_bytes: int = 2) -> int:
    """Populate the store (and process cache) with TPU tile plans for the
    given (M, N, K) shapes; returns the number of shapes planned.

    The store is *left installed* as the process plan store: prewarming
    is the moment a deployment opts into read-through planning, and
    restoring the previous store here would flush the plan cache that
    was just built (``set_plan_store`` keeps the cache only when the
    store is unchanged).  Call ``hopper_mapping.set_plan_store(None)`` to
    opt back out."""
    from ..core import hopper_mapping
    n = 0
    hopper_mapping.set_plan_store(store)
    for (M, N, K) in shapes:
        hopper_mapping.plan_gemm_tiling(M, N, K, dtype_bytes=dtype_bytes)
        n += 1
    return n


def tile_plan_from_store(store: PlanStore, M: int, N: int, K: int, *,
                         dtype_bytes: int = 2):
    """Reconstruct a ``TpuTilePlan`` purely from cached plans — raises
    KeyError on a miss instead of solving (the zero-solve serving path)."""
    from ..core import hopper_mapping
    gemm, hw, padded = hopper_mapping.gemm_problem(M, N, K,
                                               dtype_bytes=dtype_bytes)
    entry = store.get(plan_key(gemm, hw, objective="energy"))
    if entry is None or entry.mapping is None:
        raise KeyError(f"no cached plan for {(M, N, K)} "
                       f"(dtype_bytes={dtype_bytes})")
    m, cert = entry.mapping, entry.certificate
    if m.alpha01 != "z" and m.L1[2] < padded[2]:
        entry = store.get(plan_key(gemm, hw, objective="energy",
                                   allowed_walk01=("z",)))
        if entry is None or entry.mapping is None:
            raise KeyError(f"no cached z-walk plan for {(M, N, K)}")
        m, cert = entry.mapping, entry.certificate
    return hopper_mapping.plan_from_mapping(M, N, K, padded, m,
                                         objective=cert.objective,
                                         solve_time_s=cert.solve_time_s)


def prewarm_fused_plans(chains: Iterable[tuple[int, int, int, int]],
                        store: PlanStore, *, dtype_bytes: int = 2) -> int:
    """Populate the store's fused section (and process cache) with fused
    MLP tile plans for the given (M, FF, K, N2) chain shapes; returns the
    number planned.  Installs the store like ``prewarm_tpu_plans``."""
    from ..core import hopper_mapping
    n = 0
    hopper_mapping.set_plan_store(store)
    for (M, FF, K, N2) in chains:
        hopper_mapping.plan_fused_mlp(M, FF, K, N2, dtype_bytes=dtype_bytes)
        n += 1
    return n


def prewarm_sharded_plans(shapes: Iterable[tuple[int, int, int]],
                          store: PlanStore, *, n_chips: int,
                          dtype_bytes: int = 2) -> int:
    """Populate the store's sharded section with joint (mesh partition,
    per-chip tiling) plans for the given logical (M, N, K) shapes on an
    ``n_chips`` mesh; returns the number of shapes planned.

    Shapes are planned under their *TPU dispatch identity* — the padded
    GEMM and dtype-rescaled spec of ``tpu_mapping.tpu_problem`` — so the
    mesh plan describes the same problem the Pallas tiling path solves,
    and the padded dims (MXU multiples) keep small chip counts divisor-
    feasible.  Each miss also leaves every enumerated sub-GEMM plan in
    the store's single-chip section (see ``cached_solve_sharded``)."""
    from ..core import hopper_mapping
    n = 0
    seen: set[tuple[int, int, int]] = set()
    for (M, N, K) in shapes:
        gemm, hw, padded = hopper_mapping.gemm_problem(M, N, K,
                                                   dtype_bytes=dtype_bytes)
        if padded in seen:
            continue
        seen.add(padded)
        cached_solve_sharded(gemm, hw, n_chips, dtype_bytes=dtype_bytes,
                             store=store)
        n += 1
    return n


def prewarm_pareto_plans(shapes: Iterable[tuple[int, int, int]],
                         store: PlanStore, *, dtype_bytes: int = 2,
                         max_points: int | None = 24) -> int:
    """Populate the store's pareto section with certified (energy, delay)
    frontiers for the given logical (M, N, K) shapes under their TPU
    dispatch identity (padded GEMM + dtype-rescaled spec, matching
    ``prewarm_sharded_plans``); returns the number of shapes planned.

    This is what a latency-SLO serving deployment runs ahead of traffic:
    steady-state frontier-point selection then never invokes the solver
    (``cached_solve_pareto`` hits rehydrate the whole frontier)."""
    from ..core import hopper_mapping
    n = 0
    seen: set[tuple[int, int, int]] = set()
    for (M, N, K) in shapes:
        gemm, hw, padded = hopper_mapping.gemm_problem(M, N, K,
                                                   dtype_bytes=dtype_bytes)
        if padded in seen:
            continue
        seen.add(padded)
        cached_solve_pareto(gemm, hw, store=store, max_points=max_points)
        n += 1
    return n


def bucketed_serving_fused_chain_groups(
        arch_id: str, *, slots: int, chunk_widths: Sequence[int],
        cache_len: int,
        cfg=None) -> dict[str, list[tuple[int, int, int, int]]]:
    """Per-phase fused-MLP chain shapes (M, FF, K, N2) of a
    continuous-batching deployment: one group per prefill-chunk width
    plus the slot-batched decode group — the fused counterpart of
    ``bucketed_serving_plan_shape_groups`` (same #widths + 1 bound).

    ``cfg``: an explicit ``ArchConfig`` (e.g. the serving engine's own
    model config, which may be a smoke variant) — chain dims then match
    what the model's ``fused_mlp`` dispatch will actually request;
    default resolves ``arch_id`` from the registry."""
    from ..core.workloads import arch_decode_chains, config_decode_chains

    def rows(batch):
        chains = (config_decode_chains(cfg, batch=batch) if cfg is not None
                  else arch_decode_chains(arch_id, batch=batch,
                                          cache_len=cache_len))
        out = []
        for _, chain, _ in chains:
            dims = (chain.M, chain.inter_width, chain.producer.Lz,
                    chain.consumer.Ly)
            if dims not in out:
                out.append(dims)
        return out

    groups = {f"chunk{w}": rows(w) for w in chunk_widths}
    groups["decode"] = rows(slots)
    return groups


def serving_plan_shapes(arch_id: str, *, batch: int, prompt_len: int,
                        cache_len: int) -> list[tuple[int, int, int]]:
    """Distinct GEMM (M, N, K) shapes a serving deployment will hit:
    the prefill extraction at prompt_len plus batched decode steps."""
    from ..core.workloads import arch_decode_gemms, arch_gemms
    shapes: list[tuple[int, int, int]] = []
    seen = set()
    rows = (arch_gemms(arch_id, seq=prompt_len, batch=batch)
            + arch_decode_gemms(arch_id, batch=batch, cache_len=cache_len))
    for _, gemm, _ in rows:
        if gemm.dims not in seen:
            seen.add(gemm.dims)
            shapes.append(gemm.dims)
    return shapes


def bucketed_serving_plan_shape_groups(
        arch_id: str, *, slots: int, chunk_widths: Sequence[int],
        cache_len: int) -> dict[str, list[tuple[int, int, int]]]:
    """Per-phase GEMM (M, N, K) shape groups of a continuous-batching
    deployment (serving.sched): one group per prefill-chunk width plus
    the slot-batched decode group.

    A prefill chunk of width W on one sequence flattens to exactly the
    GEMM set of a batch-W decode step against the same static cache —
    M = W token rows for every projection, attention score/context
    against cache_len — so both phases extract through
    ``arch_decode_gemms`` and the total plan-key count is bounded by
    #chunk_widths + 1, independent of traffic.
    """
    from ..core.workloads import arch_decode_gemms

    def dedup(rows):
        out, seen = [], set()
        for _, gemm, _ in rows:
            if gemm.dims not in seen:
                seen.add(gemm.dims)
                out.append(gemm.dims)
        return out

    groups = {
        f"chunk{w}": dedup(arch_decode_gemms(arch_id, batch=w,
                                             cache_len=cache_len))
        for w in chunk_widths}
    groups["decode"] = dedup(arch_decode_gemms(arch_id, batch=slots,
                                               cache_len=cache_len))
    return groups


def bucketed_spec_plan_shape_groups(
        arch_id: str, *, batch: int, spec_widths: Sequence[int],
        cache_len: int,
        draft_arch_id: str | None = None
        ) -> dict[str, list[tuple[int, int, int]]]:
    """Per-width GEMM shape groups of a speculative-decoding deployment
    (serving.router.spec), from the hand-enumerated extraction tables:
    a batched verify step over a draft window of width W flattens to
    exactly the GEMM set of a batch ``batch * W`` decode step (every
    projection sees batch*W token rows; attention runs per row against
    the same static cache), so each ``verify{W}`` group extracts through
    ``arch_decode_gemms`` like the prefill-chunk groups do.  With a
    draft model (``draft_arch_id``), its width-1 decode and catch-up
    chunk programs join the group dict under ``draft.*`` — the
    enumerated counterpart of
    ``capture.plan.captured_spec_plan_shape_groups``."""
    from ..core.workloads import arch_decode_gemms

    def dedup(rows):
        out, seen = [], set()
        for _, gemm, _ in rows:
            if gemm.dims not in seen:
                seen.add(gemm.dims)
                out.append(gemm.dims)
        return out

    groups = {
        f"verify{w}": dedup(arch_decode_gemms(arch_id, batch=batch * w,
                                              cache_len=cache_len))
        for w in spec_widths}
    if draft_arch_id is not None:
        groups["draft.decode"] = dedup(arch_decode_gemms(
            draft_arch_id, batch=1, cache_len=cache_len))
        for w in spec_widths:
            groups[f"draft.chunk{w}"] = dedup(arch_decode_gemms(
                draft_arch_id, batch=w, cache_len=cache_len))
    return groups


def flatten_shape_groups(
        groups: dict[str, list[tuple[int, int, int]]]
        ) -> list[tuple[int, int, int]]:
    """Deduplicated union of per-phase shape groups, first-seen order."""
    shapes, seen = [], set()
    for group in groups.values():
        for dims in group:
            if dims not in seen:
                seen.add(dims)
                shapes.append(dims)
    return shapes


def bucketed_serving_plan_shapes(
        arch_id: str, *, slots: int, chunk_widths: Sequence[int],
        cache_len: int) -> list[tuple[int, int, int]]:
    """Flat deduplicated union of ``bucketed_serving_plan_shape_groups``
    — the prewarm set for a continuous-batching scheduler."""
    return flatten_shape_groups(bucketed_serving_plan_shape_groups(
        arch_id, slots=slots, chunk_widths=chunk_widths,
        cache_len=cache_len))
