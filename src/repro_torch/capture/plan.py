"""The plan pass: lower a PlanProgram to a populated store + manifest
(the counterpart of the reference's ``capture/plan.py``).

One call plans everything a captured (or hand-enumerated) program
executes: the GEMM rows go through ``planner.batch.BatchPlanner`` — one
content-addressed dedup, one ``solve_many`` batch (store hits served,
misses solved in one pass) — and every detected chain goes through
``planner.batch.cached_solve_chain`` into the store's fused section.
The result is a :class:`ProgramPlan`: the ``ModelMappingManifest``
artifact plus the chain certificates, all zero-gap.

Also hosts the serving-side capture helpers: tracing a ``Model``'s own
prefill / decode-step programs (shape-level: parameters, tokens and
caches on the meta device) so ``serving.Engine.prewarm_plans`` and the
continuous scheduler prewarm exactly the GEMM set the deployed program
will dispatch, rather than a hand-maintained extraction of it.  The
kernel wrappers are opaque in the trace, as ``pallas_call`` is in the
reference: a fused-MLP model's MLP products are not harvested, and the
trace resolves their plans (``plan_fused_mlp``, and ``plan_gemm_tiling``
for an unfused chain) through the installed store as it passes them.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..core.fusion import ChainSolveResult
from ..core.hardware import AcceleratorSpec
from ..core.solver import SOLVER_VERSION
from ..obs.registry import get_registry
from ..obs.tracing import span as _span
from ..planner.batch import (BatchPlanner, cached_solve_chain,
                             cached_solve_sharded)
from ..planner.manifest import (ModelMappingManifest, ShardedManifestEntry,
                                ShardedModelManifest)
from ..planner.store import PlanStore, sharded_plan_key
from .program import PlanProgram, captured_program


@dataclasses.dataclass
class ChainPlanRow:
    """One planned chain of a program."""

    label: str
    weight: int
    result: ChainSolveResult

    @property
    def certificate(self):
        return self.result.certificate


@dataclasses.dataclass
class ProgramPlan:
    """Outcome of one plan pass over a PlanProgram."""

    program: PlanProgram
    manifest: ModelMappingManifest
    chain_rows: list[ChainPlanRow]
    wall_time_s: float

    @property
    def feasible(self) -> bool:
        return (all(e.feasible for e in self.manifest.entries)
                and all(r.certificate.feasible for r in self.chain_rows))

    @property
    def zero_gap(self) -> bool:
        """Every certificate closed (UB == LB): per-GEMM via the
        manifest's recorded gap, chains via their certificates."""
        return (all(e.gap == 0.0 for e in self.manifest.entries
                    if e.feasible)
                and all(r.certificate.gap == 0.0
                        for r in self.chain_rows))

    def summary(self) -> str:
        lines = [self.program.summary(), self.manifest.summary()]
        for r in self.chain_rows:
            lines.append(f"  chain w={r.weight} "
                         + r.certificate.summary())
        return "\n".join(lines)


def plan_program(program: PlanProgram, hw: AcceleratorSpec, *,
                 store: PlanStore | None = None,
                 objective: str = "energy",
                 spatial_mode: str | None = None,
                 allowed_walk01: tuple[str, ...] | None = None,
                 jobs: int | None = 1, warm_start: bool = True,
                 solve_chains: bool = True) -> ProgramPlan:
    """Plan every GEMM (one deduped batch) and chain of a program.

    Chains are priced in absolute energy (``core.fusion.solve_chain``),
    so they are skipped — with the manifest untouched — when the GEMM
    objective is not "energy".
    """
    t0 = time.perf_counter()
    get_registry().inc("capture.plans")
    with _span("capture.plan_program", program=program.name,
               hw=hw.name) as sp:
        planner = BatchPlanner(store, jobs=jobs, warm_start=warm_start)
        entries = planner.plan_gemms(program.gemm_rows(), hw,
                                     objective=objective,
                                     spatial_mode=spatial_mode,
                                     allowed_walk01=allowed_walk01)
        manifest = ModelMappingManifest(
            model=program.name, hw_name=hw.name, objective=objective,
            prefill_seqs=(), decode_batches=(), cache_len=0,
            entries=entries, solver_version=SOLVER_VERSION)
        chain_rows: list[ChainPlanRow] = []
        if solve_chains and objective == "energy":
            for label, chain, weight in program.chain_rows():
                res = cached_solve_chain(chain, hw, objective="energy",
                                         spatial_mode=spatial_mode,
                                         allowed_walk01=allowed_walk01,
                                         store=store)
                chain_rows.append(ChainPlanRow(label=label, weight=weight,
                                               result=res))
        if sp:
            sp.attrs.update(entries=len(entries), chains=len(chain_rows))
    return ProgramPlan(program=program, manifest=manifest,
                       chain_rows=chain_rows,
                       wall_time_s=time.perf_counter() - t0)


@dataclasses.dataclass
class ShardedProgramPlan:
    """Outcome of one sharded plan pass: the ShardedModelManifest plus
    the live solve results (per-chip mappings, PartitionSpecs)."""

    program: PlanProgram
    manifest: ShardedModelManifest
    results: dict[tuple[int, int, int], object]   # dims -> ShardedSolveResult
    wall_time_s: float

    @property
    def feasible(self) -> bool:
        return self.manifest.feasible

    @property
    def zero_gap(self) -> bool:
        return self.manifest.zero_gap

    def summary(self) -> str:
        lines = [self.program.summary(), self.manifest.summary()]
        for e in self.manifest.entries:
            mesh = (f"x{e.counts[0]}y{e.counts[1]}z{e.counts[2]}"
                    if e.counts else "infeasible")
            lines.append(f"  {e.gemm_type} w={e.weight} {e.dims} -> {mesh} "
                         f"[{e.collectives}] joint={e.objective:.4g} "
                         f"ind={e.independent_objective:.4g}")
        return "\n".join(lines)


def plan_sharded_program(program: PlanProgram, hw: AcceleratorSpec,
                         n_chips: int, *,
                         store: PlanStore | None = None,
                         dtype_bytes: int = 1,
                         spatial_mode: str | None = None,
                         allowed_walk01: tuple[str, ...] | None = None
                         ) -> ShardedProgramPlan:
    """Lower a PlanProgram to a sharded manifest: each distinct GEMM is
    co-solved for (mesh partition, per-chip tiling) on ``n_chips`` x
    ``hw`` through the store's sharded section (misses populate it, and
    every enumerated sub-GEMM plan lands in the single-chip section as a
    side effect — see ``cached_solve_sharded``)."""
    t0 = time.perf_counter()
    get_registry().inc("dist.program_plans")
    with _span("capture.plan_sharded_program", program=program.name,
               hw=hw.name, n_chips=n_chips) as sp:
        # dedup by dims, accumulating weights — the manifest row protocol
        order: list[tuple[str, tuple[int, int, int]]] = []
        weights: dict[tuple[int, int, int], int] = {}
        gemm_of: dict[tuple[int, int, int], object] = {}
        for label, gemm, weight in program.gemm_rows():
            if gemm.dims not in weights:
                order.append((label, gemm.dims))
                gemm_of[gemm.dims] = gemm
            weights[gemm.dims] = weights.get(gemm.dims, 0) + weight
        results: dict[tuple[int, int, int], object] = {}
        entries: list[ShardedManifestEntry] = []
        for label, dims in order:
            gemm = gemm_of[dims]
            key = sharded_plan_key(gemm, hw, n_chips,
                                   dtype_bytes=dtype_bytes,
                                   spatial_mode=spatial_mode,
                                   allowed_walk01=allowed_walk01)
            cached = store is not None and store.contains_sharded(key)
            res = cached_solve_sharded(
                gemm, hw, n_chips, dtype_bytes=dtype_bytes,
                spatial_mode=spatial_mode, allowed_walk01=allowed_walk01,
                store=store)
            c = res.certificate
            results[dims] = res
            entries.append(ShardedManifestEntry(
                gemm_type=label, dims=dims, weight=weights[dims],
                digest=key.digest, counts=c.counts,
                collectives=c.collectives, objective=c.objective,
                independent_objective=c.independent_objective,
                feasible=c.feasible, gap=c.gap, cached=cached,
                solve_time_s=c.solve_time_s))
        manifest = ShardedModelManifest(
            model=program.name, hw_name=hw.name, n_chips=n_chips,
            dtype_bytes=dtype_bytes, entries=entries,
            solver_version=SOLVER_VERSION)
        if sp:
            sp.attrs.update(entries=len(entries))
    return ShardedProgramPlan(program=program, manifest=manifest,
                              results=results,
                              wall_time_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Model capture: trace a repro_torch.models Model's own serving programs
# ---------------------------------------------------------------------------

def model_param_avals(model):
    """Shape-level parameter tree: the model's parameters on the meta
    device, in their own dtypes (nothing materialized)."""
    return model.init_params(torch.Generator(), "meta")


def _meta_ints(*shape: int) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int64, device="meta")


def _meta_embeds(model, batch: int, length: int) -> torch.Tensor:
    """A frontend's (batch, length, d_model) embeddings in the compute
    dtype, on the meta device."""
    from ..models.layers import dtype_of
    cfg = model.cfg
    return torch.empty((batch, length, cfg.d_model),
                       dtype=dtype_of(cfg.compute_dtype), device="meta")


def capture_model_prefill(model, batch: int, seq: int, *,
                          cache_len: int | None = None,
                          name: str | None = None) -> PlanProgram:
    """Capture ``model.prefill`` at (batch, seq) against a cache of
    ``cache_len`` (defaults to seq); the frontends' inputs are meta
    stand-ins, as the reference's ``input_specs`` supplies them: the
    encoder-decoder's frames (batch, frontend_len or seq, d_model), the
    VLM's patches (batch, frontend_len, d_model)."""
    params = model_param_avals(model)
    max_len = cache_len if cache_len is not None else seq
    cfg = model.cfg
    inputs = {"tokens": _meta_ints(batch, seq)}
    if cfg.family == "encdec":
        inputs["frames"] = _meta_embeds(model, batch,
                                        cfg.frontend_len or seq)
    if cfg.family == "vlm":
        inputs["patches"] = _meta_embeds(model, batch, cfg.frontend_len)

    def fn(p, b):
        return model.prefill(p, b, max_len=max_len)[0]

    return captured_program(
        fn, params, inputs,
        name=name or f"{model.cfg.name}_prefill_b{batch}_s{seq}")


def capture_model_decode(model, batch: int, cache_len: int, *,
                         width: int = 1, slot_indexed: bool = False,
                         name: str | None = None) -> PlanProgram:
    """Capture one ``model.decode_step``: ``width`` tokens per row
    against a cache of ``cache_len`` (width > 1 is a chunked-prefill
    continuation; ``slot_indexed`` uses per-row positions — the
    continuous scheduler's decode signature — else one shared int
    position).  The encoder-decoder's cache carries a meta ``enc_out``
    of (batch, frontend_len or cache_len, d_model), as the reference's
    ``input_specs`` supplies it."""
    params = model_param_avals(model)
    cache = model.init_cache(batch, cache_len, device="meta")
    if model.cfg.family == "encdec":
        cache["enc_out"] = _meta_embeds(
            model, batch, model.cfg.frontend_len or cache_len)
    index = _meta_ints(batch) if slot_indexed else 0

    def fn(p, c, t, i):
        return model.decode_step(p, c, t, i)[0]

    return captured_program(
        fn, params, cache, _meta_ints(batch, width), index,
        name=name or f"{model.cfg.name}_decode_b{batch}_w{width}")


def capture_serving_program(model, batch: int, prompt_len: int,
                            cache_len: int) -> PlanProgram:
    """The full serving program of one deployment: prefill at
    prompt_len merged with the batched decode step — the captured
    replacement for ``planner.batch.serving_plan_shapes``."""
    prog = capture_model_prefill(model, batch, prompt_len,
                                 cache_len=cache_len)
    return prog.merged(capture_model_decode(model, batch, cache_len),
                       name=f"{model.cfg.name}_serving")


def serving_capture_shapes(model, batch: int, prompt_len: int,
                           cache_len: int) -> list[tuple[int, int, int]]:
    """Distinct GEMM (M, N, K) shapes the deployment's traced programs
    dispatch (``Engine.prewarm_plans`` routes through this)."""
    return capture_serving_program(model, batch, prompt_len,
                                   cache_len).shapes()


def captured_serving_plan_shape_groups(
        model, *, slots: int, chunk_widths,
        cache_len: int) -> dict[str, list[tuple[int, int, int]]]:
    """Per-phase GEMM shape groups of a continuous-batching deployment,
    read off the model's *own* traced programs: one group per
    prefill-chunk width (a (1, W) decode_step continuation) plus the
    slot-batched decode group — the captured counterpart of
    ``planner.batch.bucketed_serving_plan_shape_groups``, with the same
    #widths + 1 bound on plan-key groups."""
    groups = {
        f"chunk{w}": capture_model_decode(model, 1, cache_len,
                                          width=w).shapes()
        for w in chunk_widths}
    groups["decode"] = capture_model_decode(
        model, slots, cache_len, width=1, slot_indexed=True).shapes()
    return groups


def captured_spec_plan_shape_groups(
        model, *, batch: int, cache_len: int,
        spec_widths, draft_model=None,
        draft_cache_len: int | None = None
        ) -> dict[str, list[tuple[int, int, int]]]:
    """GEMM shape groups of a speculative-decoding deployment, read off
    the traced programs themselves: one ``verify{W}`` group per draft
    window width (a (batch, W) slot-indexed decode — the target model's
    batched verify step), plus — when a draft *model* proposes the
    tokens — the drafter's own width-1 decode and teacher-forced
    catch-up programs.  The spec-decode counterpart of
    ``captured_serving_plan_shape_groups``: prewarming these groups
    means neither the verify step nor the draft proposals ever invoke
    the solver in steady state, and the plan-key count stays bounded by
    the (small, fixed) width ladder."""
    groups = {
        f"verify{w}": capture_model_decode(
            model, batch, cache_len, width=w, slot_indexed=True).shapes()
        for w in spec_widths}
    if draft_model is not None:
        dlen = draft_cache_len if draft_cache_len is not None \
            else cache_len
        groups["draft.decode"] = capture_model_decode(
            draft_model, 1, dlen, width=1, slot_indexed=True).shapes()
        for w in spec_widths:
            # after a rejected draft the drafter re-syncs by decoding
            # the accepted tokens teacher-forced, one chunk per window
            # width — same program family as the verify widths
            groups[f"draft.chunk{w}"] = capture_model_decode(
                draft_model, 1, dlen, width=w).shapes()
    return groups
