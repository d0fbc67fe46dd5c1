"""Mapping-plan database of the port: amortize exact GOMA solves across
processes (the counterpart of the reference's ``planner`` package).

  * ``store``     — content-addressed, versioned on-disk plan store, a
                    verbatim copy of the reference's: the two packages read
                    and write the same objects under the same keys,
  * ``manifest``  — the ``ModelMappingManifest`` build artifact (verbatim),
  * ``batch``     — whole-model GEMM extraction + deduplicated parallel
                    batch solving; its prewarm helpers plan through
                    ``core.hopper_mapping``,
  * ``cli``       — ``python -m repro_torch.plan`` build/inspect/verify.

Read-through consumers: ``core.hopper_mapping.plan_gemm_tiling`` and
``plan_fused_mlp`` (hence ``kernels.ops.gemm`` / ``fused_mlp``) and
``serving.Engine`` (plan prewarming).
"""
from .batch import (BatchPlanner, BatchReport,
                    bucketed_serving_fused_chain_groups,
                    bucketed_serving_plan_shape_groups,
                    bucketed_serving_plan_shapes, cached_solve,
                    cached_solve_chain, cached_solve_pareto,
                    flatten_shape_groups, prewarm_fused_plans,
                    prewarm_pareto_plans, prewarm_tpu_plans,
                    serving_plan_shapes, tile_plan_from_store)
from .manifest import ManifestEntry, ModelMappingManifest
from .store import (ChainKey, FusedPlanEntry, ParetoKey, ParetoPlanEntry,
                    PlanEntry, PlanKey, PlanStore, chain_plan_key,
                    pareto_plan_key, plan_key, resolve_default_store)

__all__ = [
    "BatchPlanner", "BatchReport", "ChainKey", "FusedPlanEntry",
    "ManifestEntry", "ModelMappingManifest", "ParetoKey", "ParetoPlanEntry",
    "PlanEntry", "PlanKey", "PlanStore",
    "bucketed_serving_fused_chain_groups",
    "bucketed_serving_plan_shape_groups", "bucketed_serving_plan_shapes",
    "cached_solve", "cached_solve_chain", "cached_solve_pareto",
    "chain_plan_key", "flatten_shape_groups", "pareto_plan_key", "plan_key",
    "prewarm_fused_plans", "prewarm_pareto_plans", "prewarm_tpu_plans",
    "resolve_default_store", "serving_plan_shapes", "tile_plan_from_store",
]
