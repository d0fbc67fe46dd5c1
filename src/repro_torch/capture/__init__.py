"""Program capture: traced GEMM/chain discovery + planning IR (the
counterpart of the reference's ``repro.capture``).

Front end for planning *arbitrary torch programs*: trace a callable
(`trace`, on fake tensors at the pre-dispatch aten level), dedupe its
contraction sites and fusable chains into the unified
:class:`PlanProgram` IR (`program`), and lower the IR through the batch
planner in one pass (`plan`).  ``reference`` holds the LlmSpec reference
programs whose capture is differentially tested against the
hand-enumerated ``core.workloads`` tables.

The reference's jaxpr-specific ``harvest_jaxpr`` has the counterpart
``harvest_graph`` (it walks a traced fx graph); ``trace_graph`` is the
trace itself, the counterpart of ``jax.make_jaxpr``.
"""
from .plan import (ProgramPlan, capture_model_decode,
                   capture_model_prefill, capture_serving_program,
                   captured_serving_plan_shape_groups, plan_program,
                   serving_capture_shapes)
from .program import (PlanProgram, ProgramChain, ProgramGemm,
                      captured_program, diff_programs, programs_equal)
from .reference import (capture_spec_decode, capture_spec_prefill,
                        capture_spec_scenario)
from .trace import (CaptureResult, ChainSite, GemmSite, capture,
                    harvest_graph, trace_graph)

__all__ = [
    "CaptureResult", "ChainSite", "GemmSite", "PlanProgram",
    "ProgramChain", "ProgramGemm", "ProgramPlan", "capture",
    "capture_model_decode", "capture_model_prefill",
    "capture_serving_program", "capture_spec_decode",
    "capture_spec_prefill", "capture_spec_scenario",
    "captured_program", "captured_serving_plan_shape_groups",
    "diff_programs", "harvest_graph", "plan_program", "programs_equal",
    "serving_capture_shapes", "trace_graph",
]
