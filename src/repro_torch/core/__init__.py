"""GOMA core for the port: the geometric abstraction, closed-form energy
model, exact solver, step-by-step simulator oracle, the mapper baselines
and the co-design sweep, copied verbatim from the reference package (only
import lines differ), plus ``hopper_mapping``, the H100 plan adapter.
Exports every public name of the reference's ``repro.core``.

    from repro_torch.core import Gemm, TEMPLATES, solve
    res = solve(Gemm(4096, 14336, 4096), TEMPLATES["eyeriss-like"])
    from repro_torch.core.hopper_mapping import H100_LIKE, plan_gemm_tiling
"""
from .certificate import (Certificate, check_constraints, objective_value,
                          verify, verify_by_enumeration)
from .edp import EdpReport, delay_ns, evaluate
from .energy import (AccessCounts, EnergyBreakdown, analytical_counts,
                     analytical_energy, closed_form_is_exact, energy)
from .fusion import (ChainCertificate, ChainSolveResult, GemmChain,
                     mlp_chain, solve_chain)
from .geometry import (AXES, Gemm, Mapping, divisor_chains, divisors,
                       enumerate_mappings, mapping_space_size)
from .hardware import (A100_LIKE, EYERISS_LIKE, GEMMINI_LIKE, TEMPLATES,
                       TPUV1_LIKE, TPUV5E_LIKE, AcceleratorSpec, Ert)
from .sim_oracle import simulate_counts
from .solver import SolveResult, solve
from .timeloop_ref import reference_counts, reference_energy

__all__ = [
    "AXES", "A100_LIKE", "AcceleratorSpec", "AccessCounts", "Certificate",
    "ChainCertificate", "ChainSolveResult", "EdpReport", "EnergyBreakdown",
    "Ert", "EYERISS_LIKE", "GEMMINI_LIKE", "Gemm", "GemmChain", "Mapping",
    "SolveResult", "TEMPLATES", "TPUV1_LIKE",
    "TPUV5E_LIKE", "analytical_counts", "analytical_energy",
    "check_constraints", "closed_form_is_exact", "delay_ns",
    "divisor_chains", "divisors", "energy", "enumerate_mappings",
    "evaluate", "mapping_space_size", "mlp_chain", "objective_value",
    "reference_counts", "reference_energy", "simulate_counts", "solve",
    "solve_chain", "verify", "verify_by_enumeration",
]
