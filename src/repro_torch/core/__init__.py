"""GOMA core for the port: the geometric abstraction, closed-form energy
model and exact solver, copied verbatim from the reference package (only
import lines differ), plus ``hopper_mapping``, the H100 plan adapter.

    from repro_torch.core import Gemm, solve
    from repro_torch.core.hopper_mapping import H100_LIKE, plan_gemm_tiling
"""
from .certificate import (Certificate, check_constraints, objective_value,
                          verify)
from .fusion import (ChainCertificate, ChainSolveResult, GemmChain,
                     mlp_chain, solve_chain)
from .geometry import AXES, Gemm, Mapping, divisors
from .hardware import TPUV5E_LIKE, AcceleratorSpec, Ert
from .solver import SolveResult, solve

__all__ = [
    "AXES", "AcceleratorSpec", "Certificate", "ChainCertificate",
    "ChainSolveResult", "Ert", "Gemm", "GemmChain", "Mapping",
    "SolveResult", "TPUV5E_LIKE", "check_constraints", "divisors",
    "mlp_chain", "objective_value", "solve", "solve_chain", "verify",
]
