"""The port's kernels: hand-written CUDA C++ for Hopper (sm_90a) with a
plain PyTorch version beside each.

  goma_gemm   — B1, the GOMA-planned GEMM (replaces the Pallas
                ``goma_matmul``).
  goma_fused  — B2, the GOMA-chain-planned fused gated MLP (replaces the
                Pallas ``goma_fused_matmul``), bit-identical to the B1
                composition.

ops.py holds the public wrappers, ref.py the plain oracles, _build.py the
nvcc build and ctypes binding (run at first launch, never at import).
"""
from .goma_fused import goma_combine, goma_fused_matmul
from .goma_gemm import goma_matmul
from .ops import fused_mlp, fused_mlp_composition, gemm, gemm_plan_info
from .ref import matmul_ref

__all__ = ["fused_mlp", "fused_mlp_composition", "gemm", "gemm_plan_info",
           "goma_combine", "goma_fused_matmul", "goma_matmul",
           "matmul_ref"]
