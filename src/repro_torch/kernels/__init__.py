"""The port's kernels: hand-written CUDA C++ for Hopper (sm_90a) with a
plain PyTorch version beside each.

  goma_gemm   — B1, the GOMA-planned GEMM (replaces the Pallas
                ``goma_matmul``).
  goma_fused  — B2, the GOMA-chain-planned fused gated MLP (replaces the
                Pallas ``goma_fused_matmul``), bit-identical to the B1
                composition.
  wkv6        — B3, the RWKV-6 WKV chunked scan (replaces the Pallas
                ``wkv6_pallas``).
  mamba2_ssd  — B4, the Mamba2 SSD chunked scan (replaces the Pallas
                ``ssd_pallas``).

ops.py holds the public GEMM wrappers, ref.py the plain oracles,
_build.py the nvcc build and ctypes binding (run at first launch, never
at import).
"""
from .goma_fused import goma_combine, goma_fused_matmul
from .goma_gemm import goma_matmul
from .mamba2_ssd import ssd_scan, ssd_scan_plain
from .ops import fused_mlp, fused_mlp_composition, gemm, gemm_plan_info
from .ref import matmul_ref, ssd_ref, wkv6_ref
from .wkv6 import wkv6_scan, wkv6_scan_plain

__all__ = ["fused_mlp", "fused_mlp_composition", "gemm", "gemm_plan_info",
           "goma_combine", "goma_fused_matmul", "goma_matmul",
           "matmul_ref", "ssd_ref", "ssd_scan", "ssd_scan_plain",
           "wkv6_ref", "wkv6_scan", "wkv6_scan_plain"]
