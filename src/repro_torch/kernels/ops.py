"""Public wrappers around the port's kernels (the counterpart of the
reference's ``kernels/ops.py``).

``gemm`` pads to the GOMA plan's padded shape, runs B1 and slices the
result back; ``fused_mlp`` does the same with B2, or with the three-GEMM
composition when the chain does not fuse.  Both run on the tensors'
device: the CUDA kernels for CUDA tensors, their plain versions for CPU
tensors.  ``force_plain=True`` picks the plain fp32-accumulated products
instead of the planned kernels (the counterpart of ``force_xla``).
Neither kernel path has a backward: with grad mode on and an operand
that requires grad both raise, on every device
(``goma_gemm.refuse_grad``); the plain products differentiate.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.hopper_mapping import plan_fused_mlp, plan_gemm_tiling
from ..obs.registry import get_registry
from ..obs.tracing import span as _span
from .goma_fused import goma_combine, goma_combine_plain, goma_fused_matmul
from .goma_gemm import goma_matmul, refuse_grad
from .ref import matmul_ref

_REG = get_registry()


def _pad2(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad a matrix to (rows, cols); contiguous, and not copied when
    it already has that shape."""
    if x.shape == (rows, cols):
        return x.contiguous()
    return F.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))


def gemm(a: torch.Tensor, b: torch.Tensor, *, force_plain: bool = False,
         plan=None) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] through the GOMA-planned B1 kernel.

    ``plan``: an explicit TpuTilePlan; default ``plan_gemm_tiling`` for the
    H100.  Counts one ``kernel.gemm.dispatch`` and, under a tracer, opens
    a ``kernel.gemm`` span."""
    _REG.inc("kernel.gemm.dispatch")
    with _span("kernel.gemm", m=int(a.shape[0]), n=int(b.shape[1]),
               k=int(a.shape[1]), force_plain=force_plain):
        if force_plain:
            return matmul_ref(a, b)
        refuse_grad("gemm", a, b)
        M, K = a.shape
        K2, N = b.shape
        if K != K2:
            raise ValueError(f"gemm: {tuple(a.shape)} @ {tuple(b.shape)}")
        if plan is None:
            plan = plan_gemm_tiling(M, N, K, dtype_bytes=a.element_size())
        if (plan.M, plan.N, plan.K) != (M, N, K):
            raise ValueError(f"plan {plan} is not for {(M, N, K)}")
        pm, pn, pk = plan.padded
        out = goma_matmul(_pad2(a, pm, pk), _pad2(b, pk, pn), plan)
        return out[:M, :N]


def gemm_plan_info(M: int, N: int, K: int, dtype_bytes: int = 2):
    """Expose the GOMA plan (for logging)."""
    return plan_gemm_tiling(M, N, K, dtype_bytes=dtype_bytes)


def fused_mlp_composition(a: torch.Tensor, wg: torch.Tensor,
                          wu: torch.Tensor, wd: torch.Tensor, plan, *,
                          activation: str = "silu_mul") -> torch.Tensor:
    """The unfused composition of B1 kernels under the fused plan's
    producer/consumer tilings, with ``goma_combine`` between them — the
    bit-identity oracle of the fused kernel."""
    M, K = a.shape
    N2 = wd.shape[1]
    pm, pff, pk, pn2 = plan.padded
    a_p = _pad2(a, pm, pk)
    hg = goma_matmul(a_p, _pad2(wg, pk, pff), plan.producer_plan())
    hu = goma_matmul(a_p, _pad2(wu, pk, pff), plan.producer_plan())
    act = goma_combine(hg, hu, activation)
    out = goma_matmul(act, _pad2(wd, pff, pn2), plan.consumer_plan())
    return out[:M, :N2]


def fused_mlp(a: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
              wd: torch.Tensor, *, activation: str = "silu_mul",
              force_plain: bool = False, plan=None) -> torch.Tensor:
    """``out[M,N2] = act(A@Wg, A@Wu) @ Wd`` through the GOMA-chain-planned
    fused B2 kernel.

    ``plan``: an explicit FusedTilePlan; default ``plan_fused_mlp`` for the
    H100.  When the chain does not fuse, runs the per-GEMM composition
    (three B1 launches) with ``goma_combine`` between them, as the
    reference does.  Counts one ``kernel.fused_mlp.dispatch`` and, under a
    tracer, opens a ``kernel.fused_mlp`` span."""
    _REG.inc("kernel.fused_mlp.dispatch")
    with _span("kernel.fused_mlp", m=int(a.shape[0]),
               ff=int(wg.shape[1]), k=int(a.shape[1]),
               n2=int(wd.shape[1]), force_plain=force_plain):
        M, K = a.shape
        K2, FF = wg.shape
        FF2, N2 = wd.shape
        if K != K2 or wu.shape != (K, FF) or FF2 != FF:
            raise ValueError(f"fused_mlp: {tuple(a.shape)}, "
                             f"{tuple(wg.shape)}, {tuple(wu.shape)}, "
                             f"{tuple(wd.shape)}")
        if force_plain:
            act = goma_combine_plain(matmul_ref(a, wg), matmul_ref(a, wu),
                                     activation)
            return matmul_ref(act, wd)
        refuse_grad("fused_mlp", a, wg, wu, wd)
        if plan is None:
            plan = plan_fused_mlp(M, FF, K, N2,
                                  dtype_bytes=a.element_size())
        if (plan.M, plan.FF, plan.K, plan.N2) != (M, FF, K, N2):
            raise ValueError(f"plan {plan} is not for {(M, FF, K, N2)}")
        if not plan.fused:
            act = goma_combine(gemm(a, wg), gemm(a, wu), activation)
            return gemm(act, wd)
        pm, pff, pk, pn2 = plan.padded
        out = goma_fused_matmul(_pad2(a, pm, pk), _pad2(wg, pk, pff),
                                _pad2(wu, pk, pff), _pad2(wd, pff, pn2),
                                plan, activation=activation)
        return out[:M, :N2]

