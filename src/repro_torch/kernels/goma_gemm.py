"""B1: the GOMA-planned GEMM kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``goma_matmul`` of the reference
(``src/repro/kernels/goma_gemm.py``).  The kernel is CUDA C++ for sm_90a
in ``csrc/goma_gemm.cu``: one CTA per plan block (bm, bn), rasterised so
that GOMA's walking axis varies fastest, with the k axis walked inside
the CTA in the plan's bk-deep stages and fp32 accumulators, one fmaf
chain per output element in increasing k.

What bounds it on the H100: at the serving shapes (M <= 64 token rows
against 4096 x 14336 weights) the weight bytes read from device memory.
This first version is simple and right rather than fast: fp32 FMA on the
CUDA cores, no tensor cores, no TMA, no pipelining (PERF.md has its
times beside its bound).

``goma_matmul`` launches the kernel for CUDA tensors and counts the
launch in ``goma_matmul.launches``; for CPU tensors it runs
``goma_matmul_plain``, which walks the same k stages in the same order
with fp32 accumulation, vectorised over m and n, and rounds where the
kernel does.
"""
from __future__ import annotations

import torch

from ..core.hopper_mapping import CTA_TILE, TpuTilePlan
from . import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_cuda_operands(name: str, *ts: torch.Tensor) -> None:
    """Raise unless every operand is a contiguous CUDA tensor of one dtype
    the kernels take (float32 or bfloat16)."""
    dtype = ts[0].dtype
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
        if t.dtype != dtype or dtype not in DTYPE_CODES:
            raise ValueError(f"{name} takes float32 or bfloat16 operands "
                             f"of one dtype, not {[t.dtype for t in ts]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous row-major operands")


def goma_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                      plan: TpuTilePlan) -> torch.Tensor:
    """C = A @ B on padded shapes, in the kernel's k-stage order."""
    pm, pn, pk = plan.padded
    bk = plan.block[2]
    acc = torch.zeros((pm, pn), dtype=torch.float32, device=a.device)
    for k0 in range(0, pk, bk):
        acc += (a[:, k0:k0 + bk].to(torch.float32)
                @ b[k0:k0 + bk].to(torch.float32))
    return acc.to(a.dtype)


def goma_matmul(a: torch.Tensor, b: torch.Tensor,
                plan: TpuTilePlan) -> torch.Tensor:
    """C = A @ B on padded shapes; A: (pm, pk), B: (pk, pn), row-major;
    C has A's dtype."""
    pm, pn, pk = plan.padded
    bm, bn, bk = plan.block
    if a.shape != (pm, pk) or b.shape != (pk, pn):
        raise ValueError(f"operands {tuple(a.shape)} @ {tuple(b.shape)} do "
                         f"not match the plan's padded {plan.padded}")
    if a.device.type == "cpu":
        return goma_matmul_plain(a, b, plan)
    check_cuda_operands("goma_matmul", a, b)
    if bm % CTA_TILE or bn % CTA_TILE or pm % bm or pn % bn or pk % bk:
        raise ValueError(f"plan block {plan.block} does not tile "
                         f"{plan.padded} in {CTA_TILE}x{CTA_TILE} CTA tiles")
    c = torch.empty((pm, pn), dtype=a.dtype, device=a.device)
    lib = _build.load()
    err = lib.goma_matmul_launch(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), pm, pn, pk, bm, bn, bk,
        int(plan.walk == "x"), DTYPE_CODES[a.dtype],
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "goma_matmul")
    goma_matmul.launches += 1
    return c


goma_matmul.launches = 0
