"""B1: the GOMA-planned GEMM kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``goma_matmul`` of the reference
(``src/repro/kernels/goma_gemm.py``).  The kernel is CUDA C++ for sm_90a
in ``csrc/goma_gemm.cu``.

What bounds it on the H100: at the served decode shapes (4 or 64 token
rows against llama3-8b's 4096 x 14336 or zamba2-2.7b's 2560 x 10240 MLP
weights) the weight bytes read from device memory; at zamba2-2.7b's
800-row prefill the tensor cores' bf16 rate.  GOMA's energy-optimal plan
blocks are wide (bn 512 or 640): one CTA per block would leave most of
the 132 SMs idle (4 to 28 CTAs at decode).

What the design does about it, in bf16: each plan block is cut into
64-row tiles of ``slice_n`` columns, one CTA each (``cta_slices`` picks
``slice_n`` to cover the card; ``cta_tiles`` lists the tiles in launch
order), adjacent in blockIdx and rastered in the plan's walk order.  In a
CTA one producer warp streams 64-deep k stages of A and B by TMA into a
ring of shared-memory stages, and one warpgroup multiplies them on the
tensor cores (wgmma) into fp32 registers.  Each output element is one
fp32 accumulator over k16 steps in increasing k, whatever the plan or
slice width.  A's map holds only the plan's M rows, so the padding rows
(zeros in every caller) are not read.  fp32 stays on the CUDA cores:
one CTA per plan block, one fmaf chain per element.

``goma_matmul`` launches the kernel for CUDA tensors and counts the
launch in ``goma_matmul.launches``; for CPU tensors it runs
``goma_matmul_plain``, which walks the plan's k stages in order with
fp32 accumulation, vectorised over m and n, and rounds where the kernel
does.  On a trace's fake tensor (``traced``) it returns an empty output
of the right shape, so a traced program sees the kernel as one opaque
node (``capture.trace``).
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from ..core.hopper_mapping import CTA_TILE, TpuTilePlan
from . import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# CTA tile widths the bf16 kernel is built for (columns), widest first
SLICE_WIDTHS = (128, 64, 32)
# the H100 SXM's streaming multiprocessors
SM_COUNT = 132


# the kernel calls a program analysis (``launch.hlo_analysis``) sees on
# meta tensors, while it collects them (``collect_traced``); None
# otherwise
traced_calls: list | None = None


def traced(t: torch.Tensor) -> bool:
    """True for a fake tensor of a trace (``capture.trace`` traces on
    fake tensors of the meta device), and for a meta tensor while a
    program analysis collects the kernel calls (``collect_traced``).  The
    wrappers then launch nothing and return an empty output of the
    kernel's shape.  Only the CPU and CUDA checks run before it, so a
    real CUDA tensor never takes that path, and a plain meta tensor
    outside an analysis is refused as any other device is."""
    return isinstance(t, FakeTensor) or (
        traced_calls is not None and t.device.type == "meta")


@contextlib.contextmanager
def collect_traced():
    """Collect into the list it yields every kernel call that a trace
    passes inside the block (``note_traced``)."""
    global traced_calls
    saved, traced_calls = traced_calls, []
    try:
        yield traced_calls
    finally:
        traced_calls = saved


def note_traced(name: str, *, nbytes: int, flops: dict,
                other_ops: int = 0, shape: tuple = ()) -> None:
    """Record, for a program analysis, one kernel call that a trace passes
    (on a trace's tensors the wrappers launch nothing, so the recorded
    program holds only the kernel's empty output): the bytes its function
    must move (each input read once, each output written once), its
    products' flops by the unit's type (``{"bfloat16": ...}``), its other
    operations and its shape."""
    if traced_calls is not None:
        traced_calls.append(dict(name=name, bytes=int(nbytes),
                                 flops=dict(flops), other_ops=int(other_ops),
                                 shape=tuple(int(x) for x in shape)))


def dtype_key(dtype: torch.dtype) -> str:
    """A dtype's name as the roofline's peaks are keyed (``bfloat16``)."""
    return str(dtype).removeprefix("torch.")


class NoBackwardError(RuntimeError):
    """A kernel was called where autograd would need its gradient."""


def refuse_grad(name: str, *ts: torch.Tensor) -> None:
    """Raise when grad mode is on and an operand requires grad: the
    kernels have no backward (the reference differentiates no Pallas
    kernel either: ``jax.grad`` through them fails), and on the card
    their outputs, written through raw pointers, would carry no
    ``grad_fn``, so the weights before them would train on no gradient
    without an error.  Raised on every device, the CPU's plain versions
    included, so that the CPU refuses what the card refuses."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NoBackwardError(
            f"{name} has no backward: run it under torch.no_grad() (or "
            f"inference_mode), or train with the config's fused_mlp and "
            f"use_pallas_scan off, as the reference trains")


def check_cuda_operands(name: str, *ts: torch.Tensor) -> None:
    """Raise unless every operand is a contiguous CUDA tensor of one dtype
    the kernels take (float32 or bfloat16), 16-byte aligned (a TMA map's
    base must be)."""
    dtype = ts[0].dtype
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
        if t.dtype != dtype or dtype not in DTYPE_CODES:
            raise ValueError(f"{name} takes float32 or bfloat16 operands "
                             f"of one dtype, not {[t.dtype for t in ts]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} takes contiguous row-major operands "
                             f"at 16-byte aligned addresses")


def pad_k(a: torch.Tensor, *bs: torch.Tensor) -> list[torch.Tensor]:
    """Zero-pad a k extent that is not a multiple of 8 (A's columns, each
    B's rows) to one: a TMA map's row stride must be a multiple of 16
    bytes.  Only a K under 64 can need it (larger K pads to 64)."""
    k = a.shape[1]
    if k % 8 == 0:
        return [a, *bs]
    extra = -k % 8
    return [F.pad(a, (0, extra))] + [F.pad(b, (0, 0, 0, extra)) for b in bs]


@functools.lru_cache(maxsize=1024)
def cta_slices(plan: TpuTilePlan) -> int:
    """The bf16 kernel's CTA tile width: the widest of ``SLICE_WIDTHS``
    that divides the plan's bn and still gives a CTA to a quarter of the
    SMs, else the narrowest that divides bn.

    Why not one CTA per SM: a narrow slice reads B in narrow TMA rows (64
    bytes at 32 columns), and on the H100 the wide ones streamed faster
    at the served shapes even with fewer CTAs; the one exception measured
    is the 128-row down projection of llama3-8b's scheduler, where 64
    columns on 128 CTAs beat 128 on 64 (PERF.md, B1's served shapes)."""
    pm, pn, _ = plan.padded
    bn = plan.block[1]
    fits = [w for w in SLICE_WIDTHS if bn % w == 0]
    if not fits:
        raise ValueError(f"plan block {plan.block} has no slice width in "
                         f"{SLICE_WIDTHS}")
    for w in fits:
        if (pm // CTA_TILE) * (pn // w) >= SM_COUNT // 4:
            return w
    return fits[-1]


def cta_tiles(plan: TpuTilePlan, slice_n: int) -> list[tuple[int, int]]:
    """The (row0, col0) of every CTA's 64 x slice_n output tile, in
    blockIdx order, as the kernel computes them: plan blocks in walk
    order (the walking axis fastest), then each block's 64-row bands,
    each band's slices adjacent."""
    pm, pn, _ = plan.padded
    bm, bn, _ = plan.block
    nbm, nbn = pm // bm, pn // bn
    slices = bn // slice_n
    m_fastest = plan.walk == "x"
    tiles = []
    for blk in range(nbm * nbn):
        im, in_ = ((blk % nbm, blk // nbm) if m_fastest
                   else (blk // nbn, blk % nbn))
        for sub in range((bm // CTA_TILE) * slices):
            tiles.append((im * bm + (sub // slices) * CTA_TILE,
                          in_ * bn + (sub % slices) * slice_n))
    return tiles


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


def goma_matmul(a: torch.Tensor, b: torch.Tensor, plan: TpuTilePlan, *,
                slice_n: int | None = None) -> torch.Tensor:
    """C = A @ B on padded shapes; A: (pm, pk), B: (pk, pn), row-major;
    C has A's dtype.  A's rows from the plan's M on are padding and must
    be zero (the bf16 kernel does not read them).  ``slice_n``: the bf16
    kernel's CTA tile width, default ``cta_slices(plan)``."""
    pm, pn, pk = plan.padded
    bm, bn, bk = plan.block
    if a.shape != (pm, pk) or b.shape != (pk, pn):
        raise ValueError(f"operands {tuple(a.shape)} @ {tuple(b.shape)} do "
                         f"not match the plan's padded {plan.padded}")
    refuse_grad("goma_matmul", a, b)
    if a.device.type != "cuda":
        if traced(a):
            M, N, K = plan.M, plan.N, plan.K
            note_traced("goma_matmul", shape=(M, N, K),
                        nbytes=(M * K + K * N + M * N) * a.element_size(),
                        flops={dtype_key(a.dtype): 2 * M * N * K})
            return a.new_empty((pm, pn))
        if a.device.type == "cpu":
            return goma_matmul_plain(a, b, plan)
    check_cuda_operands("goma_matmul", a, b)
    if bm % CTA_TILE or bn % CTA_TILE or pm % bm or pn % bn or pk % bk:
        raise ValueError(f"plan block {plan.block} does not tile "
                         f"{plan.padded} in {CTA_TILE}x{CTA_TILE} CTA tiles")
    if slice_n is None:
        slice_n = cta_slices(plan)
    if slice_n not in SLICE_WIDTHS or bn % slice_n:
        raise ValueError(f"slice width {slice_n} is not one of "
                         f"{SLICE_WIDTHS} dividing bn = {bn}")
    c = torch.empty((pm, pn), dtype=a.dtype, device=a.device)
    if a.dtype == torch.bfloat16:
        a, b = pad_k(a, b)
    err = _build.load().goma_matmul_launch(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), pm, pn, a.shape[1], bm,
        bn, bk, int(plan.walk == "x"), plan.M, slice_n,
        DTYPE_CODES[a.dtype], torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "goma_matmul")
    goma_matmul.launches += 1
    return c


goma_matmul.launches = 0
