"""B2: the GOMA-chain-planned fused gated-MLP kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``goma_fused_matmul`` of the reference
(``src/repro/kernels/goma_fused.py``).  The kernel is CUDA C++ for sm_90a
in ``csrc/goma_fused.cu``.  In fp32 one CTA per m-strip of bm rows holds
the two ``(bm, FF)`` fp32 strips in dynamic shared memory, accumulates
them over the plan's bk-deep k stages on the CUDA cores, rounds them to
the I/O dtype, combines, rounds again, and multiplies the strip by Wd.
In bf16 one CTA per 64-row tile runs B1's TMA ring and wgmma stage
routine: the g and u tiles over the full K, rounded, combined and
rounded into a (64, FF) bf16 strip in shared memory, which then
multiplies Wd on the tensor cores.  The intermediate never reaches
device memory.

What bounds it on the H100: the strips must fit one CTA's 227 KB of
shared memory, which caps ``bm * FF`` (the planner records larger chains
as unfused, so no served full-width MLP reaches it); within that, the
weight bytes.  It runs on the smoke configs, where its time is launch
overhead (PERF.md has its times beside its bound).

Bit-identity contract, as in the reference: the kernel equals the
composition of B1 kernels under ``plan.producer_plan()`` /
``plan.consumer_plan()`` with ``goma_combine`` between them, bit for bit.
On the card both run the same dot routine per dtype and the same combine
device function; on the CPU both run the same plain arithmetic.

``goma_fused_matmul`` and ``goma_combine`` launch their kernels for CUDA
tensors and count the launches; for CPU tensors they run the plain
versions.
"""
from __future__ import annotations

import torch

from ..core.hopper_mapping import (CTA_TILE, SMEM_BYTES, FusedTilePlan,
                                   fused_smem_bytes)
from . import _build
from .goma_gemm import (DTYPE_CODES, check_cuda_operands, dtype_key,
                        note_traced, pad_k, refuse_grad, traced)


def _gelu_tanh(g: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default tanh approximation, in the kernel's order
    return 0.5 * g * (1.0 + torch.tanh(
        0.7978845608028654 * (g + 0.044715 * (g * g * g))))


# Elementwise combines of (gate, up), in fp32 on values already rounded to
# the I/O dtype; the callers round the result once more.  The kernels'
# goma::combine (csrc/goma_tile.cuh) computes the same expressions.
ACTIVATIONS = {
    "silu_mul": lambda g, u: g / (1.0 + torch.exp(-g)) * u,
    "gelu_mul": lambda g, u: _gelu_tanh(g) * u,
    "sqrelu_mul": lambda g, u: torch.relu(g) * torch.relu(g) * u,
    "identity": lambda g, u: g * u,
}
# goma::Activation codes
ACTIVATION_CODES = {"silu_mul": 0, "gelu_mul": 1, "sqrelu_mul": 2,
                    "identity": 3}


def goma_combine_plain(g: torch.Tensor, u: torch.Tensor,
                       activation: str) -> torch.Tensor:
    """round(act(g, u)) with g, u already in the I/O dtype."""
    f32 = torch.float32
    return ACTIVATIONS[activation](g.to(f32), u.to(f32)).to(g.dtype)


def goma_combine(g: torch.Tensor, u: torch.Tensor,
                 activation: str = "silu_mul") -> torch.Tensor:
    """The combine between the links of the B1 composition, through the
    same device function as the fused kernel's epilogue.  Elementwise, so
    strided inputs (column slices of padded GEMM outputs) are made
    contiguous first."""
    if g.shape != u.shape or g.dtype != u.dtype:
        raise ValueError(f"gate {tuple(g.shape)} {g.dtype} and up "
                         f"{tuple(u.shape)} {u.dtype} differ")
    refuse_grad("goma_combine", g, u)
    if g.device.type != "cuda":
        if traced(g):
            note_traced("goma_combine", shape=tuple(g.shape), flops={},
                        nbytes=3 * g.numel() * g.element_size())
            return torch.empty_like(g)
        if g.device.type == "cpu":
            return goma_combine_plain(g, u, activation)
    g, u = g.contiguous(), u.contiguous()
    check_cuda_operands("goma_combine", g, u)
    out = torch.empty_like(g)
    err = _build.load().goma_combine_launch(
        g.data_ptr(), u.data_ptr(), out.data_ptr(), g.numel(),
        ACTIVATION_CODES[activation], DTYPE_CODES[g.dtype],
        torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, "goma_combine")
    goma_combine.launches += 1
    return out


goma_combine.launches = 0


def goma_fused_matmul_plain(a: torch.Tensor, wg: torch.Tensor,
                            wu: torch.Tensor, wd: torch.Tensor,
                            plan: FusedTilePlan, *,
                            activation: str = "silu_mul") -> torch.Tensor:
    """The fused op in the kernel's order: both strips accumulated over
    the plan's k stages in fp32, rounded to the I/O dtype, combined and
    rounded, then one full-depth fp32 dot with Wd, rounded."""
    pm, pff, pk, pn2 = plan.padded
    f32, io = torch.float32, a.dtype
    hg = torch.zeros((pm, pff), dtype=f32, device=a.device)
    hu = torch.zeros((pm, pff), dtype=f32, device=a.device)
    for k0 in range(0, pk, plan.bk):
        a_k = a[:, k0:k0 + plan.bk].to(f32)
        hg += a_k @ wg[k0:k0 + plan.bk].to(f32)
        hu += a_k @ wu[k0:k0 + plan.bk].to(f32)
    act = goma_combine_plain(hg.to(io), hu.to(io), activation)
    return (act.to(f32) @ wd.to(f32)).to(io)


def goma_fused_matmul(a: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                      wd: torch.Tensor, plan: FusedTilePlan, *,
                      activation: str = "silu_mul") -> torch.Tensor:
    """out = act(A@Wg, A@Wu) @ Wd on padded shapes.

    A: (pm, pk); Wg/Wu: (pk, pff); Wd: (pff, pn2).  The output has A's
    dtype.  A's rows from the plan's M on are padding and must be zero
    (the bf16 kernel does not read them)."""
    pm, pff, pk, pn2 = plan.padded
    if a.shape != (pm, pk) or wg.shape != (pk, pff) or \
            wu.shape != (pk, pff) or wd.shape != (pff, pn2):
        raise ValueError(f"operands {tuple(a.shape)}, {tuple(wg.shape)}, "
                         f"{tuple(wu.shape)}, {tuple(wd.shape)} do not "
                         f"match the plan's padded {plan.padded}")
    if not plan.fused or plan.bm <= 0:
        raise ValueError(f"unfused plan dispatched to the fused kernel: "
                         f"{plan}")
    refuse_grad("goma_fused_matmul", a, wg, wu, wd)
    if a.device.type != "cuda":
        if traced(a):
            M, FF, K, N2 = plan.M, plan.FF, plan.K, plan.N2
            note_traced("goma_fused_matmul", shape=(M, FF, K, N2),
                        nbytes=(M * K + 2 * K * FF + FF * N2 + M * N2)
                        * a.element_size(),
                        flops={dtype_key(a.dtype):
                               2 * M * K * FF * 2 + 2 * M * FF * N2})
            return a.new_empty((pm, pn2))
        if a.device.type == "cpu":
            return goma_fused_matmul_plain(a, wg, wu, wd, plan,
                                           activation=activation)
    check_cuda_operands("goma_fused_matmul", a, wg, wu, wd)
    bm, bk = plan.bm, plan.bk
    if bm % CTA_TILE or pff % CTA_TILE or pn2 % CTA_TILE or pm % bm or \
            pk % bk:
        raise ValueError(f"plan strips (bm={bm}, bk={bk}) do not tile "
                         f"{plan.padded} in {CTA_TILE}x{CTA_TILE} CTA "
                         f"tiles")
    smem = fused_smem_bytes(bm, pff)
    if smem > SMEM_BYTES:
        raise ValueError(f"fused strips need {smem} bytes of shared "
                         f"memory, a CTA has {SMEM_BYTES}")
    out = torch.empty((pm, pn2), dtype=a.dtype, device=a.device)
    if a.dtype == torch.bfloat16:
        a, wg, wu = pad_k(a, wg, wu)
    err = _build.load().goma_fused_launch(
        a.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
        out.data_ptr(), pm, pff, a.shape[1], pn2, bm, bk, plan.M,
        ACTIVATION_CODES[activation], DTYPE_CODES[a.dtype],
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "goma_fused_matmul")
    goma_fused_matmul.launches += 1
    return out


goma_fused_matmul.launches = 0
