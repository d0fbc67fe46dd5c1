"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
checks that the bf16 GEMM kernels and the scans run on the tensor cores
(HGMMA, or TF32 HMMA, in their SASS), holds each kernel against its plain
PyTorch version on the card and B1's bf16 bits against every
decomposition of one problem, and serves three paths, checking each
one's launch counts:

- ``llama3-8b``: the smoke config through the fused kernel (B2), the
  full width through the GEMM kernel (B1) and ``goma_combine``;
- ``rwkv6-7b``: the smoke config (card tokens == CPU tokens) and the
  full width, with the prefill's WKV6 scans through B3;
- ``zamba2-2.7b``: the smoke config (card tokens == CPU tokens) and the
  full width, with the prefill's Mamba2 scans through B4 and the shared
  block's MLP through B1 and ``goma_combine``.

Imports nothing of JAX and nothing of the reference package.

Output: one line per phase with its time; then the card's name and power
limit, a ``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.  With ``--out DIR`` the per-shape
kernel numbers also go to ``DIR/chip_smoke.json``, and one more
full-width ``generate`` of each model runs under ``torch.profiler``:
device time by kernel and the device's busy and idle shares go to
``DIR/profile_serve.{json,txt}`` (llama3-8b),
``DIR/profile_serve_rwkv.{json,txt}`` and
``DIR/profile_serve_zamba2.{json,txt}``.  Any failed phase raises and
ends the script with a non-zero code; without a CUDA card it prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TF32_FLOPS = 495e12   # the tensor cores' TF32 rate, which 3xTF32 runs at
# kernel vs its plain version: the reference's kernel tolerances
# (tests/test_kernels.py), as rtol = atol; fp32 sums differ only in order,
# bf16 outputs may differ by one rounding of the output
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
FUSED_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# tests/test_kernels.py's MATRIX_SHAPES that need padding on some axis
ODD_SHAPES = [(300, 200, 100), (129, 257, 65), (100, 50, 1)]
# every path serves batch 4 and 8 new tokens
FULL = dict(arch="llama3-8b", batch=4, prompt_len=16, new_tokens=8)
# the recurrent paths' prompts: 200 is two chunks of 128 at full width,
# the second one padded; 12 is two chunks of the smoke configs' 8
RECURRENT = dict(prompt_len=200, smoke_prompt_len=12)
# the served bf16 MLPs that run B1 and goma_combine: their rows at decode
# and in the prefill (batch x prompt), and their (d_ff, d_model)
SERVED_MLPS = {
    "llama3-8b": ((FULL["batch"], FULL["batch"] * FULL["prompt_len"]),
                  14336, 4096),
    "zamba2-2.7b": ((FULL["batch"],
                     FULL["batch"] * RECURRENT["prompt_len"]), 10240, 2560)}
# the scans against their plain versions: the reference's tolerances
# (tests/test_kernels.py), relative to the plain version's largest
# magnitude: y 1e-4 (bf16 y 5e-2), state 2e-3 (B3) and 1e-3 (B4)
SCAN_Y_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# the recurrent paths' full-width prefill scans (batch x prompt 200 padded
# to two chunks of 128): rwkv6-7b's (B, S, H, P), zamba2-2.7b's (B, S, H,
# P, N)
FULL_WKV, FULL_SSD = (4, 256, 64, 64), (4, 256, 80, 64, 64)
WKV_STATE_TOL, SSD_STATE_TOL = 2e-3, 1e-3
# full-width prefill logits, kernel path (B3/B4, and B1 in zamba2's
# shared MLP) against the plain path (chunked scans, plain MLP) on the
# card, on the served model's weights computed in fp32, relative to the
# plain logits' largest magnitude.  Sums taken in another order differ by
# about 1e-7 relative per operation; 32 or 54 layers leave them near
# 5e-5, and a wrong scan moves the logits by their whole scale.  In the
# served bf16 model such a difference flips bf16 roundings (2^-8) that
# every later layer of a random-weight model carries and amplifies, so
# the bf16 gap is measured and not held to a tolerance.
PATH_TOL = 1e-3
SEED = 0


@contextlib.contextmanager
def phase(name: str):
    """Print the phase's name, and its time when it ends without error."""
    t0 = time.perf_counter()
    print(f"[phase] {name} ...", flush=True)
    yield
    print(f"[phase] {name}: ok in {time.perf_counter() - t0:.2f} s",
          flush=True)


def time_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of fn() after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, tries: int = 3) -> float:
    """Device time of one fn() by torch.profiler: the time of the device
    kernels that ``reps`` calls ran, over ``reps``, after one warm-up.
    Unlike time_ms it leaves out the host's launch overhead.  A profile
    that recorded no device time at all (the profiler's tracing did not
    start) is taken again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / reps
    raise AssertionError(f"the profiler recorded no device time in {tries} "
                         f"tries")


def bound_ms(nbytes: int, flops: int, dtype: torch.dtype) -> tuple[float,
                                                                    str]:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of the type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def close(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Max abs error; raises unless |got - want| <= tol + tol * |want|."""
    err = (got.float() - want.float()).abs()
    bad = err > tol + tol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{int(bad.sum())} elements beyond tol {tol}, "
                             f"max abs err {float(err.max()):.3g}")
    return float(err.max())


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def rand(shape, dtype, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


# --------------------------------------------------------------- phase 2
# the tensor-core kernels by library: a pattern of the SASS function name
# (its mangled name), the instruction that must appear, and how to name it
MMA_KERNELS = (
    ("libgoma_gemm.so", r"goma_matmul_wgmmaILi(\d+)E", "HGMMA",
     "goma_matmul_wgmma<{}>"),
    ("libgoma_fused.so", r"goma_fused_wgmma()", "HGMMA", "goma_fused_wgmma"),
    ("libwkv6.so", r"(wkv6_kernel)I(f|13__nv_bfloat16)()E",
     "HMMA.1688.F32.TF32", "{}<{}{}>"),
    ("libmamba2_ssd.so",
     r"(ssd_scan_kernel|ssd_cb_kernel)I(f|13__nv_bfloat16)((?:Li\d+E)*)E",
     "HMMA.1688.F32.TF32", "{}<{}{}>"))
# the names' parts as C++ writes them: the I/O type, the (P, N) sizes
TYPES = {"f": "float", "13__nv_bfloat16": "bf16"}


def mma_counts(lib_dir: pathlib.Path) -> dict | None:
    """Tensor-core instructions in each tensor-core kernel of the built
    libraries, from ``cuobjdump -sass``: HGMMA (wgmma) in the bf16 GEMM
    kernels, TF32 HMMA (mma.sync m16n8k8, the 3xTF32 products) in the
    scans; None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    counts = {}
    for lib, pattern, op, label in MMA_KERNELS:
        sass = subprocess.run([tool, "-sass", str(lib_dir / lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        name = None
        for line in sass.splitlines():
            if "Function :" in line:
                m = re.search(pattern, line)
                name = None if m is None else label.format(
                    *(TYPES.get(g, re.sub(r"Li(\d+)E", r", \1", g))
                      for g in m.groups()))
                if name:
                    counts[name] = 0
            elif name and op in line:
                counts[name] += 1
    return counts


# --------------------------------------------------------------- phase 3
def b1_operands(plan, dtype, gen):
    """Padded B1 operands for a plan: A's rows from plan.M on and the
    padding of both are zero, as every caller pads."""
    M, N, K = plan.M, plan.N, plan.K
    pm, pn, pk = plan.padded
    a = torch.zeros((pm, pk), dtype=dtype, device="cuda")
    a[:M, :K] = rand((M, K), dtype, gen)
    b = torch.zeros((pk, pn), dtype=dtype, device="cuda")
    b[:K, :N] = rand((K, N), dtype, gen, K ** -0.5)
    return a, b


def check_b1(shape, dtype, gen, *, timed: bool) -> dict:
    """B1 against its plain version on padded operands under the H100
    plan, with its CTA decomposition; with ``timed``, also kernel, plain
    and torch.matmul times (events, and device time by the profiler), the
    kernel's device time at every slice width, and its shares."""
    from repro_torch.core.hopper_mapping import plan_gemm_tiling
    from repro_torch.kernels import _build
    from repro_torch.kernels.goma_gemm import (SLICE_WIDTHS, cta_slices,
                                               cta_tiles, goma_matmul,
                                               goma_matmul_plain)
    M, N, K = shape
    plan = plan_gemm_tiling(M, N, K, dtype_bytes=dtype.itemsize)
    pm, pn, pk = plan.padded
    a, b = b1_operands(plan, dtype, gen)
    got = goma_matmul(a, b, plan)
    want = goma_matmul_plain(a, b, plan)
    torch.cuda.synchronize()
    row = {"shape": [M, N, K], "padded": [pm, pn, pk],
           "block": list(plan.block), "grid_order": "".join(plan.grid_order),
           "dtype": dtype_name(dtype),
           "max_abs_err": close(got, want, TOL[dtype])}
    if dtype == torch.bfloat16:
        width = cta_slices(plan)
        row.update(slice_n=width, ctas=len(cta_tiles(plan, width)),
                   stages=_build.load().goma_matmul_stages(width))
    else:   # fp32: one CTA per plan block
        row.update(slice_n=None,
                   ctas=(pm // plan.block[0]) * (pn // plan.block[1]),
                   stages=None)
    if timed:
        # the work the product needs: the unpadded operands and flops
        nbytes = (M * K + K * N + M * N) * dtype.itemsize
        bound, by = bound_ms(nbytes, 2 * M * N * K, dtype)
        row.update(
            ms=time_ms(lambda: goma_matmul(a, b, plan)),
            device_ms=device_ms(lambda: goma_matmul(a, b, plan)),
            plain_ms=time_ms(lambda: goma_matmul_plain(a, b, plan)),
            library_ms=time_ms(lambda: torch.matmul(a, b)),
            library_device_ms=device_ms(lambda: torch.matmul(a, b)),
            bound_ms=bound, bound_by=by)
        row.update(
            bound_share=bound / row["ms"],
            vs_library=row["ms"] / row["library_ms"],
            device_bound_share=bound / row["device_ms"],
            device_vs_library=row["device_ms"] / row["library_device_ms"],
            device_ms_by_slice={
                w: device_ms(lambda: goma_matmul(a, b, plan, slice_n=w))
                for w in SLICE_WIDTHS if plan.block[1] % w == 0})
    return row


def check_tiling_independence(gen) -> list[dict]:
    """bf16 B1 gives the same bits under every decomposition of one padded
    problem: a served decode shape at every slice width, and a 128 x 128
    x 128 problem under plans with bk 32, 64 and 128 and different (bm,
    bn), each at every slice width.  Raises on any difference."""
    from repro_torch.core.hopper_mapping import TpuTilePlan, plan_gemm_tiling
    from repro_torch.kernels.goma_gemm import SLICE_WIDTHS, goma_matmul
    rows = []
    hand = [TpuTilePlan(M=128, N=128, K=128, padded=(128, 128, 128),
                        block=blk, grid_order=("m", "n", "k"), walk="z",
                        objective=0.0, solve_time_s=0.0)
            for blk in ((128, 128, 32), (64, 128, 64), (128, 64, 128))]
    for plans in ([plan_gemm_tiling(4, 14336, 4096, dtype_bytes=2)],
                  [plan_gemm_tiling(128, 128, 128, dtype_bytes=2)] + hand):
        a, b = b1_operands(plans[0], torch.bfloat16, gen)
        outs = [(p.block, w, goma_matmul(a, b, p, slice_n=w))
                for p in plans for w in SLICE_WIDTHS
                if p.block[1] % w == 0]
        torch.cuda.synchronize()
        first = outs[0][2]
        differ = [(blk, w) for blk, w, o in outs if not torch.equal(o, first)]
        if differ:
            raise AssertionError(f"B1 bits depend on the decomposition: "
                                 f"{differ} differ from {outs[0][:2]}")
        rows.append({"shape": [plans[0].M, plans[0].N, plans[0].K],
                     "decompositions": [[list(blk), w]
                                        for blk, w, _ in outs],
                     "bitwise_equal": True})
    return rows


def check_b2(M, FF, K, dtype, gen, *, plan=None, timed: bool) -> dict:
    """B2 against its plain version, and bit for bit against the B1
    composition under the plan's producer/consumer tilings."""
    from repro_torch.core.hopper_mapping import plan_fused_mlp
    from repro_torch.kernels.goma_fused import (goma_fused_matmul,
                                                goma_fused_matmul_plain)
    from repro_torch.kernels.ops import fused_mlp_composition
    if plan is None:
        plan = plan_fused_mlp(M, FF, K, dtype_bytes=dtype.itemsize)
    if not plan.fused:
        raise AssertionError(f"chain {(M, FF, K)} does not fuse: {plan}")
    pm, pff, pk, pn2 = plan.padded
    a = torch.zeros((pm, pk), dtype=dtype, device="cuda")
    a[:M, :K] = rand((M, K), dtype, gen)
    wg, wu = (rand((pk, pff), dtype, gen, pk ** -0.5) for _ in range(2))
    wd = rand((pff, pn2), dtype, gen, pff ** -0.5)
    got = goma_fused_matmul(a, wg, wu, wd, plan)
    comp = fused_mlp_composition(a, wg, wu, wd, plan)
    want = goma_fused_matmul_plain(a, wg, wu, wd, plan)
    torch.cuda.synchronize()
    if not torch.equal(got, comp):
        diff = int((got != comp).sum())
        raise AssertionError(f"B2 != B1 composition on {diff} elements "
                             f"(plan {plan})")
    row = {"shape": [M, FF, K], "padded": list(plan.padded),
           "bm": plan.bm, "bk": plan.bk,
           "dtype": dtype_name(dtype),
           "bitwise_equal_composition": True,
           "max_abs_err": close(got, want, FUSED_TOL[dtype])}
    if timed:
        # the work the chain needs: the unpadded operands and flops
        m, ff, k, n2 = plan.M, plan.FF, plan.K, plan.N2
        nbytes = (m * k + 2 * k * ff + ff * n2 + m * n2) * dtype.itemsize
        flops = 2 * m * k * ff * 2 + 2 * m * ff * n2
        bound, by = bound_ms(nbytes, flops, dtype)
        row.update(
            ms=time_ms(lambda: goma_fused_matmul(a, wg, wu, wd, plan)),
            plain_ms=time_ms(
                lambda: goma_fused_matmul_plain(a, wg, wu, wd, plan)),
            library_ms=None, bound_ms=bound, bound_by=by)
    return row


# operations of one silu_mul element: neg, exp, add, div, mul
COMBINE_OPS = 5


def check_combine(shape, dtype, gen, *, timed: bool) -> dict:
    """B2's combine as the composition launches it (goma_combine) against
    its plain version."""
    from repro_torch.kernels.goma_fused import (goma_combine,
                                                goma_combine_plain)
    g, u = rand(shape, dtype, gen), rand(shape, dtype, gen)
    got = goma_combine(g, u)
    want = goma_combine_plain(g, u, "silu_mul")
    torch.cuda.synchronize()
    row = {"shape": list(shape), "dtype": dtype_name(dtype),
           "max_abs_err": close(got, want, TOL[dtype])}
    if timed:
        n = g.numel()
        bound, by = bound_ms(3 * n * dtype.itemsize, COMBINE_OPS * n, dtype)
        row.update(
            ms=time_ms(lambda: goma_combine(g, u)),
            plain_ms=time_ms(lambda: goma_combine_plain(g, u, "silu_mul")),
            library_ms=None, bound_ms=bound, bound_by=by)
    return row


def close_to_scale(got: torch.Tensor, want: torch.Tensor,
                   tol: float) -> float:
    """Max abs error; raises unless it is within tol of the plain
    version's scale, max(1, max |want|)."""
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    if not err <= tol * scale:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"max abs err {err:.3g} > {tol} x {scale:.3g}")
    return err


def device_kernels(fn) -> dict:
    """The device kernels one call of fn runs, by name, with their
    counts (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def brief(row: dict) -> dict:
    """A scan row with the plain version's device kernels by name only
    where they come from cuBLAS (the rest go to --out)."""
    return {**row, "plain_device_kernels": {
        k[:90]: n for k, n in row["plain_device_kernels"].items()
        if "gemm" in k or "gemv" in k}}


def wkv6_ops(B, S, H, P, C) -> int:
    """The CUDA-core yardstick: operations of the WKV6 scan as the
    reference's algorithm does them, all at the fp32 rate (an exp counts
    as one), per chunk and head: the intra-chunk scores (sub, exp, two multiplies and an add
    for each t > s and p), the bonus, the decay folds, y = scores @ v +
    r @ S, and the state update."""
    per = (C * (C - 1) // 2 * P * 5 + C * P * 3 + C * P * 5
           + C * (C + 1) // 2 * P * 2 + C * P * P * 2
           + C * P * P * 2 + P * P)
    return B * H * (S // C) * per


def ssd_ops(B, S, H, P, N, C) -> int:
    """The CUDA-core yardstick: operations of the SSD scan as the
    reference's algorithm does them, all at the fp32 rate (an exp counts
    as one): C Bm^T once per batch row and chunk (it is the same for every
    head); per chunk and head the cumsum, xh . dt, the decayed scores, y =
    scores @ xdt + exp(cum) C S^T, and the state update."""
    per_row = C * (C + 1) // 2 * N * 2
    per_head = (C * 2 + C * P + C * (C + 1) // 2 * 3
                + C * (C + 1) // 2 * P * 2 + C * N * P * 2 + C * P * 2
                + C + P * N * C * 2 + P * N + C * P + C * 2)
    return B * (S // C) * (per_row + H * per_head)


# the scan kernels' sub-chunk and B3's decay-factoring block (csrc/)
SUB, BLK = 32, 16


def wkv6_work(B, S, H, P) -> tuple[int, int]:
    """(product flops, other operations) of the factored WKV6 scan, per
    sub-chunk of SUB tokens and head.  Products: the scores below the
    diagonal blocks (BLK x BLK x P), y's intra part (block rows of 16 and
    32 keys) and r S, and the state update k^T v.  Other operations (an
    exp counts as one): the diagonal blocks' exact terms (sub, exp, two
    multiplies, an add) and bonus, the factors of the block below them,
    the cumsum, the decay folds and the state's decay."""
    products = 2 * (BLK * BLK * P + (BLK * BLK + BLK * 2 * BLK) * P
                    + 2 * SUB * P * P)
    pairs = 2 * BLK * (BLK - 1) // 2
    other = (pairs * P * 5 + SUB * P * 3 + 2 * BLK * P * 3 + SUB * P
             + SUB * P * 5 + P + 2 * P * P)
    n = B * H * -(-S // SUB)
    return n * products, n * other


def ssd_work(B, S, H, P, N) -> tuple[int, int]:
    """(product flops, other operations) of the SSD scan as the kernels do
    it: C Bm^T once per (batch, sub-chunk); per sub-chunk and head y's
    intra part (block rows of 16 and 32 keys), C S^T and the state update.
    Other operations (an exp counts as one): the cumsum and its exps, the
    decayed scores (sub, exp, multiply), xh dt, the suffix and exp(cum)
    scalings, and the state's decay."""
    subs = -(-S // SUB)
    products = (B * subs * 2 * SUB * SUB * N
                + B * H * subs * 2 * ((BLK * BLK + BLK * 2 * BLK) * P
                                      + 2 * SUB * N * P))
    other = B * H * subs * (SUB * 5 + SUB * (SUB + 1) // 2 * 3
                            + SUB * P * 4 + 2 * P * N)
    return products, other


def scan_bound(nbytes: int, products: int, other: int) -> tuple[float, str]:
    """The least time the card could take for a scan's work: the largest
    of its bytes over the memory rate, its products over the TF32
    tensor-core rate and its other operations over the fp32 rate (the
    three run on separate units)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(products / TF32_FLOPS, other / PEAK_FLOPS[torch.float32]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# log-decays per step: "typical" as the reference's kernel tests draw
# them (B3 -exp(N(0,1) - 2), B4 a_log N(0,1) * 0.2 with dt = softplus
# N(0,1): about e^-90 a chunk of 128); "mild": B3 at the model's decay
# bias -6, B4 at a_log -4 (-1 to -2 a chunk), so that the state carried
# from one chunk into the next is visible; "strong": B3 down to -5 a step,
# where the factored partial products underflow (B4: a_log 1.5)
WKV_LOGW = {"typical": lambda z: -torch.exp(z - 2.0),
            "mild": lambda z: -torch.exp(z * 0.5 - 6.0),
            "strong": lambda z: -5.0 * torch.special.ndtr(z)}
SSD_A_LOG = {"typical": 0.0, "mild": -4.0, "strong": 1.5}


def scan_timing(fn, plain, nbytes, work, cuda_core_ops, ctas, smem,
                ctas_per_sm) -> dict:
    """A scan row's times (events and the profiler's device time, the
    plain version's), its bound and the CUDA-core yardstick's, and its
    CTAs."""
    bound, by = scan_bound(nbytes, *work)
    cuda_core_bound, _ = bound_ms(nbytes, cuda_core_ops, torch.float32)
    row = {"ms": time_ms(fn), "device_ms": device_ms(fn),
           "plain_ms": time_ms(plain), "library_ms": None,
           "bound_ms": bound, "bound_by": by,
           "cuda_core_bound_ms": cuda_core_bound,
           "product_flops": work[0], "other_ops": work[1], "bytes": nbytes,
           "ctas": ctas, "smem_bytes": smem, "ctas_per_sm": ctas_per_sm}
    row.update(bound_share=bound / row["ms"],
               device_bound_share=bound / row["device_ms"])
    return row


def check_wkv6(shape, chunk, dtype, gen, *, decay="typical",
               timed=True) -> dict:
    """B3 against its plain version and, in y, against the sequential
    oracle, which sums in another order; timed: kernel and plain times,
    the bound, and the device kernels the plain version runs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.goma_gemm import DTYPE_CODES
    from repro_torch.kernels.ref import wkv6_ref
    from repro_torch.kernels.wkv6 import wkv6_scan, wkv6_scan_plain
    B, S, H, P = shape
    r, k, v = (rand(shape, dtype, gen, 0.5) for _ in range(3))
    logw = WKV_LOGW[decay](torch.randn(shape, generator=gen,
                                       device="cuda")).to(dtype)
    u = torch.randn((H, P), generator=gen, device="cuda") * 0.3
    y, st = wkv6_scan(r, k, v, logw, u, chunk=chunk)
    want_y, want_st = wkv6_scan_plain(r, k, v, logw, u, chunk=chunk)
    torch.cuda.synchronize()
    row = {"shape": list(shape), "chunk": chunk, "decay": decay,
           "dtype": dtype_name(dtype),
           "y_scale": float(want_y.float().abs().max()),
           "max_abs_err": close_to_scale(y, want_y, SCAN_Y_TOL[dtype]),
           "state_max_abs_err": close_to_scale(st, want_st, WKV_STATE_TOL),
           "oracle_max_abs_err": close_to_scale(
               y, wkv6_ref(*(t.float() for t in (r, k, v, logw)), u),
               SCAN_Y_TOL[dtype])}
    if timed:
        lib, code = _build.load(), DTYPE_CODES[dtype]
        # bytes: r, k, v, logw read and y written once, u, the final state
        nbytes = (5 * B * S * H * P * dtype.itemsize + H * P * 4
                  + B * H * P * P * 4)
        row.update(scan_timing(
            lambda: wkv6_scan(r, k, v, logw, u, chunk=chunk),
            lambda: wkv6_scan_plain(r, k, v, logw, u, chunk=chunk), nbytes,
            wkv6_work(B, S, H, P), wkv6_ops(B, S, H, P, chunk), B * H,
            lib.wkv6_smem_bytes(code), lib.wkv6_ctas_per_sm(code)))
        row["plain_device_kernels"] = device_kernels(
            lambda: wkv6_scan_plain(r, k, v, logw, u, chunk=chunk))
        print(f"  B3 {brief(row)}")
    else:
        print(f"  B3 {row}")
    return row


def check_ssd(shape, chunk, dtype, gen, *, decay="typical",
              timed=True) -> dict:
    """B4 against its plain version and, in y, against the sequential
    oracle (with D = 0), which sums in another order; timed: kernel and
    plain times, the bound, and the device kernels the plain version
    runs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.goma_gemm import DTYPE_CODES
    from repro_torch.kernels.mamba2_ssd import ssd_scan, ssd_scan_plain
    from repro_torch.kernels.ref import ssd_ref
    B, S, H, P, N = shape
    xh = rand((B, S, H, P), dtype, gen, 0.5)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda")).to(dtype)
    a_log = (torch.randn((H,), generator=gen, device="cuda") * 0.2
             + SSD_A_LOG[decay])
    Bm, Cm = (rand((B, S, N), dtype, gen, 0.5) for _ in range(2))
    y, st = ssd_scan(xh, dt, a_log, Bm, Cm, chunk=chunk)
    want_y, want_st = ssd_scan_plain(xh, dt, a_log, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    row = {"shape": list(shape), "chunk": chunk, "decay": decay,
           "dtype": dtype_name(dtype),
           "y_scale": float(want_y.float().abs().max()),
           "max_abs_err": close_to_scale(y, want_y, SCAN_Y_TOL[dtype]),
           "state_max_abs_err": close_to_scale(st, want_st, SSD_STATE_TOL),
           "oracle_max_abs_err": close_to_scale(
               y, ssd_ref(*(t.float() for t in (xh, dt, a_log, Bm, Cm)),
                          torch.zeros_like(a_log)), SCAN_Y_TOL[dtype])}
    if timed:
        lib, code = _build.load(), DTYPE_CODES[dtype]
        # bytes: xh, dt, Bm, Cm read and y written once, a_log, the state
        nbytes = ((2 * B * S * H * P + B * S * H + 2 * B * S * N)
                  * dtype.itemsize + H * 4 + B * H * P * N * 4)
        row.update(scan_timing(
            lambda: ssd_scan(xh, dt, a_log, Bm, Cm, chunk=chunk),
            lambda: ssd_scan_plain(xh, dt, a_log, Bm, Cm, chunk=chunk),
            nbytes, ssd_work(B, S, H, P, N), ssd_ops(B, S, H, P, N, chunk),
            B * H, lib.ssd_smem_bytes(P, N, code),
            lib.ssd_ctas_per_sm(P, N, code)))
        row["plain_device_kernels"] = device_kernels(
            lambda: ssd_scan_plain(xh, dt, a_log, Bm, Cm, chunk=chunk))
        print(f"  B4 {brief(row)}")
    else:
        print(f"  B4 {row}")
    return row


# ------------------------------------------------------------ phases 4-9
def kernel_fns() -> dict:
    """The kernel wrappers by name; each counts its launches."""
    from repro_torch.kernels import (goma_combine, goma_fused_matmul,
                                     goma_matmul, ssd_scan, wkv6_scan)
    return {fn.__name__: fn for fn in (goma_matmul, goma_fused_matmul,
                                       goma_combine, wkv6_scan, ssd_scan)}


def checked_key(name: str, row: dict) -> tuple:
    """A phase-3 row's kernel, shape (with the chunk of a scan) and
    dtype, as recording_shapes names a launch."""
    return (name, tuple(row["shape"]) + ((row["chunk"],) if "chunk" in row
                                         else ()), row["dtype"])


@contextlib.contextmanager
def recording_shapes(seen: dict):
    """Count in ``seen`` every B1, goma_combine, B3 and B4 call made
    through the modules that the model reaches them by, keyed as
    checked_key names the phase-3 rows."""
    from repro_torch.kernels import ops
    from repro_torch.models import rwkv, ssm
    sites = (
        (ops, "goma_matmul", lambda a, b, plan, **kw:
         ((plan.M, plan.N, plan.K), a.dtype)),
        (ops, "goma_combine", lambda g, u, *args, **kw:
         (tuple(g.shape), g.dtype)),
        (rwkv, "wkv6_scan", lambda r, k, v, logw, u, *, chunk:
         (tuple(r.shape) + (chunk,), r.dtype)),
        (ssm, "ssd_scan", lambda xh, dt, a_log, Bm, Cm, *, chunk:
         (tuple(xh.shape) + (Bm.shape[-1], chunk), xh.dtype)))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]

    def recorder(name, fn, key):
        def call(*args, **kw):
            shape, dtype = key(*args, **kw)
            k = (name, shape, dtype_name(dtype))
            seen[k] = seen.get(k, 0) + 1
            return fn(*args, **kw)
        return call

    for (mod, name, key), (_, _, fn) in zip(sites, saved):
        setattr(mod, name, recorder(name, fn, key))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def reset_launches() -> None:
    for fn in kernel_fns().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_fns().items()}


def serve_smoke(arch: str, prompt_len: int, expect: tuple[str, ...],
                **knobs) -> dict:
    """``arch``'s smoke config, fp32, with the config ``knobs`` set: one
    set of weights made on the CPU; greedy tokens on the card (kernels)
    equal those on the CPU (plain versions), and every kernel named in
    ``expect`` launched on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_to
    from repro_torch.serving import Engine, ServeConfig
    cfg = dataclasses.replace(get_config(arch, smoke=True), **knobs)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(SEED), "cpu")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (FULL["batch"], prompt_len)).astype(np.int32)
    scfg = ServeConfig(max_new_tokens=FULL["new_tokens"], cache_len=32)
    cpu_tokens = Engine(model, params, scfg).generate(prompts)
    card = Engine(model, tree_to(params, "cuda"), scfg)
    reset_launches()
    card_tokens = card.generate(prompts)
    launches = launch_counts()
    missing = [k for k in expect if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the {arch} smoke run never launched "
                             f"{missing}: {launches}")
    if not np.array_equal(card_tokens, cpu_tokens):
        raise AssertionError(f"card tokens {card_tokens.tolist()} != CPU "
                             f"tokens {cpu_tokens.tolist()}")
    print(f"  smoke tokens (card == cpu): {card_tokens.tolist()}")
    print(f"  launches: {launches}")
    return launches


def free_device() -> None:
    """Drop the last phase's model and caches, so that the next phase's
    peak memory is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def watch_logits(model) -> list:
    """Record, for every forward pass of ``model``, whether its logits
    are all finite (a device tensor, read after the run)."""
    finite = []
    lm_logits = model._lm_logits

    def checked_logits(p, x):
        out = lm_logits(p, x)
        finite.append(torch.isfinite(out).all())
        return out

    model._lm_logits = checked_logits
    return finite


def prefill_paths(cfg, params, toks) -> dict:
    """The first prefill's logits, kernel path against plain path: held
    within PATH_TOL in fp32 on the served weights; measured in the
    served bf16."""
    from repro_torch.models import build_model

    def tree_float(tree):
        return {k: tree_float(v) if isinstance(v, dict) else v.float()
                for k, v in tree.items()}

    def logits(c, p):
        with torch.inference_mode():
            return build_model(c).prefill(p, {"tokens": toks},
                                          max_len=toks.shape[1])[0]

    plain_cfg = dataclasses.replace(cfg, use_pallas_scan=False,
                                    fused_mlp=False)
    f32 = dict(compute_dtype="float32")
    params32 = tree_float(params)
    want = logits(dataclasses.replace(plain_cfg, **f32), params32)
    err32 = close_to_scale(logits(dataclasses.replace(cfg, **f32),
                                  params32), want, PATH_TOL)
    del params32, want
    free_device()
    want = logits(plain_cfg, params)
    scale = float(want.float().abs().max())
    got = logits(cfg, params)
    return {"fp32_max_abs_err": err32,
            "bf16_max_abs_err": float((got - want).float().abs().max()),
            "bf16_scale": scale,
            "bf16_argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                       .float().mean())}


def expected_launches(cfg, passes: int) -> dict:
    """Every kernel's launches in one full-width generate of ``passes``
    forward passes.  Unfused MLPs (llama3-8b's layers, zamba2-2.7b's
    shared block; the chains do not fuse at these widths) take three B1
    launches and one goma_combine a pass; the scans run once per layer,
    in the prefill only (decode is the recurrent step)."""
    mlps = {"dense": cfg.layers, "rwkv": 0,
            "hybrid": cfg.layers // max(cfg.attn_every, 1)}[cfg.family]
    mlps = mlps if cfg.fused_mlp else 0
    scans = cfg.layers if cfg.use_pallas_scan else 0
    return {"goma_matmul": 3 * mlps * passes, "goma_fused_matmul": 0,
            "goma_combine": mlps * passes,
            "wkv6_scan": scans if cfg.family == "rwkv" else 0,
            "ssd_scan": scans if cfg.family == "hybrid" else 0}


def serve_full(arch: str, prompt_len: int, smi: str,
               out: pathlib.Path | None, profile_name: str, checked: set,
               *, check_paths: bool, **knobs) -> dict:
    """``arch`` at its published widths, bf16, random weights made on the
    card, with the config ``knobs`` set.  With ``check_paths`` the first
    prefill's logits are held against the plain path's on the card
    (prefill_paths).  Then one generate with exact launch counts
    (expected_launches), every kernel launched at a shape and dtype in
    ``checked`` (the phase-3 rows, by checked_key), and finite logits;
    and a second, timed.  With ``out``, one more generate runs under the
    profiler."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, ServeConfig
    cfg = dataclasses.replace(get_config(arch), **knobs)
    model = build_model(cfg)
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    B, S, new = FULL["batch"], prompt_len, FULL["new_tokens"]
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    paths = None
    if check_paths:
        paths = prefill_paths(
            cfg, params, torch.as_tensor(prompts, dtype=torch.int64,
                                         device="cuda"))
        print(f"  first prefill, kernel path vs plain path: {paths} "
              f"(fp32 tol {PATH_TOL} x scale)")
        free_device()

    finite = watch_logits(model)
    eng = Engine(model, params, ServeConfig(max_new_tokens=new,
                                            cache_len=S + new + 8))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    seen = {}
    with recording_shapes(seen):
        tokens = eng.generate(prompts)
    counts = launch_counts()
    passes = len(finite)
    if tokens.shape != (B, new) or not ((tokens >= 0)
                                        & (tokens < cfg.vocab)).all():
        raise AssertionError(f"bad tokens {tokens.tolist()}")
    if not all(bool(f) for f in finite):
        raise AssertionError(f"non-finite logits in {arch} at full width")
    want = expected_launches(cfg, passes)
    if counts != want:
        raise AssertionError(f"{arch} launches {counts} != {want} "
                             f"({passes} forward passes)")
    by_shape = {name: sum(n for k, n in seen.items() if k[0] == name)
                for name in counts}
    if by_shape != counts:
        raise AssertionError(f"{arch}: calls by shape {by_shape} != "
                             f"launches {counts}")
    unchecked = sorted(k for k in seen if k not in checked)
    if unchecked:
        raise AssertionError(f"{arch} launched kernels at shapes that "
                             f"phase 3 did not hold against their plain "
                             f"versions: {unchecked}")
    # a second run, timed, once every plan is cached
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = eng.generate(prompts)
    dt = time.perf_counter() - t0
    if not np.array_equal(again, tokens):
        raise AssertionError("a second greedy run gave other tokens")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  tokens: {tokens.tolist()}")
    print(f"  forward passes {passes}, launches {counts}")
    print(f"  launches by shape (each held in phase 3): {seen}")
    print(f"  generate: {B * new / dt} tokens/s "
          f"({dt} s for {B}x{new} tokens), peak memory {peak} GiB")
    if out is not None:
        profile_generate(eng, prompts, smi, out, profile_name)
    serve = {"tokens_per_s": B * new / dt, "seconds": dt,
             "forward_passes": passes, "peak_memory_gib": peak}
    if paths is not None:
        serve["prefill_vs_plain_path"] = paths
    shapes = {name: [{"shape": list(k[1]), "dtype": k[2], "launches": n}
                     for k, n in sorted(seen.items()) if k[0] == name]
              for name in counts}
    return {"launches": counts, "shapes": shapes, "serve": serve}


# device-kernel name fragments of the port's hand-written kernels
PORT_KERNELS = {"goma": "goma_", "b1": "goma_matmul", "wkv6": "wkv6_kernel",
                "ssd": "ssd_scan_kernel", "ssd_cb": "ssd_cb_kernel"}


def profile_generate(eng, prompts, smi: str, out: pathlib.Path,
                     name: str) -> None:
    """One more generate under torch.profiler: device time by kernel,
    the device's busy and idle shares of the wall time, and the port
    kernels' shares, to out/<name>.{json,txt}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: the aten ops that launched them carry the
    # same time again
    rows = sorted(({"name": e.key, "calls": e.count,
                    "device_ms": e.self_device_time_total / 1e3}
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    port = {k: sum(r["device_ms"] for r in rows if frag in r["name"])
            for k, frag in PORT_KERNELS.items()}
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    summary = {"device": smi, "wall_ms": wall_ms, "device_busy_ms": busy,
               "device_kernel_launches": sum(r["calls"] for r in rows),
               "device_busy_share": busy / wall_ms,
               "device_idle_share": 1 - busy / wall_ms,
               "port_kernels_ms": port,
               "port_kernels_share_of_busy": {k: v / busy
                                              for k, v in port.items()},
               "top": rows[:20]}
    (out / f"{name}.json").write_text(json.dumps(summary, indent=1))
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=25)
    (out / f"{name}.txt").write_text(f"{smi}\n{table}\n")
    print(f"  profiled generate: wall {wall_ms} ms, device busy {busy} ms "
          f"(share {busy / wall_ms}), port kernels {port} ms")
    for r in rows[:8]:
        print(f"    {r['device_ms']:10.3f} ms {r['calls']:6d}  "
              f"{r['name'][:80]}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json (per-shape rows)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on "
                 "the card")
    out = pathlib.Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    from repro_torch.kernels import _build
    t_start = time.perf_counter()

    with phase("1 device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"  {smi}")
        print(f"  torch {torch.__version__} cuda {torch.version.cuda}, "
              f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")

    with phase("2 build kernels"):
        report = _build.build()
        print(f"  nvcc: {report.seconds:.2f} s for "
              f"{len(report.ptxas)} sources, in parallel")
        for src, log in report.ptxas.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {src}: {line.strip()}")
        _build.load()
        # the bf16 GEMM kernels and the scans run on the tensor cores:
        # their SASS has HGMMA, or TF32 HMMA
        mma = mma_counts(report.path)
        print(f"  tensor-core instructions per kernel (cuobjdump -sass; "
              f"HGMMA in goma_*, TF32 HMMA in the scans): "
              f"{mma if mma is not None else 'no cuobjdump'}")
        # B1 at three slice widths, B2; B3 and B4's prologue and scan in
        # two dtypes, B4's at the (N) and (P, N) it is built for
        families = {"goma_matmul_wgmma": 3, "goma_fused_wgmma": 1,
                    "wkv6_kernel": 2, "ssd_cb_kernel": 4,
                    "ssd_scan_kernel": 8}
        if mma is not None and (
                {f: sum(k.startswith(f + "<") or k == f for k in mma)
                 for f in families} != families
                or not all(mma.values())):
            raise AssertionError(f"a tensor-core kernel without its MMA "
                                 f"instructions: {mma}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b1_rows, b2_rows, combine_rows = [], [], []
    with phase("3 kernels vs plain versions"):
        for dtype in (torch.float32, torch.bfloat16):
            for shape in ODD_SHAPES:
                b1_rows.append(check_b1(shape, dtype, gen, timed=False))
        # every served MLP's gate/up and down products, at decode and in
        # the prefill, under the plans the model takes
        for rows, ff, d in SERVED_MLPS.values():
            for M in rows:
                for N, K in ((ff, d), (d, ff)):
                    b1_rows.append(check_b1((M, N, K), torch.bfloat16, gen,
                                            timed=True))
        # hand-made plans: nk == 1, nk > 1, and nm > 1 with nk > 1 (the
        # reference's grid-path plans, with FF = 128 so that the fp32
        # strips of bm = 128 fit a CTA)
        from repro_torch.core.hopper_mapping import FusedTilePlan
        for dtype in (torch.float32, torch.bfloat16):
            for bm, bk in ((128, 128), (128, 64), (64, 32)):
                plan = FusedTilePlan(
                    M=128, FF=128, K=128, N2=128,
                    padded=(128, 128, 128, 128), fused=True, bm=bm, bk=bk,
                    objective=0.0, unfused_objective=0.0, solve_time_s=0.0)
                b2_rows.append(check_b2(128, 128, 128, dtype, gen,
                                        plan=plan, timed=False))
        for M in (4, 64):   # the smoke chain at decode and prefill
            b2_rows.append(check_b2(M, 128, 64, torch.float32, gen,
                                    timed=True))
        # the composition's combine: an odd fp32 shape, and every served
        # MLP's strip at decode and in the prefill
        combine_rows.append(check_combine((129, 257), torch.float32, gen,
                                          timed=False))
        for rows, ff, _ in SERVED_MLPS.values():
            for M in rows:
                combine_rows.append(check_combine((M, ff), torch.bfloat16,
                                                  gen, timed=True))
        tiling = check_tiling_independence(gen)
        for r in b1_rows + b2_rows + combine_rows + tiling:
            print("  " + json.dumps(r))
        # the scans: an odd small shape (a chunk of 8, the last 32-token
        # sub-chunk padded), the full-width prefill shapes at chunk 128,
        # timed, and there at the mild and strong decays too
        wkv_rows = [check_wkv6((2, 40, 3, 64), 8, dtype, gen, timed=False)
                    for dtype in (torch.float32, torch.bfloat16)]
        ssd_rows = [check_ssd((2, 40, 3, 64, 16), 8, torch.float32, gen,
                              timed=False)]
        wkv_full = check_wkv6(FULL_WKV, 128, torch.float32, gen)
        ssd_full = check_ssd(FULL_SSD, 128, torch.float32, gen)
        wkv_rows += [wkv_full] + [
            check_wkv6(FULL_WKV, 128, torch.float32, gen, decay=d,
                       timed=False) for d in ("mild", "strong")]
        ssd_rows += [ssd_full] + [
            check_ssd(FULL_SSD, 128, torch.float32, gen, decay=d,
                      timed=False) for d in ("mild", "strong")]
    checked = ({checked_key("goma_matmul", r) for r in b1_rows}
               | {checked_key("goma_combine", r) for r in combine_rows}
               | {checked_key("wkv6_scan", r) for r in wkv_rows}
               | {checked_key("ssd_scan", r) for r in ssd_rows})

    # every path runs with the launch counts set to 0 just before it; at
    # full width each records the shapes it launched every kernel at
    runs, shapes = {}, {}
    with phase("4 serve llama3-8b smoke on the card (B2)"):
        runs["serve llama3-8b smoke"] = serve_smoke(
            "llama3-8b", FULL["prompt_len"], ("goma_fused_matmul",),
            fused_mlp=True)
    with phase("5 serve llama3-8b at full width (B1)"):
        full = serve_full(FULL["arch"], FULL["prompt_len"], smi, out,
                          "profile_serve", checked, check_paths=False,
                          fused_mlp=True)
        runs["serve llama3-8b full width"] = full["launches"]
        shapes["serve llama3-8b full width"] = full["shapes"]
    free_device()
    with phase("6 serve rwkv6-7b smoke on the card (B3)"):
        runs["serve rwkv6-7b smoke"] = serve_smoke(
            "rwkv6-7b", RECURRENT["smoke_prompt_len"], ("wkv6_scan",),
            use_pallas_scan=True)
    with phase("7 serve zamba2-2.7b smoke on the card (B4, B2)"):
        runs["serve zamba2-2.7b smoke"] = serve_smoke(
            "zamba2-2.7b", RECURRENT["smoke_prompt_len"],
            ("ssd_scan", "goma_fused_matmul"), use_pallas_scan=True,
            fused_mlp=True)
    with phase("8 serve rwkv6-7b at full width (B3)"):
        rwkv = serve_full("rwkv6-7b", RECURRENT["prompt_len"], smi, out,
                          "profile_serve_rwkv", checked, check_paths=True,
                          use_pallas_scan=True)
        runs["serve rwkv6-7b full width"] = rwkv["launches"]
        shapes["serve rwkv6-7b full width"] = rwkv["shapes"]
    free_device()
    with phase("9 serve zamba2-2.7b at full width (B4, B1)"):
        zamba = serve_full("zamba2-2.7b", RECURRENT["prompt_len"], smi, out,
                           "profile_serve_zamba2", checked, check_paths=True,
                           use_pallas_scan=True, fused_mlp=True)
        runs["serve zamba2-2.7b full width"] = zamba["launches"]
        shapes["serve zamba2-2.7b full width"] = zamba["shapes"]
    free_device()

    b1 = next(r for r in b1_rows if r["shape"] == [4, 14336, 4096])
    b2 = next(r for r in b2_rows if r["shape"] == [4, 128, 64])
    comb = next(r for r in combine_rows if r["shape"] == [4, 14336])
    kernels = []
    for name, fn, row, path, src, replaces in (
            ("goma_matmul (B1)", "goma_matmul", b1,
             "serve llama3-8b full width", "goma_gemm.cu",
             "src/repro/kernels/goma_gemm.py:97"),
            ("goma_fused_matmul (B2)", "goma_fused_matmul", b2,
             "serve llama3-8b smoke", "goma_fused.cu",
             "src/repro/kernels/goma_fused.py:131"),
            ("goma_combine (B2's combine, between B1 links)",
             "goma_combine", comb, "serve llama3-8b full width",
             "goma_fused.cu", "src/repro/kernels/goma_fused.py:66"),
            ("wkv6_scan (B3)", "wkv6_scan", wkv_full,
             "serve rwkv6-7b full width", "wkv6.cu",
             "src/repro/kernels/wkv6.py:78"),
            ("ssd_scan (B4)", "ssd_scan", ssd_full,
             "serve zamba2-2.7b full width", "mamba2_ssd.cu",
             "src/repro/kernels/mamba2_ssd.py:76")):
        extra = {k: row[k] for k in (
            ("slice_n", "ctas", "stages", "device_ms", "library_device_ms",
             "bound_share", "vs_library", "device_bound_share",
             "device_vs_library") if fn == "goma_matmul" else
            ("ctas", "smem_bytes", "ctas_per_sm", "device_ms",
             "cuda_core_bound_ms", "bound_share", "device_bound_share")
            if fn in ("wkv6_scan", "ssd_scan") else ())}
        kernels.append({
            **extra,
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": runs[path][fn],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "dtype": row["dtype"], "path": path,
            "launches_by_path": {k: v[fn] for k, v in runs.items()
                                 if v[fn]},
            "shapes_by_path": {k: v[fn] for k, v in shapes.items()
                               if v[fn]}})
    if out is not None:
        (out / "chip_smoke.json").write_text(json.dumps(
            {"device": smi, "mma": mma, "b1": b1_rows,
             "b1_tiling_independence": tiling, "b2": b2_rows,
             "combine": combine_rows, "wkv6": wkv_rows, "ssd": ssd_rows,
             "serve_full": full["serve"], "serve_rwkv": rwkv["serve"],
             "serve_zamba2": zamba["serve"], "launches": runs,
             "shapes": shapes,
             "kernels": kernels,
             "seconds": time.perf_counter() - t_start}, indent=1))
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
