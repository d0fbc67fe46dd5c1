"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card every test here skips.  Imports nothing of
JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.hopper_mapping import (FusedTilePlan, TpuTilePlan,
                                             plan_gemm_tiling)
from repro_torch.kernels import ops
from repro_torch.kernels.goma_fused import goma_combine
from repro_torch.kernels.goma_gemm import (SLICE_WIDTHS, goma_matmul,
                                           goma_matmul_plain)
from repro_torch.kernels.mamba2_ssd import ssd_scan, ssd_scan_plain
from repro_torch.kernels.wkv6 import wkv6_scan, wkv6_scan_plain

MATRIX_SHAPES = [(128, 128, 128), (300, 200, 100), (129, 257, 65),
                 (100, 50, 1), (256, 384, 512)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
GEMM_TOL = {"f32": 1e-5, "bf16": 2e-2}
MLP_TOL = {"f32": 1e-5, "bf16": 3e-2}


def _inputs(seed, shapes, dtype, scales=None):
    """Normals from a numpy seed, each matrix times its scale: weights
    get 1/sqrt(fan-in), so products come out near unit size and the bf16
    tolerance rejects a wrong kernel."""
    rng = np.random.default_rng(seed)
    scales = scales or [1.0] * len(shapes)
    return [torch.from_numpy((rng.standard_normal(s) * c).astype(
        np.float32)).to(DTYPES[dtype]) for s, c in zip(shapes, scales)]


def _f32(t):
    return t.to(torch.float32).cpu().numpy()


def _manual_fused_plan(M, FF, K, bm, bk):
    return FusedTilePlan(M=M, FF=FF, K=K, N2=K, padded=(M, FF, K, K),
                         fused=True, bm=bm, bk=bk, objective=0.0,
                         unfused_objective=0.0, solve_time_s=0.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MATRIX_SHAPES,
                         ids=[f"{m}x{n}x{k}" for m, n, k in MATRIX_SHAPES])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_gemm_matches_plain(cuda_device, shape, dtype):
    M, N, K = shape
    ta, tb = _inputs(7, [(M, K), (K, N)], dtype, [1.0, K ** -0.5])
    before = goma_matmul.launches
    got = ops.gemm(ta.to(cuda_device), tb.to(cuda_device))
    torch.cuda.synchronize()
    assert goma_matmul.launches == before + 1
    want = ops.gemm(ta, tb)
    tol = GEMM_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bm,bk", [(128, 128), (128, 64), (64, 32)])
def test_cuda_fused_equals_composition_bitwise(cuda_device, dtype, bm, bk):
    # FF = 128: the fp32 strips of bm = 128 must fit one CTA's 227 KB
    M, FF, K = 128, 128, 128
    plan = _manual_fused_plan(M, FF, K, bm, bk)
    ts = _inputs(8, [(M, K), (K, FF), (K, FF), (FF, K)], dtype,
                 [1.0, K ** -0.5, K ** -0.5, FF ** -0.5])
    ta, tg, tu, td = (t.to(cuda_device) for t in ts)
    out = ops.fused_mlp(ta, tg, tu, td, plan=plan)
    comp = ops.fused_mlp_composition(ta, tg, tu, td, plan)
    torch.cuda.synchronize()
    assert torch.equal(out, comp)
    want = ops.fused_mlp(*ts, plan=plan)
    tol = MLP_TOL[dtype]
    np.testing.assert_allclose(_f32(out), _f32(want), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_unfused_fallback_combines_on_the_card(cuda_device, dtype):
    """A chain that does not fuse runs three B1 launches with one
    goma_combine between them, and matches its plain version."""
    M, FF, K = 4, 14336, 64  # (bm, 14336) fp32 strips exceed a CTA
    ts = _inputs(9, [(M, K), (K, FF), (K, FF), (FF, K)], dtype,
                 [1.0, K ** -0.5, K ** -0.5, FF ** -0.5])
    ta, tg, tu, td = (t.to(cuda_device) for t in ts)
    before = (goma_matmul.launches, goma_combine.launches)
    got = ops.fused_mlp(ta, tg, tu, td)
    torch.cuda.synchronize()
    assert (goma_matmul.launches, goma_combine.launches) == (
        before[0] + 3, before[1] + 1)
    want = ops.fused_mlp(*ts)
    tol = MLP_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


# the bf16 MLP products the full-width paths serve (llama3-8b and
# zamba2-2.7b, gate/up and down, at decode and in the prefill)
SERVED_GEMMS = [(4, 14336, 4096), (4, 4096, 14336), (64, 14336, 4096),
                (64, 4096, 14336), (4, 10240, 2560), (4, 2560, 10240),
                (800, 10240, 2560), (800, 2560, 10240)]


def _padded_operands(plan, seed, dtype=torch.bfloat16):
    """Padded operands on the card, made there from a seed (the served
    weights are too large to draw with numpy quickly); A's padding rows
    and both operands' k padding are zero, as every caller pads."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    M, N, K = plan.M, plan.N, plan.K
    pm, pn, pk = plan.padded
    a = torch.zeros((pm, pk), dtype=dtype, device="cuda")
    a[:M, :K] = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    b = torch.zeros((pk, pn), dtype=dtype, device="cuda")
    b[:K, :N] = (torch.randn((K, N), generator=gen, device="cuda")
                 * K ** -0.5).to(dtype)
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SERVED_GEMMS,
                         ids=[f"{m}x{n}x{k}" for m, n, k in SERVED_GEMMS])
def test_cuda_b1_bf16_matches_plain_at_served_shapes(cuda_device, shape):
    plan = plan_gemm_tiling(*shape, dtype_bytes=2)
    a, b = _padded_operands(plan, 16)
    before = goma_matmul.launches
    got = goma_matmul(a, b, plan)
    torch.cuda.synchronize()
    assert goma_matmul.launches == before + 1
    tol = GEMM_TOL["bf16"]
    np.testing.assert_allclose(_f32(got), _f32(goma_matmul_plain(a, b, plan)),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_b1_bits_do_not_depend_on_the_decomposition(cuda_device):
    """bf16 B1 at every slice width of a served decode plan, and of a 128
    x 128 x 128 problem under plans with bk 32, 64 and 128 and different
    (bm, bn): bitwise equal outputs."""
    hand = [TpuTilePlan(M=128, N=128, K=128, padded=(128, 128, 128),
                        block=blk, grid_order=("m", "n", "k"), walk="z",
                        objective=0.0, solve_time_s=0.0)
            for blk in ((128, 128, 32), (64, 128, 64), (128, 64, 128))]
    for plans in ([plan_gemm_tiling(4, 14336, 4096, dtype_bytes=2)],
                  [plan_gemm_tiling(128, 128, 128, dtype_bytes=2)] + hand):
        a, b = _padded_operands(plans[0], 17)
        outs = [goma_matmul(a, b, p, slice_n=w) for p in plans
                for w in SLICE_WIDTHS if p.block[1] % w == 0]
        torch.cuda.synchronize()
        assert len(outs) >= 3
        assert all(torch.equal(o, outs[0]) for o in outs)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(100, 50, 1), (64, 64, 40),
                                   (129, 257, 65)],
                         ids=["pk1", "pk40", "pk65-128"])
def test_cuda_b1_bf16_k_tail(cuda_device, shape):
    """A k extent that is not a multiple of the 64-deep ring stage: padded
    to a multiple of 8 by the wrapper (pk = 1), zero-filled past pk by the
    TMA (pk = 1 and 40), or already zero in memory (65 pads to 128); at
    every slice width."""
    plan = plan_gemm_tiling(*shape, dtype_bytes=2)
    a, b = _padded_operands(plan, 18)
    want = goma_matmul_plain(a, b, plan)
    tol = GEMM_TOL["bf16"]
    for w in (w for w in SLICE_WIDTHS if plan.block[1] % w == 0):
        got = goma_matmul(a, b, plan, slice_n=w)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


# (B, S, H, P, chunk): an odd small shape (its last 32-token sub-chunk
# padded), a shape of whole sub-chunks, and one chunk of 128
WKV_SHAPES = [(2, 40, 3, 64, 8), (2, 128, 2, 64, 32), (1, 256, 2, 64, 128)]
# (B, S, H, P, N, chunk)
SSD_SHAPES = [(2, 40, 3, 64, 16, 8), (2, 128, 2, 16, 16, 32),
              (1, 256, 2, 64, 64, 128)]
# the reference's scan tolerances (tests/test_kernels.py), relative to the
# plain version's largest magnitude: y 1e-4 (bf16 5e-2), state 2e-3 (B3)
# and 1e-3 (B4)
SCAN_Y_TOL = {"f32": 1e-4, "bf16": 5e-2}


def _close_to_scale(got, want, tol):
    want = _f32(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(_f32(got) - want).max())
    assert err <= tol * scale, (err, tol, scale)


# log-decays per step: B3's logw and B4's a_log.  "typical" is how the
# reference's kernel tests draw them; "mild" is B3 at the model's decay
# bias -6 and B4 at a_log -4 (about -1 to -2 a chunk of 128, so the state
# carried from one chunk into the next is visible); "strong" takes B3's
# logw down to -5 a step and B4's a_log to 1.5, where the factored
# partial products underflow.
def wkv_logw(rng, shape, decay="typical"):
    return {"mild": lambda: -np.exp(rng.standard_normal(shape) * 0.5 - 6.0),
            "typical": lambda: -np.exp(rng.standard_normal(shape) - 2.0),
            "strong": lambda: -rng.uniform(0.0, 5.0, shape)}[decay]()


def ssd_a_log(rng, H, decay="typical"):
    return rng.standard_normal(H) * 0.2 + {"mild": -4.0, "typical": 0.0,
                                           "strong": 1.5}[decay]


def wkv_inputs(seed, B, S, H, P, dtype, decay="typical"):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, P)) * 0.5 for _ in range(3))
    logw = wkv_logw(rng, (B, S, H, P), decay)
    u = rng.standard_normal((H, P)) * 0.3
    return ([torch.from_numpy(a.astype(np.float32)).to(DTYPES[dtype])
             for a in (r, k, v, logw)]
            + [torch.from_numpy(u.astype(np.float32))])


def ssd_inputs(seed, B, S, H, P, N, decay="typical"):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    a_log = ssd_a_log(rng, H, decay)
    Bm, Cm = (rng.standard_normal((B, S, N)) * 0.5 for _ in range(2))
    return [torch.from_numpy(a.astype(np.float32))
            for a in (xh, dt, a_log, Bm, Cm)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WKV_SHAPES,
                         ids=["x".join(map(str, s)) for s in WKV_SHAPES])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_wkv6_matches_plain(cuda_device, shape, dtype):
    *dims, chunk = shape
    ts = wkv_inputs(10, *dims, dtype)
    before = wkv6_scan.launches
    y, st = wkv6_scan(*(t.to(cuda_device) for t in ts), chunk=chunk)
    torch.cuda.synchronize()
    assert wkv6_scan.launches == before + 1
    assert y.dtype == ts[0].dtype and st.dtype == torch.float32
    want_y, want_st = wkv6_scan_plain(*ts, chunk=chunk)
    _close_to_scale(y, want_y, SCAN_Y_TOL[dtype])
    _close_to_scale(st, want_st, 2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_SHAPES,
                         ids=["x".join(map(str, s)) for s in SSD_SHAPES])
def test_cuda_ssd_matches_plain(cuda_device, shape):
    *dims, chunk = shape
    ts = ssd_inputs(11, *dims)
    before = ssd_scan.launches
    y, st = ssd_scan(*(t.to(cuda_device) for t in ts), chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    want_y, want_st = ssd_scan_plain(*ts, chunk=chunk)
    _close_to_scale(y, want_y, SCAN_Y_TOL["f32"])
    _close_to_scale(st, want_st, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("decay", ["mild", "typical", "strong"])
def test_cuda_scans_hold_at_every_decay(cuda_device, decay):
    """Both scans at two chunks of 128 against their plain versions and
    the sequential oracles (B4's without the D term)."""
    from repro_torch.kernels.ref import ssd_ref, wkv6_ref
    ts = wkv_inputs(14, 2, 256, 2, 64, "f32", decay)
    y, st = wkv6_scan(*(t.to(cuda_device) for t in ts), chunk=128)
    want_y, want_st = wkv6_scan_plain(*ts, chunk=128)
    _close_to_scale(y, want_y, SCAN_Y_TOL["f32"])
    _close_to_scale(st, want_st, 2e-3)
    _close_to_scale(y, wkv6_ref(*ts), SCAN_Y_TOL["f32"])
    ts = ssd_inputs(15, 2, 256, 2, 64, 64, decay)
    y, st = ssd_scan(*(t.to(cuda_device) for t in ts), chunk=128)
    want_y, want_st = ssd_scan_plain(*ts, chunk=128)
    _close_to_scale(y, want_y, SCAN_Y_TOL["f32"])
    _close_to_scale(st, want_st, 1e-3)
    _close_to_scale(y, ssd_ref(*ts, torch.zeros(2)), SCAN_Y_TOL["f32"])


@pytest.mark.cuda
def test_cuda_scans_refuse_what_they_cannot_take(cuda_device):
    """A CUDA tensor launches the kernel or raises; nothing falls back."""
    r, k, v, logw, u = (t.to(cuda_device)
                        for t in wkv_inputs(12, 1, 256, 1, 128, "f32"))
    with pytest.raises(ValueError):
        wkv6_scan(r, k, v, logw, u, chunk=256)  # P 128: not RWKV-6's 64
    r, k, v, logw, u = (t.to(cuda_device)
                        for t in wkv_inputs(12, 1, 256, 1, 64, "f32"))
    with pytest.raises(ValueError):
        wkv6_scan(r, k, v, logw.cpu(), u, chunk=8)  # mixed devices
    xh, dt, a_log, Bm, Cm = (t.to(cuda_device)
                             for t in ssd_inputs(13, 1, 16, 1, 6, 16))
    with pytest.raises(ValueError):
        ssd_scan(xh, dt, a_log, Bm, Cm, chunk=8)    # P 6: not 16 or 64
