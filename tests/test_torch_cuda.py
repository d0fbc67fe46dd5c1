"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card every test here skips.  Imports nothing of
JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.hopper_mapping import FusedTilePlan
from repro_torch.kernels import ops
from repro_torch.kernels.goma_fused import goma_combine
from repro_torch.kernels.goma_gemm import goma_matmul

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
