"""The port's kernel wrappers (repro_torch.kernels) against the
reference's Pallas kernels run in interpret mode, on the same inputs made
from a numpy seed.  On the CPU the wrappers run the kernels' plain
versions; the CUDA kernels themselves are held against those plain
versions by the tests marked ``cuda`` (skipped without a card) and by
chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.hopper_mapping import FusedTilePlan, TpuTilePlan
from repro_torch.kernels import ops
from repro_torch.kernels.goma_fused import (ACTIVATIONS, goma_combine,
                                            goma_fused_matmul)
from repro_torch.kernels.goma_gemm import goma_matmul
from repro_torch.kernels.ref import matmul_ref
from repro_torch.obs.registry import get_registry

# tests/test_kernels.py's MATRIX_SHAPES
MATRIX_SHAPES = [(128, 128, 128), (300, 200, 100), (129, 257, 65),
                 (100, 50, 1), (256, 384, 512)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
GEMM_TOL = {"f32": 1e-5, "bf16": 2e-2}
MLP_TOL = {"f32": 1e-5, "bf16": 3e-2}


def _inputs(seed, shapes, dtype):
    """The same values for both packages: fp32 normals from numpy, rounded
    once to the dtype (both frameworks round to nearest even)."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    xs = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in shapes]
    return ([jnp.asarray(x).astype(jdt) for x in xs],
            [torch.from_numpy(x).to(tdt) for x in xs])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", MATRIX_SHAPES,
                         ids=[f"{m}x{n}x{k}" for m, n, k in MATRIX_SHAPES])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gemm_matches_jax(shape, dtype):
    M, N, K = shape
    (ja, jb), (ta, tb) = _inputs(0, [(M, K), (K, N)], dtype)
    want = jops.gemm(ja, jb, interpret=True)
    got = ops.gemm(ta, tb)
    assert got.shape == (M, N) and got.dtype == ta.dtype
    tol = GEMM_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("activation", sorted(ACTIVATIONS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_mlp_matches_jax(activation, dtype):
    M, FF, K = 128, 128, 128
    (ja, jg, ju, jd), (ta, tg, tu, td) = _inputs(
        1, [(M, K), (K, FF), (K, FF), (FF, K)], dtype)
    want = jops.fused_mlp(ja, jg, ju, jd, activation=activation,
                          interpret=True)
    got = ops.fused_mlp(ta, tg, tu, td, activation=activation)
    tol = MLP_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", MATRIX_SHAPES[:3],
                         ids=[f"{m}x{n}x{k}" for m, n, k in MATRIX_SHAPES[:3]])
def test_fused_mlp_matrix_matches_jax(shape):
    """Odd shapes (padding on every axis) through the port's fused path
    or its unfused fallback, against the reference's fused kernel."""
    M, FF, K = shape
    (ja, jg, ju, jd), (ta, tg, tu, td) = _inputs(
        2, [(M, K), (K, FF), (K, FF), (FF, K)], "f32")
    want = jops.fused_mlp(ja, jg, ju, jd, interpret=True)
    got = ops.fused_mlp(ta, tg, tu, td)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


def _manual_fused_plan(M, FF, K, bm, bk):
    return FusedTilePlan(M=M, FF=FF, K=K, N2=K, padded=(M, FF, K, K),
                         fused=True, bm=bm, bk=bk, objective=0.0,
                         unfused_objective=0.0, solve_time_s=0.0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bm,bk,label", [
    (128, 128, "single_k"),        # nk == 1
    (128, 64, "multi_k"),          # strips accumulate over k stages
    (64, 32, "multi_m_multi_k"),   # both grid dims > 1
])
def test_fused_equals_composition_bitwise(dtype, bm, bk, label):
    """On the port's plain versions, the fused op equals the B1
    composition under the plan's producer/consumer tilings bit for bit,
    and the reference's force_xla product within tolerance."""
    M, FF, K = 128, 256, 128
    plan = _manual_fused_plan(M, FF, K, bm, bk)
    nm, nk = plan.grid
    assert (nk == 1) == (label == "single_k")
    (ja, jg, ju, jd), (ta, tg, tu, td) = _inputs(
        3, [(M, K), (K, FF), (K, FF), (FF, K)], dtype)
    out = ops.fused_mlp(ta, tg, tu, td, plan=plan)
    comp = ops.fused_mlp_composition(ta, tg, tu, td, plan)
    assert torch.equal(out, comp), label
    want = jops.fused_mlp(ja, jg, ju, jd, force_xla=True)
    tol = MLP_TOL[dtype]
    np.testing.assert_allclose(_f32(out), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("bk,expect_single", [(128, True), (64, False)])
def test_goma_matmul_stage_paths(bk, expect_single):
    """B1's plain version over one k stage and over several computes the
    reference's product."""
    M = N = K = 128
    plan = TpuTilePlan(M=M, N=N, K=K, padded=(M, N, K),
                       block=(128, 128, bk), grid_order=("m", "n", "k"),
                       walk="z", objective=0.0, solve_time_s=0.0)
    assert (K // bk == 1) == expect_single
    (ja, jb), (ta, tb) = _inputs(4, [(M, K), (K, N)], "f32")
    out = goma_matmul(ta, tb, plan)
    np.testing.assert_allclose(_f32(out), _f32(jnp.dot(ja, jb)),
                               rtol=1e-5, atol=1e-5)


def test_matmul_ref_matches_jax():
    (ja, jb), (ta, tb) = _inputs(5, [(33, 17), (17, 9)], "bf16")
    from repro.kernels.ref import matmul_ref as jref
    np.testing.assert_allclose(_f32(matmul_ref(ta, tb)), _f32(jref(ja, jb)),
                               rtol=2e-2, atol=2e-2)


def test_dispatch_counters_and_plain_path():
    """The wrappers count their dispatches as the reference does, and the
    plain path launches no kernel (CPU tensors)."""
    reg = get_registry()
    reg.reset("kernel.")
    before = (goma_matmul.launches, goma_fused_matmul.launches,
              goma_combine.launches)
    (_, _, _, _), (ta, tg, tu, td) = _inputs(
        6, [(4, 64), (64, 128), (64, 128), (128, 64)], "f32")
    ops.fused_mlp(ta, tg, tu, td)
    ops.gemm(ta, tg)
    assert reg.get("kernel.fused_mlp.dispatch") == 1
    assert reg.get("kernel.gemm.dispatch") == 1
    assert (goma_matmul.launches, goma_fused_matmul.launches,
            goma_combine.launches) == before


def test_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on a CUDA card is refused, never
    quietly computed elsewhere."""
    plan = TpuTilePlan(M=64, N=64, K=64, padded=(64, 64, 64),
                       block=(64, 64, 64), grid_order=("m", "n", "k"),
                       walk="z", objective=0.0, solve_time_s=0.0)
    a = torch.empty((64, 64), device="meta")
    with pytest.raises(ValueError):
        goma_matmul(a, a, plan)


def test_unfused_plan_refused_by_fused_kernel():
    plan = FusedTilePlan(M=64, FF=64, K=64, N2=64, padded=(64, 64, 64, 64),
                         fused=False, bm=0, bk=0, objective=0.0,
                         unfused_objective=0.0, solve_time_s=0.0)
    x = torch.zeros((64, 64))
    with pytest.raises(ValueError):
        goma_fused_matmul(x, x, x, x, plan)
