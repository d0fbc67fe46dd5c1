"""The port's plan adapter (repro_torch.core.hopper_mapping) against the
reference's core.tpu_mapping, and its Hopper plans against the port's
own certificate checks and the kernels' shared-memory budget."""
import dataclasses

import pytest

from repro.core import tpu_mapping as ref_tm
from repro_torch.core import certificate, fusion
from repro_torch.core import hopper_mapping as hm
from repro_torch.core.solver import solve

# tests/test_kernels.py's SHAPES and MATRIX_SHAPES
SHAPES = [(128, 128, 128), (256, 512, 128), (300, 200, 100),
          (512, 384, 1024), (1024, 256, 2048), (64, 4096, 512)]
MATRIX_SHAPES = [(128, 128, 128), (300, 200, 100), (129, 257, 65),
                 (100, 50, 1), (256, 384, 512)]
# llama3-8b's MLP GEMMs (d_model 4096, d_ff 14336) at decode (M = 4) and
# prefill (M = 64) token counts
LLAMA_MLP = [(m, n, k) for m in (4, 64)
             for n, k in ((14336, 4096), (4096, 14336))]
GEMMS = sorted(set(SHAPES + MATRIX_SHAPES + LLAMA_MLP))
# llama3-8b smoke chains (M, FF, K, N2): d_model 64, d_ff 128
SMOKE_CHAINS = [(4, 128, 64, 64), (64, 128, 64, 64), (128, 128, 64, 128)]


def _fields(plan):
    """Every field but the solve time; a NaN objective (the compatibility
    tilings carry none) compares equal to NaN."""
    d = dataclasses.asdict(plan)
    d.pop("solve_time_s")
    if d["objective"] != d["objective"]:
        d["objective"] = "nan"
    return d


@pytest.mark.parametrize("dtype_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", GEMMS, ids=[f"{m}x{n}x{k}"
                                              for m, n, k in GEMMS])
def test_tpu_gemm_plans_equal_reference(shape, dtype_bytes):
    port = hm.plan_gemm_tiling(*shape, dtype_bytes=dtype_bytes,
                               spec=hm.TPUV5E_LIKE, pad=hm.MXU)
    ref = ref_tm.plan_gemm_tiling(*shape, dtype_bytes=dtype_bytes)
    assert _fields(port) == _fields(ref)
    assert port.grid == ref.grid


@pytest.mark.parametrize("dtype_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("chain", SMOKE_CHAINS + [(64, 14336, 4096, 4096)],
                         ids=lambda c: "x".join(map(str, c)))
def test_tpu_fused_plans_equal_reference(chain, dtype_bytes):
    port = hm.plan_fused_mlp(*chain, dtype_bytes=dtype_bytes,
                             spec=hm.TPUV5E_LIKE, pad=hm.MXU)
    ref = ref_tm.plan_fused_mlp(*chain, dtype_bytes=dtype_bytes)
    assert _fields(port) == _fields(ref)
    if port.fused:
        assert _fields(port.producer_plan()) == _fields(ref.producer_plan())
        assert _fields(port.consumer_plan()) == _fields(ref.consumer_plan())


@pytest.mark.parametrize("dtype_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", GEMMS, ids=[f"{m}x{n}x{k}"
                                              for m, n, k in GEMMS])
def test_h100_gemm_plans_certified_and_fit(shape, dtype_bytes):
    gemm, hw, padded = hm.gemm_problem(*shape, dtype_bytes=dtype_bytes)
    res = solve(gemm, hw, objective="energy")
    assert certificate.verify(res.certificate, hw)
    plan = hm.plan_gemm_tiling(*shape, dtype_bytes=dtype_bytes)
    assert plan.padded == padded
    bm, bn, bk = plan.block
    pm, pn, pk = padded
    # every block is whole in CTA tiles and divides the padded problem
    assert bm % hm.CTA_TILE == 0 and bn % hm.CTA_TILE == 0
    assert pm % bm == 0 and pn % bn == 0 and pk % bk == 0
    # the operand tiles fit the shared-memory budget
    tile_bytes = (bm * bk + bk * bn + bm * bn) * dtype_bytes
    assert tile_bytes <= hm.SMEM_BYTES * hm.SMEM_BUDGET
    # realizability: z-walk or the whole reduction in one block
    assert plan.walk == "z" or bk == pk


@pytest.mark.parametrize("dtype_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("chain", SMOKE_CHAINS + [(4, 14336, 4096, 4096),
                                                  (64, 14336, 4096, 4096)],
                         ids=lambda c: "x".join(map(str, c)))
def test_h100_fused_plans_certified_and_fit(chain, dtype_bytes):
    gchain, hw, padded = hm.fused_mlp_problem(*chain,
                                              dtype_bytes=dtype_bytes)
    res = fusion.solve_chain(gchain, hw, objective="energy",
                             allowed_walk01=("z",))
    assert fusion.verify_chain(res.certificate, hw, res.producer_mapping,
                               res.consumer_mapping)
    plan = hm.plan_fused_mlp(*chain, dtype_bytes=dtype_bytes)
    if plan.fused:
        pm, pff, pk, pn2 = plan.padded
        assert plan.bm % hm.CTA_TILE == 0 and pm % plan.bm == 0
        assert pk % plan.bk == 0
        assert hm.fused_smem_bytes(plan.bm, pff) <= hm.SMEM_BYTES


@pytest.mark.parametrize("M", [4, 64])
def test_smoke_chain_fuses_in_fp32(M):
    plan = hm.plan_fused_mlp(M, 128, 64, 64, dtype_bytes=4)
    assert plan.fused and plan.bm > 0 and plan.bk > 0


def test_full_width_mlp_does_not_fuse():
    """At llama3-8b's width the (bm, 14336) strips never fit a CTA, so
    every MLP runs as three B1 launches."""
    for M in (4, 64):
        assert not hm.plan_fused_mlp(M, 14336, 4096, 4096,
                                     dtype_bytes=2).fused


def test_oversized_strips_recorded_unfused():
    """A chain the solver fuses under the bf16 word budget but whose fp32
    strips exceed one CTA's shared memory falls back to the composition."""
    chain, hw, padded = hm.fused_mlp_problem(64, 512, 64, 64, dtype_bytes=2)
    res = fusion.solve_chain(chain, hw, objective="energy",
                             allowed_walk01=("z",))
    plan = hm.plan_fused_mlp(64, 512, 64, 64, dtype_bytes=2)
    if res.certificate.fused:
        bm = res.producer_mapping.L1[0]
        assert (hm.fused_smem_bytes(bm, padded[1]) <= hm.SMEM_BYTES) \
            == plan.fused
    assert not plan.fused or \
        hm.fused_smem_bytes(plan.bm, padded[1]) <= hm.SMEM_BYTES


def test_h100_spec_is_per_cta():
    spec = hm.H100_LIKE
    assert spec.sram_words == int(hm.SMEM_BYTES * hm.SMEM_BUDGET)
    assert spec.fixed_spatial == (hm.CTA_TILE, hm.CTA_TILE, 1)
    assert spec.num_pe == hm.CTA_TILE * hm.CTA_TILE
    assert hm.scaled_spec(4).sram_words == spec.sram_words // 4


def test_plan_store_read_through_from_env(tmp_path, monkeypatch):
    """With no store installed, get_plan_store resolves $GOMA_PLAN_DB once;
    plans then solve through that store and a second resolution in a
    fresh process state reads them back with no solve."""
    from repro_torch.core.solver import reset_solver_stats, solver_stats
    monkeypatch.setattr(hm, "_PLAN_STORE", None)
    monkeypatch.setattr(hm, "_PLAN_STORE_RESOLVED", False)
    monkeypatch.delenv("GOMA_PLAN_DB", raising=False)
    assert hm.get_plan_store() is None
    monkeypatch.setattr(hm, "_PLAN_STORE_RESOLVED", False)
    monkeypatch.setenv("GOMA_PLAN_DB", str(tmp_path))
    hm.plan_gemm_tiling.cache_clear()
    try:
        store = hm.get_plan_store()
        assert store is not None and store.root == tmp_path
        cold = hm.plan_gemm_tiling(96, 160, 200, dtype_bytes=4)
        assert store.puts > 0 and store.misses > 0
        monkeypatch.setattr(hm, "_PLAN_STORE", None)
        monkeypatch.setattr(hm, "_PLAN_STORE_RESOLVED", False)
        hm.plan_gemm_tiling.cache_clear()
        reset_solver_stats()
        warm = hm.plan_gemm_tiling(96, 160, 200, dtype_bytes=4)
        again = hm.get_plan_store()
        assert again is not store and again.puts == 0 and again.hits > 0
        assert solver_stats()["calls"] == 0
        assert (warm.block, warm.grid_order, warm.walk, warm.objective) \
            == (cold.block, cold.grid_order, cold.walk, cold.objective)
    finally:
        hm.plan_gemm_tiling.cache_clear()
