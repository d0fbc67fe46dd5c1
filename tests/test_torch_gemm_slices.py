"""B1's CTA decomposition (repro_torch.kernels.goma_gemm.cta_slices and
cta_tiles), checked on the CPU: every output of every plan block is
covered by exactly one CTA tile, a block's tiles are adjacent in launch
order and the blocks follow the plan's walk, and the slice widths the
wrapper picks give the served decode shapes the CTAs PERF.md states.
The bf16 kernel computes its tiles with the same index arithmetic
(csrc/goma_gemm.cu); that the kernel's result does not depend on the
decomposition is checked on the card (test_torch_cuda.py,
chip_smoke.py)."""
import numpy as np
import pytest
import torch

from repro_torch.core.hopper_mapping import (CTA_TILE, FusedTilePlan,
                                             plan_gemm_tiling)
from repro_torch.kernels.goma_gemm import (SLICE_WIDTHS, cta_slices,
                                           cta_tiles, goma_matmul,
                                           goma_matmul_plain, pad_k)

# the bf16 MLP products the full-width paths serve: llama3-8b's and
# zamba2-2.7b's gate/up and down at decode (4 rows) and in the prefill
# (64 and 800 rows)
SERVED = [(4, 14336, 4096), (4, 4096, 14336), (64, 14336, 4096),
          (64, 4096, 14336), (4, 10240, 2560), (4, 2560, 10240),
          (800, 10240, 2560), (800, 2560, 10240)]
# tests/test_kernels.py's MATRIX_SHAPES
ODD = [(128, 128, 128), (300, 200, 100), (129, 257, 65), (100, 50, 1),
       (256, 384, 512)]
# CTAs the wrapper launches at each served decode shape (PERF.md, B1's
# served shapes), at the default slice width
DECODE_CTAS = {(4, 14336, 4096): 112, (4, 4096, 14336): 64,
               (64, 14336, 4096): 112, (64, 4096, 14336): 64,
               (4, 10240, 2560): 80, (4, 2560, 10240): 40}


def _fused_link_plans():
    """The producer and consumer plans of the hand-made B2 plans that
    chip_smoke.py and test_torch_cuda.py hold B2 at."""
    plans = []
    for bm, bk in ((128, 128), (128, 64), (64, 32)):
        fp = FusedTilePlan(M=128, FF=128, K=128, N2=128,
                           padded=(128, 128, 128, 128), fused=True, bm=bm,
                           bk=bk, objective=0.0, unfused_objective=0.0,
                           solve_time_s=0.0)
        plans += [fp.producer_plan(), fp.consumer_plan()]
    return plans


PLANS = ([plan_gemm_tiling(*s, dtype_bytes=2) for s in SERVED + ODD]
         + _fused_link_plans())
PLAN_IDS = ([f"served-{m}x{n}x{k}" for m, n, k in SERVED]
            + [f"odd-{m}x{n}x{k}" for m, n, k in ODD]
            + [f"b2-{link}-bm{bm}-bk{bk}"
               for bm, bk in ((128, 128), (128, 64), (64, 32))
               for link in ("producer", "consumer")])


@pytest.mark.parametrize("plan", PLANS, ids=PLAN_IDS)
def test_cta_tiles_cover_every_output_once(plan):
    pm, pn, _ = plan.padded
    bm, bn, _ = plan.block
    chosen = cta_slices(plan)
    assert chosen in SLICE_WIDTHS and chosen % 16 == 0 and bn % chosen == 0
    for width in (w for w in SLICE_WIDTHS if bn % w == 0):
        tiles = cta_tiles(plan, width)
        hits = np.zeros((pm // CTA_TILE, pn // width), dtype=int)
        for row0, col0 in tiles:
            assert row0 % CTA_TILE == 0 and col0 % width == 0
            hits[row0 // CTA_TILE, col0 // width] += 1
        assert (hits == 1).all(), (width, hits)
        # a block's tiles are adjacent, and the blocks follow the walk:
        # the walking axis varies fastest
        blocks = [(r // bm, c // bn) for r, c in tiles]
        runs = [b for i, b in enumerate(blocks)
                if i == 0 or b != blocks[i - 1]]
        assert len(runs) == len(set(runs)) == (pm // bm) * (pn // bn)
        fast = 0 if plan.walk == "x" else 1
        if len(runs) > 1 and pm // bm > 1 and pn // bn > 1:
            assert runs[1][fast] == runs[0][fast] + 1


@pytest.mark.parametrize("shape", sorted(DECODE_CTAS),
                         ids=[f"{m}x{n}x{k}" for m, n, k in
                              sorted(DECODE_CTAS)])
def test_served_decode_shapes_reach_their_ctas(shape):
    """At least the CTAs PERF.md states, and at least a quarter of the
    132 SMs, each with a slice read in full 128-byte rows."""
    plan = plan_gemm_tiling(*shape, dtype_bytes=2)
    width = cta_slices(plan)
    assert width >= 64
    assert len(cta_tiles(plan, width)) >= DECODE_CTAS[shape] >= 132 // 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cpu_tensors_take_the_plain_version(dtype):
    """On the CPU goma_matmul is goma_matmul_plain, whatever slice width
    is asked for, and launches nothing."""
    plan = plan_gemm_tiling(129, 257, 65, dtype_bytes=dtype.itemsize)
    pm, pn, pk = plan.padded
    rng = np.random.default_rng(14)
    a = torch.zeros((pm, pk), dtype=dtype)
    a[:129, :65] = torch.from_numpy(rng.standard_normal((129, 65)).astype(
        np.float32)).to(dtype)
    b = torch.from_numpy(rng.standard_normal((pk, pn)).astype(
        np.float32)).to(dtype)
    before = goma_matmul.launches
    want = goma_matmul_plain(a, b, plan)
    assert torch.equal(goma_matmul(a, b, plan), want)
    for width in (w for w in SLICE_WIDTHS if plan.block[1] % w == 0):
        assert torch.equal(goma_matmul(a, b, plan, slice_n=width), want)
    assert goma_matmul.launches == before


@pytest.mark.parametrize("k", [1, 7, 8, 65])
def test_pad_k_keeps_the_product(k):
    """The k padding the bf16 kernels need for a TMA row stride (a
    multiple of 8) adds zeros only."""
    rng = np.random.default_rng(15)
    a = torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, 64)).astype(np.float32))
    pa, pb = pad_k(a, b)
    assert pa.shape[1] == pb.shape[0] == -(-k // 8) * 8
    assert torch.equal(pa[:, :k], a) and torch.equal(pb[:k], b)
    assert not pa[:, k:].any() and not pb[k:].any()
    torch.testing.assert_close(pa @ pb, a @ b, rtol=0, atol=1e-5)
