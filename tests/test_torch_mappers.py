"""The port's mappers, co-design sweep and simulator oracle
(``repro_torch.core.mappers``, ``core.codesign``, ``core.sim_oracle``:
verbatim copies of the reference's) against the reference.

- The twins of ``tests/test_mappers.py``, ``tests/test_codesign.py`` and
  ``tests/test_pareto.py::test_codesign_frontier_tie_determinism`` run on
  the port: every mapper is feasible on the four reference pairs and
  GOMA dominates, GOMA's certificate, GOMA-eq, determinism, the area
  proxy, a design sweep and its frontier, and the frontier's ties.
- Port == reference: each mapper's mapping and EDP, bit for bit, on two
  small (template, GEMM) pairs at one seed; ``simulate_counts`` on small
  GEMMs equal the reference's and, where the closed form is exact, the
  closed-form counts.
- ROADMAP C21, a property of the reference: the five baselines search
  as if ``AcceleratorSpec.fixed_spatial`` were not there (their
  feasibility check then rejects what misses the fixed tile), so on
  ``TPUV5E_LIKE`` (both packages) and on the port's ``H100_LIKE`` they
  find no mapping for the served shapes, while GOMA, which searches
  under the fixed array, finds one on the padded shapes.  cosa,
  factorflow and loma are deterministic; salsa and timeloop-hybrid seed
  their draws from ``hash((seed, dims, hw.name))``, which Python
  randomises per process, and now and then a draw lands on the fixed
  tile: what they return is then a mapping at exactly that tile.
"""
import dataclasses
import random

import pytest

from repro.core import TEMPLATES as JTEMPLATES
from repro.core import Gemm as JGemm
from repro.core import Mapping as JMapping
from repro.core import TPUV5E_LIKE as JTPUV5E
from repro.core import simulate_counts as jsimulate_counts
from repro.core.mappers import ALL_MAPPERS as JMAPPERS
from repro_torch.core import (EYERISS_LIKE, TEMPLATES, TPUV5E_LIKE, Gemm,
                              Mapping, analytical_counts,
                              closed_form_is_exact, simulate_counts)
from repro_torch.core.codesign import (DesignPoint, area_proxy,
                                       evaluate_design, pareto_frontier,
                                       sweep)
from repro_torch.core.geometry import AXES, divisor_chains
from repro_torch.core.hopper_mapping import H100_LIKE
from repro_torch.core.mappers import ALL_MAPPERS
from repro_torch.core.workloads import QWEN3_0_6B, prefill_gemms

PAIRS = [
    ("eyeriss-like", Gemm(1024, 2048, 2048)),
    ("gemmini-like", Gemm(1024, 8192, 2048)),
    ("a100-like", Gemm(1, 128256, 8192)),       # lm_head matrix-vector
    ("tpuv1-like", Gemm(2048, 2048, 128)),       # attn-score-like
]
# port == reference, mapper by mapper
SMALL = [("eyeriss-like", (256, 512, 128)), ("gemmini-like", (128, 256, 512))]
BASELINES = ("cosa", "factorflow", "loma", "salsa", "timeloop-hybrid")


@pytest.mark.parametrize("hw_name,gemm", PAIRS,
                         ids=[f"{h}-{g.dims}" for h, g in PAIRS])
def test_all_mappers_feasible_and_goma_dominates(hw_name, gemm):
    hw = TEMPLATES[hw_name]
    results = {}
    for name, cls in ALL_MAPPERS.items():
        r = cls(seed=1).map(gemm, hw)
        assert r.mapping is not None, (name, hw_name, gemm)
        assert r.report.edp > 0
        results[name] = r
    best = results["goma"].edp
    for name, r in results.items():
        assert r.edp >= best * (1 - 1e-9), \
            f"{name} beat GOMA: {r.edp} < {best}"


def test_goma_certificate_attached():
    hw = TEMPLATES["eyeriss-like"]
    r = ALL_MAPPERS["goma"](seed=0).map(Gemm(256, 512, 128), hw)
    cert = r.extra["certificate"]
    assert cert.feasible and cert.gap == 0.0
    assert "certificate" in cert.summary()


def test_goma_eq_matches_paper_equivalence():
    hw = TEMPLATES["a100-like"]
    gemm = Gemm(2048, 25600, 5120)
    r_edp = ALL_MAPPERS["goma"](seed=0).map(gemm, hw)
    r_eq = ALL_MAPPERS["goma-eq"](seed=0).map(gemm, hw)
    assert r_edp.edp <= r_eq.edp * (1 + 1e-9)


def test_mappers_deterministic():
    hw = TEMPLATES["eyeriss-like"]
    gemm = Gemm(512, 512, 512)
    for name in ("goma", "cosa", "factorflow", "loma"):
        r1 = ALL_MAPPERS[name](seed=3).map(gemm, hw)
        r2 = ALL_MAPPERS[name](seed=3).map(gemm, hw)
        assert r1.mapping == r2.mapping, name


@pytest.mark.parametrize("hw_name,dims,mapper",
                         [(h, d, m) for h, d in SMALL for m in ALL_MAPPERS],
                         ids=[f"{h}-{d}-{m}" for h, d in SMALL
                              for m in ALL_MAPPERS])
def test_mapper_equals_the_references(hw_name, dims, mapper):
    """The same mapping and the same EDP, bit for bit."""
    got = ALL_MAPPERS[mapper](seed=1).map(Gemm(*dims), TEMPLATES[hw_name])
    want = JMAPPERS[mapper](seed=1).map(JGemm(*dims), JTEMPLATES[hw_name])
    assert got.mapping is not None and want.mapping is not None
    assert dataclasses.astuple(got.mapping) == \
        dataclasses.astuple(want.mapping)
    assert got.edp == want.edp
    assert dataclasses.astuple(got.report) == dataclasses.astuple(
        want.report)
    assert got.evals == want.evals


SIM_GEMMS = [(4, 4, 4), (8, 4, 6), (12, 6, 8), (9, 6, 12)]


@pytest.mark.parametrize("dims", SIM_GEMMS, ids=str)
def test_simulate_counts_equal_the_references(dims):
    """On random mappings of a small GEMM the port's step-by-step counts
    equal the reference's exactly, and equal the closed form's wherever
    ``closed_form_is_exact`` says it must."""
    rng = random.Random(sum(dims))
    gemm, jgemm = Gemm(*dims), JGemm(*dims)
    exact = 0
    for _ in range(25):
        chains = [rng.choice(divisor_chains(d)) for d in dims]
        fields = dict(
            L1=tuple(c[0] for c in chains), L2=tuple(c[1] for c in chains),
            L3=tuple(c[2] for c in chains), alpha01=rng.choice(AXES),
            alpha12=rng.choice(AXES),
            res1=tuple(rng.random() < 0.8 for _ in range(3)),
            res3=tuple(rng.random() < 0.8 for _ in range(3)))
        m = Mapping(**fields)
        got = simulate_counts(gemm, m)
        assert got.as_dict() == jsimulate_counts(
            jgemm, JMapping(**fields)).as_dict()
        if closed_form_is_exact(gemm, m):
            exact += 1
            assert got.isclose(analytical_counts(gemm, m)), (dims, m)
    assert exact > 0


C21_SHAPES = [(128, 4096, 14336), (1024, 2048, 2048)]
# the baselines whose search draws from a process-salted seed
DRAWN = ("salsa", "timeloop-hybrid")


def _c21(mappers, hw, gemm):
    """No deterministic baseline finds a mapping; a drawn one finds one
    only at exactly the fixed tile, and not in all of four seeds (at
    these shapes 2 seeds in 20 at most found one); GOMA and GOMA-eq find
    one."""
    assert hw.fixed_spatial
    for name in BASELINES:
        if name not in DRAWN:
            assert mappers[name](seed=1).map(gemm, hw).mapping is None, name
            continue
        found = [mappers[name](seed=s).map(gemm, hw).mapping
                 for s in range(4)]
        hits = [m for m in found if m is not None]
        assert len(hits) < len(found), name
        assert all(m.spatial == hw.fixed_spatial for m in hits), name
    for name in ("goma", "goma-eq"):
        r = mappers[name](seed=1).map(gemm, hw)
        assert r.mapping is not None and r.mapping.spatial == \
            hw.fixed_spatial


@pytest.mark.parametrize("package,dims",
                         [(p, d) for p in ("port", "reference")
                          for d in C21_SHAPES],
                         ids=[f"{p}-{d}" for p in ("port", "reference")
                              for d in C21_SHAPES])
def test_c21_baselines_ignore_the_fixed_array_of_tpuv5e(package, dims):
    """ROADMAP C21 on TPUV5E_LIKE's fixed 128 x 128 array, in both
    packages."""
    if package == "port":
        _c21(ALL_MAPPERS, TPUV5E_LIKE, Gemm(*dims))
    else:
        _c21(JMAPPERS, JTPUV5E, JGemm(*dims))


@pytest.mark.parametrize("dims", [(128, 4096, 14336), (8320, 36864, 4608)],
                         ids=str)
def test_c21_baselines_ignore_the_fixed_tile_of_h100_like(dims):
    """ROADMAP C21 on the port's H100_LIKE (its fixed 64 x 64 MMA tile),
    at served shapes padded to the tile."""
    _c21(ALL_MAPPERS, H100_LIKE, Gemm(*dims))


def test_area_proxy_monotone():
    a = area_proxy(256, 162 * 1024, 424)
    assert area_proxy(512, 162 * 1024, 424) > a
    assert area_proxy(256, 324 * 1024, 424) > a
    assert area_proxy(256, 162 * 1024, 848) > a


def test_small_sweep_and_frontier():
    """The reference's sweep test on half its grid (one RF size), so that
    it stays short: the frontier is sorted by area, strictly improving in
    EDP, and no feasible point dominates a frontier point."""
    pts = sweep(EYERISS_LIKE, QWEN3_0_6B, 1024,
                pe_opts=(64, 256), sram_kib_opts=(64, 162),
                rf_opts=(424,))
    assert len(pts) == 4
    assert any(p.feasible for p in pts)
    front = pareto_frontier(pts)
    assert front, "frontier must be non-empty"
    for a, b in zip(front, front[1:]):
        assert b.area > a.area and b.edp < a.edp
    for f in front:
        for p in pts:
            if p.feasible:
                assert not (p.area < f.area and p.edp < f.edp)


def test_more_pe_helps_big_gemm():
    wl = [w for w in prefill_gemms(QWEN3_0_6B, 1024)
          if w[0] == "mlp_gate_up"]
    small = evaluate_design(EYERISS_LIKE, 64, 162 * 1024, 424, wl)
    big = evaluate_design(EYERISS_LIKE, 1024, 162 * 1024, 424, wl)
    assert small.feasible and big.feasible
    assert big.edp < small.edp


def test_codesign_frontier_tie_determinism():
    mk = lambda npe, s, r, area, edp: DesignPoint(      # noqa: E731
        npe, s, r, area, edp, 1.0, True)
    a = mk(64, 1024, 64, 100.0, 2.0)
    b = mk(256, 512, 32, 100.0, 2.0)
    cheaper = mk(32, 256, 16, 50.0, 3.0)
    for order in ([a, b, cheaper], [b, cheaper, a], [cheaper, a, b]):
        assert pareto_frontier(order) == [cheaper, a]


def test_c21_goma_needs_the_tile_padded_shape():
    """At the unpadded decode shape GOMA finds no mapping on H100_LIKE's
    fixed 64 x 64 tile either; at the rows the planner pads to, it does."""
    goma = ALL_MAPPERS["goma"](seed=1)
    assert goma.map(Gemm(4, 14336, 4096), H100_LIKE).mapping is None
    m = goma.map(Gemm(64, 14336, 4096), H100_LIKE).mapping
    assert m is not None and m.spatial == H100_LIKE.fixed_spatial
