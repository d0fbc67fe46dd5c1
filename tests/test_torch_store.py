"""The port's GOMA plan store against the reference's, on the CPU.

One on-disk format for both packages: a store the reference built is read
by the port (every TPU key hits, plans equal field for field, no solve)
and the other way round; Hopper plans sit beside the TPU plans under keys
of their own and equal the in-process plans.  The scheduler's store tests
of the reference (tests/test_serving_sched.py) are twinned with the
enumerated prewarm source, with streams equal to the JAX scheduler's under
the same settings, fused MLP on and off; then the capture prewarm source
and the plan commands that capture and fidelity brought."""
import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import solver as ref_solver
from repro.core import tpu_mapping as ref_tm
from repro.models import build_model as jbuild_model
from repro.planner import PlanStore as RefPlanStore
from repro.planner import cli as ref_cli
from repro.planner.batch import prewarm_tpu_plans as ref_prewarm_tpu_plans
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro.serving.sched import ContinuousScheduler as JScheduler
from repro.serving.sched import SchedConfig as JSchedConfig
from repro.serving.sched import TraceClock as JTraceClock
from repro.serving.sched import replay as jreplay
from repro_torch.configs import get_config
from repro_torch.core import hopper_mapping as hm
from repro_torch.core.hardware import TPUV5E_LIKE
from repro_torch.core.solver import reset_solver_stats, solver_stats
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.obs.registry import get_registry
from repro_torch.planner import PlanStore, cli
from repro_torch.planner import batch as port_batch
from repro_torch.serving import Engine, ServeConfig
from repro_torch.serving.sched import (ContinuousScheduler, Request,
                                       SchedConfig, TraceClock, replay)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = 96
SCHED = dict(slots=3, chunk_widths=(4, 16))
ARCH = "llama3-8b"
# chip_smoke.py's SERVED_MLPS: the bf16 MLP GEMMs that B1 runs on the
# card, (M, N, K) — llama3-8b at decode (4) and prefill (64), at the
# scheduler's slots and chunk widths (8, 32, 128), and zamba2-2.7b's
# shared MLP at decode (4) and prefill (800)
SERVED_MLPS = sorted({(m, n, k)
                      for ms, ff, d in (((4, 64, 8, 32, 128), 14336, 4096),
                                        ((4, 800), 10240, 2560))
                      for m in ms for n, k in ((ff, d), (d, ff))})


def _smoke_shapes(dtype_bytes: int) -> list[tuple[int, int, int]]:
    """Every projection and MLP GEMM of the llama3-8b smoke config at
    the scheduler's rows (3 slots, chunks of 4 and 16) and a prefill of
    64 rows, as (M, N, K)."""
    c = get_config(ARCH, smoke=True)
    hd = c.head_dim
    nk = [(c.n_heads * hd, c.d_model), (c.kv_heads * hd, c.d_model),
          (c.d_model, c.n_heads * hd), (c.d_ff, c.d_model),
          (c.d_model, c.d_ff), (c.vocab, c.d_model)]
    return sorted({(m, n, k) for m in (3, 4, 16, 64) for n, k in nk})


def _fields(plan) -> tuple:
    return (plan.M, plan.N, plan.K, plan.padded, plan.block,
            plan.grid_order, plan.walk, plan.objective)


def _fused_fields(plan) -> tuple:
    return (plan.M, plan.FF, plan.K, plan.N2, plan.padded, plan.fused,
            plan.bm, plan.bk, plan.objective, plan.unfused_objective)


@pytest.fixture(autouse=True)
def _no_store_left_behind():
    """Both packages' process-wide stores and plan caches start and end
    empty, and the port's counters at zero."""
    def clear():
        hm.set_plan_store(None)
        hm.plan_gemm_tiling.cache_clear()
        hm._plan_fused_mlp.cache_clear()
        ref_tm.set_plan_store(None)
        ref_tm.plan_gemm_tiling.cache_clear()
        ref_tm._plan_fused_mlp.cache_clear()
        get_registry().reset()
    clear()
    yield
    clear()


# ------------------------------------------------ one format, two packages

REF_CHAINS = [(4, 128, 64, 64), (16, 128, 64, 64), (8, 14336, 4096, 4096)]


def test_reference_store_read_by_the_port(tmp_path, capsys):
    """A store the reference built in this process — its TPU prewarm of
    the smoke config's GEMMs and chains, and ``repro.plan build`` — is
    read by the port: every TPUV5E_LIKE key hits, the plans equal the
    reference's field for field, the port makes no solver call, and the
    port CLI verifies it and counts what the reference counts."""
    ref_store = RefPlanStore(tmp_path)
    want = {}
    for db in (4, 2):
        ref_prewarm_tpu_plans(_smoke_shapes(db), ref_store, dtype_bytes=db)
        for s in _smoke_shapes(db):
            want[s, db] = ref_tm.plan_gemm_tiling(*s, dtype_bytes=db)
        for c in REF_CHAINS:
            want[c, db] = ref_tm.plan_fused_mlp(*c, dtype_bytes=db)
    assert ref_cli.main(["build", "--model", "qwen3-0.6b", "--hw",
                         "eyeriss-like", "--seqs", "128", "--jobs", "1",
                         "--store", str(tmp_path)]) == 0
    ref_tm.set_plan_store(None)
    capsys.readouterr()
    assert ref_cli.main(["inspect", "--store", str(tmp_path)]) == 0
    ref_inspect = capsys.readouterr().out.splitlines()

    store = PlanStore(tmp_path)
    hm.set_plan_store(store)
    reset_solver_stats()
    for (dims, db), ref in want.items():
        if len(dims) == 3:
            got = hm.plan_gemm_tiling(*dims, dtype_bytes=db,
                                      spec=TPUV5E_LIKE, pad=hm.MXU)
            assert _fields(got) == _fields(ref), dims
        else:
            got = hm.plan_fused_mlp(*dims, dtype_bytes=db,
                                    spec=TPUV5E_LIKE, pad=hm.MXU)
            assert _fused_fields(got) == _fused_fields(ref), dims
    assert solver_stats()["calls"] == 0
    assert store.misses == 0 and store.puts == 0 and store.hits > 0
    capsys.readouterr()
    # the reference CLI's scenario: a warm port build hits every plan
    assert cli.main(["build", "--model", "qwen3-0.6b", "--hw",
                     "eyeriss-like", "--seqs", "128", "--jobs", "1",
                     "--store", str(tmp_path)]) == 0
    assert "hits=7 solved=0" in capsys.readouterr().out
    assert solver_stats()["calls"] == 0
    assert cli.main(["verify", "--store", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out and f"{len(store)}/{len(store)} " \
        "certificates verified" in out
    assert cli.main(["inspect", "--store", str(tmp_path)]) == 0
    assert capsys.readouterr().out.splitlines() == ref_inspect


def test_port_store_read_by_the_reference(tmp_path, capsys):
    """The other way round: TPU plans and chains the port solved into a
    fresh store, and ``repro_torch.plan build``, are read by the
    reference with no solve and equal plans."""
    store = PlanStore(tmp_path)
    hm.set_plan_store(store)
    got = {}
    for s in _smoke_shapes(4):
        got[s] = hm.plan_gemm_tiling(*s, dtype_bytes=4, spec=TPUV5E_LIKE,
                                     pad=hm.MXU)
    for c in REF_CHAINS:
        got[c] = hm.plan_fused_mlp(*c, dtype_bytes=4, spec=TPUV5E_LIKE,
                                   pad=hm.MXU)
    assert store.puts > 0 and store.num_fused() > 0
    assert cli.main(["build", "--model", "qwen3-0.6b", "--hw",
                     "eyeriss-like", "--seqs", "128", "--jobs", "1",
                     "--store", str(tmp_path)]) == 0
    hm.set_plan_store(None)

    ref_store = RefPlanStore(tmp_path)
    ref_tm.set_plan_store(ref_store)
    ref_solver.reset_solver_stats()
    for dims, plan in got.items():
        if len(dims) == 3:
            want = ref_tm.plan_gemm_tiling(*dims, dtype_bytes=4)
            assert _fields(want) == _fields(plan), dims
        else:
            want = ref_tm.plan_fused_mlp(*dims, dtype_bytes=4)
            assert _fused_fields(want) == _fused_fields(plan), dims
    capsys.readouterr()
    assert ref_cli.main(["build", "--model", "qwen3-0.6b", "--hw",
                         "eyeriss-like", "--seqs", "128", "--jobs", "1",
                         "--store", str(tmp_path)]) == 0
    assert "hits=7 solved=0" in capsys.readouterr().out
    assert ref_solver.solver_stats()["calls"] == 0
    assert ref_store.misses == 0 and ref_store.puts == 0
    assert ref_cli.main(["verify", "--store", str(tmp_path)]) == 0


def test_hopper_plans_beside_tpu_plans(tmp_path):
    """One store holds the H100 and the TPU plans of the same GEMMs under
    different keys; every H100 plan of the served MLP shapes read back
    from the store equals the plan solved in process without a store."""
    fresh = {s: hm.plan_gemm_tiling(*s, dtype_bytes=2) for s in SERVED_MLPS}
    hm.plan_gemm_tiling.cache_clear()
    store = PlanStore(tmp_path)
    port_batch.prewarm_tpu_plans(SERVED_MLPS, store, dtype_bytes=2)
    hopper = len(store)
    for s in SERVED_MLPS:
        hm.plan_gemm_tiling(*s, dtype_bytes=2, spec=TPUV5E_LIKE,
                            pad=hm.MXU)
    assert len(store) > hopper
    by_spec = {}
    for e in store.entries():
        by_spec.setdefault(e.hw_name, set()).add(e.digest)
    assert set(by_spec) == {"h100-like-2B", "tpuv5e-like-2B"}
    assert not by_spec["h100-like-2B"] & by_spec["tpuv5e-like-2B"]
    # a cold process state: every plan comes from the store
    hm.set_plan_store(None)
    store = PlanStore(tmp_path)
    hm.set_plan_store(store)
    reset_solver_stats()
    for s in SERVED_MLPS:
        assert _fields(hm.plan_gemm_tiling(*s, dtype_bytes=2)) \
            == _fields(fresh[s]), s
        assert _fields(port_batch.tile_plan_from_store(
            store, *s, dtype_bytes=2)) == _fields(fresh[s]), s
    assert solver_stats()["calls"] == 0 and store.misses == 0


def test_batch_planner_workers_load_no_torch(tmp_path):
    """The batch planner's module pulls in no torch, so its spawned
    solver workers stay light; a two-worker build solves what an
    in-process one does."""
    code = (
        "import sys\n"
        "from repro_torch.core.hardware import TEMPLATES\n"
        "from repro_torch.core.workloads import EDGE_MODELS\n"
        "from repro_torch.planner import BatchPlanner, PlanStore\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'repro')]\n"
        "spec = EDGE_MODELS[0]\n"
        "objs = []\n"
        "for jobs, d in ((2, 'pool'), (1, 'seq')):\n"
        f"    p = BatchPlanner(PlanStore({str(tmp_path)!r} + '/' + d),"
        " jobs=jobs)\n"
        "    m = p.plan_model(spec, TEMPLATES['eyeriss-like'],"
        " prefill_seqs=(128,))\n"
        "    objs.append(sorted((e.dims, e.objective) "
        "for e in m.entries))\n"
        "assert objs[0] == objs[1] and p.last_report.solved > 1\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_set_plan_store_clears_both_caches(tmp_path):
    """Changing the store flushes the GEMM and the chain plan caches, so
    the new store records the traffic; re-installing it keeps them."""
    hm.plan_gemm_tiling(64, 128, 64, dtype_bytes=4)
    hm.plan_fused_mlp(4, 128, 64, dtype_bytes=4)
    store = PlanStore(tmp_path)
    hm.set_plan_store(store)
    assert hm.plan_gemm_tiling.cache_info().currsize == 0
    assert hm._plan_fused_mlp.cache_info().currsize == 0
    hm.plan_gemm_tiling(64, 128, 64, dtype_bytes=4)
    hm.plan_fused_mlp(4, 128, 64, dtype_bytes=4)
    assert len(store) > 0 and store.num_fused() == 1
    hm.set_plan_store(store)
    assert hm.plan_gemm_tiling.cache_info().currsize == 1
    assert hm._plan_fused_mlp.cache_info().currsize == 1


def test_fused_strip_check_applies_after_a_store_hit(tmp_path):
    """A chain the solver fuses but whose fp32 strips do not fit one CTA
    on the H100 is recorded unfused, whether it was solved now or read
    from the store (the stored chain certificate still says fused)."""
    chain = (4, 384, 64)
    fresh = hm.plan_fused_mlp(*chain, dtype_bytes=2)
    store = PlanStore(tmp_path)
    hm.set_plan_store(store)
    cold = hm.plan_fused_mlp(*chain, dtype_bytes=2)
    (entry,) = list(store.fused_entries())
    assert entry.certificate.fused
    hm.set_plan_store(None)
    hm.set_plan_store(PlanStore(tmp_path))
    reset_solver_stats()
    warm = hm.plan_fused_mlp(*chain, dtype_bytes=2)
    assert solver_stats()["calls"] == 0
    for plan in (fresh, cold, warm):
        assert not plan.fused and plan.bm == 0
    assert _fused_fields(warm) == _fused_fields(fresh)


def test_z_walk_resolve_goes_through_the_store(tmp_path):
    """A GEMM whose free optimum walks outside k with a partial reduction
    is re-solved restricted to the z walk; both solves are stored and a
    cold read makes neither."""
    shape = (300, 272, 272)
    fresh = hm.plan_gemm_tiling(*shape, dtype_bytes=2)
    assert fresh.walk == "z"
    store = PlanStore(tmp_path)
    hm.set_plan_store(store)
    hm.plan_gemm_tiling(*shape, dtype_bytes=2)
    walks = sorted(str(e.key_allowed_walk01) for e in store.entries())
    assert walks == ["('z',)", "None"]
    hm.set_plan_store(None)
    store = PlanStore(tmp_path)
    hm.set_plan_store(store)
    reset_solver_stats()
    assert _fields(hm.plan_gemm_tiling(*shape, dtype_bytes=2)) \
        == _fields(fresh)
    assert solver_stats()["calls"] == 0 and store.hits == 2


# ------------------------------------------------- the scheduler's twins

@pytest.fixture(scope="module", params=[False, True],
                ids=["unfused", "fused"])
def pair(request):
    """(jax model, jax params, port model, port params) for the
    llama3-8b smoke config with fused_mlp on or off."""
    fused = request.param
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True),
                               fused_mlp=fused)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), fused_mlp=fused)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = build_model(tcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jmodel, jparams, tmodel, tparams


def _requests(vocab: int, seed: int, n: int, prompt: int, new: int):
    rng = np.random.default_rng(seed)
    return [Request(req_id=i, tokens=rng.integers(0, vocab, (prompt,)),
                    max_new_tokens=new, arrival_s=0.0) for i in range(n)]


def _streams(results) -> dict:
    return {r.req_id: (r.tokens, r.finish_reason) for r in results}


def _port(pair, reqs, *, store=None, arch_id=None, **cfg):
    _, _, tmodel, tparams = pair
    engine = Engine(tmodel, tparams, ServeConfig(cache_len=CACHE),
                    plan_store=store)
    clock = TraceClock()
    sched = ContinuousScheduler(
        engine, SchedConfig(**{**SCHED, **cfg}), arch_id=arch_id,
        clock=clock.now)
    return sched, _replay(sched, reqs, clock)


def _replay(sched, reqs, clock):
    reset_solver_stats()
    return _streams(replay(sched, reqs, clock))


def _jax(pair, reqs, tmp_path, **cfg):
    """The JAX scheduler under the same settings: its own store, the
    enumerated prewarm for llama3-8b."""
    jmodel, jparams, _, _ = pair
    store = RefPlanStore(tmp_path / "ref")
    engine = JEngine(jmodel, jparams, JServeConfig(cache_len=CACHE),
                     plan_store=store)
    clock = JTraceClock()
    try:
        sched = JScheduler(engine, JSchedConfig(
            **{**SCHED, "prewarm_source": "enumerated", **cfg}),
            arch_id=ARCH, clock=clock.now)
        return _streams(jreplay(sched, reqs, clock))
    finally:
        ref_tm.set_plan_store(None)


def test_zero_solver_invocations_steady_state(pair, tmp_path):
    """Construction prewarms every bucketed GEMM tiling through the store;
    the replay then resolves every plan with zero solver calls and zero
    store misses, and its streams equal the JAX scheduler's under the
    same settings."""
    store = PlanStore(tmp_path / "port")
    reqs = _requests(pair[2].cfg.vocab, 1, 4, 12, 4)
    _, _, tmodel, tparams = pair
    engine = Engine(tmodel, tparams, ServeConfig(cache_len=CACHE),
                    plan_store=store)
    clock = TraceClock()
    sched = ContinuousScheduler(
        engine, SchedConfig(**SCHED, prewarm_source="enumerated"),
        arch_id=ARCH, clock=clock.now)
    assert sched.prewarmed_plans > 0
    assert store.puts > 0
    misses0 = store.misses
    got = _replay(sched, reqs, clock)
    assert solver_stats()["calls"] == 0
    assert store.misses == misses0
    assert "decode" in sched._resolved_groups
    assert sched._resolved_groups <= set(sched._plan_groups)
    assert got == _jax(pair, reqs, tmp_path)


def test_fused_mlp_scheduler_prewarms_chains(pair, tmp_path):
    """A fused-MLP model's scheduler prewarms the bucketed chain plans
    beside the GEMM tilings (an unfused one prewarms none); steady state
    makes zero solver calls, chain solves included, and stays
    token-identical to the static oracle and to the JAX scheduler."""
    _, _, tmodel, tparams = pair
    store = PlanStore(tmp_path / "port")
    reqs = _requests(tmodel.cfg.vocab, 3, 3, 10, 4)
    sched, got = _port(pair, reqs, store=store, arch_id=ARCH,
                       slots=2, prewarm_source="enumerated")
    fused = tmodel.cfg.fused_mlp
    assert (sched.prewarmed_chains > 0) == fused
    assert (store.num_fused() > 0) == fused
    assert solver_stats()["calls"] == 0
    oracle = Engine(tmodel, tparams, ServeConfig(max_new_tokens=4,
                                                 cache_len=CACHE))
    for req in reqs:
        assert got[req.req_id][0] == oracle.generate(
            req.tokens[None])[0].tolist()
    assert got == _jax(pair, reqs, tmp_path, slots=2)


def test_prewarm_dtype_mismatch_misses(pair, tmp_path, monkeypatch):
    """Plan identity includes the dtype-rescaled shared-memory capacity:
    plans prewarmed under the wrong dtype_bytes miss at dispatch; the
    engine's default (its compute dtype) hits."""
    _, _, tmodel, tparams = pair
    monkeypatch.setattr(port_batch, "serving_plan_shapes",
                        lambda *a, **k: [(64, 64, 64)])
    store = PlanStore(tmp_path)
    engine = Engine(tmodel, tparams, ServeConfig(cache_len=CACHE),
                    plan_store=store)
    assert engine.dispatch_dtype_bytes == 4       # fp32 smoke model
    engine.prewarm_plans(ARCH, 1, 8, dtype_bytes=2, source="enumerated")
    hm.plan_gemm_tiling.cache_clear()
    misses0, puts0 = store.misses, store.puts
    reset_solver_stats()
    hm.plan_gemm_tiling(64, 64, 64, dtype_bytes=4)
    assert store.misses > misses0
    assert store.puts > puts0                     # healed by a fresh solve
    assert solver_stats()["calls"] > 0
    engine.prewarm_plans(ARCH, 1, 8, source="enumerated")
    hm.plan_gemm_tiling.cache_clear()
    misses1, hits1 = store.misses, store.hits
    reset_solver_stats()
    hm.plan_gemm_tiling(64, 64, 64, dtype_bytes=4)
    assert store.misses == misses1
    assert store.hits > hits1
    assert solver_stats()["calls"] == 0


# ----------------------------------------------------- the lifted settings

def test_latency_slo_fills_slo_points(pair, tmp_path):
    """latency_slo_ns builds every bucketed shape's frontier into the
    store and picks a point per shape; the streams do not change."""
    reqs = _requests(pair[2].cfg.vocab, 4, 3, 10, 4)
    _, want = _port(pair, reqs)
    store = PlanStore(tmp_path)
    sched, got = _port(pair, reqs, store=store, arch_id=ARCH,
                       prewarm_source="enumerated", latency_slo_ns=1e12)
    assert sched.prewarmed_pareto > 0 and store.num_pareto() > 0
    assert set(sched.slo_points) == {s for g in sched._plan_groups.values()
                                     for s in g}
    assert got == want
    assert solver_stats()["calls"] == 0


def test_mesh_chips_fills_the_sharded_section(pair, tmp_path):
    """mesh_chips=2 prewarms joint (partition, tiling) plans into the
    store's sharded section; serving stays on one device, streams
    unchanged."""
    reqs = _requests(pair[2].cfg.vocab, 5, 3, 10, 4)
    _, want = _port(pair, reqs)
    store = PlanStore(tmp_path)
    sched, got = _port(pair, reqs, store=store, arch_id=ARCH,
                       prewarm_source="enumerated", mesh_chips=2)
    assert sched.prewarmed_sharded > 0
    assert 0 < store.num_sharded() <= sched.prewarmed_sharded
    assert all(e.n_chips == 2 for e in store.sharded_entries())
    assert got == want


def test_resolve_plans_off_serves_with_no_prewarm(pair, tmp_path):
    """resolve_plans=False: without a store or arch_id nothing is
    prewarmed and nothing is resolved per phase; with them the prewarm
    runs but no phase resolves.  Streams are unchanged either way."""
    reqs = _requests(pair[2].cfg.vocab, 6, 3, 10, 4)
    _, want = _port(pair, reqs)
    sched, got = _port(pair, reqs, resolve_plans=False)
    assert sched.prewarmed_plans == 0 and not sched._plan_groups
    assert got == want
    sched, got = _port(pair, reqs, store=PlanStore(tmp_path),
                       arch_id=ARCH, prewarm_source="enumerated",
                       resolve_plans=False)
    assert sched.prewarmed_plans > 0 and not sched._resolved_groups
    assert got == want


# ------------------------------------------------- the capture source

def test_capture_prewarm_with_a_store(pair, tmp_path):
    """The capture prewarm source with a store, as the reference runs it:
    the scheduler (no arch_id) and ``Engine.prewarm_plans`` read their
    shapes off the model's traced programs and fill the store; a second
    scheduler on the store reopened, with the process's plan caches
    flushed, puts nothing and serves with no solver call; streams equal
    the JAX scheduler's with the capture source."""
    from repro_torch.capture import serving_capture_shapes
    _, _, tmodel, tparams = pair
    reqs = _requests(tmodel.cfg.vocab, 3, 4, 10, 5)
    store = PlanStore(tmp_path / "db")
    engine = Engine(tmodel, tparams, ServeConfig(cache_len=CACHE),
                    plan_store=store)
    sched = ContinuousScheduler(engine, SchedConfig(**SCHED))
    assert sched.prewarmed_plans > 0 and len(store) > 0
    n = engine.prewarm_plans(None, 1, 8)
    assert n == len(serving_capture_shapes(tmodel, 1, 8, CACHE)) > 0
    hm.set_plan_store(None)
    reopened = PlanStore(tmp_path / "db")
    got_sched, got = _port(pair, reqs, store=reopened)
    assert reopened.puts == 0 and reopened.misses == 0
    assert solver_stats()["calls"] == 0
    assert got_sched._plan_groups == sched._plan_groups
    assert got == _jax(pair, reqs, tmp_path, prewarm_source="capture")


def _fidelity_manifest(path):
    """test_obs.py's TestFidelity manifest: three shapes, an infeasible
    entry and a duplicate of the first shape under another family."""
    from repro_torch.planner.manifest import (ManifestEntry,
                                              ModelMappingManifest)
    shapes = [(128, 256, 256), (256, 512, 512), (512, 1024, 1024)]
    entries = [ManifestEntry(
        gemm_type="mlp", dims=d, weight=1, digest=f"e{i}", objective=0.0,
        feasible=True, solve_time_s=0.0, cached=False)
        for i, d in enumerate(shapes)]
    entries.append(ManifestEntry(
        gemm_type="attn", dims=shapes[0], weight=3, digest="dup",
        objective=0.0, feasible=True, solve_time_s=0.0, cached=False))
    ModelMappingManifest(
        model="t", hw_name="h100-like", objective="energy",
        prefill_seqs=(), decode_batches=(), cache_len=0,
        entries=entries).save(path)
    return path


def _calibration_rows(root):
    """test_pareto.py's synthetic calibration rows, recorded."""
    from repro_torch.obs.fidelity import (FidelityRow, _finalize_report,
                                          record_rows)
    rows = []
    for i in range(18):
        M, N, K = 8 * (i + 1), 16, 32
        bpl = {"dram": 100.0 * (i + 1) ** 2, "sram": 10.0 * (i + 1),
               "rf": 5.0}
        t_ns = 0.002 * M * N * K + 0.05 * bpl["dram"]
        rows.append(FidelityRow(
            plan_key=f"k{i}", manifest_digest=f"m{i}", gemm_type="s",
            dims=(M, N, K), weight=1, predicted_energy=1.0,
            predicted_bytes_per_level=bpl, measured_time_s=t_ns * 1e-9))
    return record_rows(_finalize_report(rows, gate=0.9, min_family=3),
                       root, "synthetic")


@pytest.mark.parametrize("command", [
    "capture", "trace", "build --chains", "fidelity", "calibrate"])
def test_ported_plan_commands_run(tmp_path, capsys, command):
    """The plan commands that were refused before program capture and
    fidelity were ported run, each with the reference's exit code: 0, or
    for fidelity and calibrate whether the report passes its gate."""
    import json
    from repro_torch.obs.calibrate import fit_jsonl
    db = str(tmp_path / "db")
    small = ["--hw", "gemmini-like", "--store", db]
    if command == "capture":
        rc = cli.main(["capture", "--model", "qwen3-0.6b", "--phase",
                       "prefill", "--seq", "64", "--jobs", "1", *small])
        assert rc == 0
        assert "[program]" in capsys.readouterr().out
        assert PlanStore(db).num_fused() == 1
    elif command == "trace":
        assert cli.main(["trace", "--model", "qwen3-0.6b", "--seq", "64",
                         *small]) == 0
        assert "capture.trace" in capsys.readouterr().out
    elif command == "build --chains":
        assert cli.main(["build", "--model", "qwen3-0.6b", "--chains",
                         "--seqs", "64", "--jobs", "1", *small]) == 0
        assert "[chains] 1 chain plans" in capsys.readouterr().out
    elif command == "fidelity":
        out = tmp_path / "report.json"
        rc = cli.main(["fidelity", "--manifest",
                       str(_fidelity_manifest(tmp_path / "m.json")),
                       "--device", "cpu", "--repeats", "1", "--warmup", "1",
                       "--store", db, "--out", str(out)])
        rep = json.loads(out.read_text())
        assert rc == (0 if rep["summary"]["passes"] else 1)
        assert len(rep["rows"]) == 4
        assert (tmp_path / "db" / "fidelity" / "t.jsonl").is_file()
    else:
        rows = _calibration_rows(tmp_path)
        rc = cli.main(["calibrate", "--rows", str(rows), "--save",
                       "--store", db])
        assert rc == (0 if fit_jsonl(rows).passes() else 1) == 0
        assert (tmp_path / "db" / "calibration" /
                "calibration.json").is_file()


def _serve(*args: str) -> str:
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--fused-mlp", "--device", "cpu", *args],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


@pytest.mark.parametrize("mode", [
    ["--batch", "2", "--prompt-len", "8", "--new-tokens", "3"],
    ["--continuous", "--requests", "4", "--prompt-len", "12",
     "--new-tokens", "3"]], ids=["static", "continuous"])
def test_serve_plan_db_twice(tmp_path, mode):
    """serve --plan-db on the CPU: the first run fills the store, the
    second makes no put and no solver call."""
    db = ["--plan-db", str(tmp_path), "--prewarm-source", "enumerated"]
    first = _serve(*mode, *db)
    assert "plan prewarm:" in first and "'puts': 0" not in first
    second = _serve(*mode, *db)
    assert second.count("'puts': 0") == 2 and "'misses': 0" in second
    assert "solver calls: 0" in second
