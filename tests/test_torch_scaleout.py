"""The port's serving scale-out (replica router, KV prefix cache,
speculative decoding) on the llama3-8b smoke config (fp32), each test of
the reference's tests/test_scaleout.py (and its router chaos tests in
tests/test_chaos.py) run against the port: every stream equals the
port's static Engine.generate oracle and, where the reference has the
same path, the JAX package's streams on the same weights (the
reference's init_params moved over with params_from_jax); prefix hits
are bit-identical to recomputed rows, the fleet makes zero solver calls
after one donor prewarm, and Engine.verify_step matches the reference's
on the same cache and window."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro.serving.router import ModelDrafter as JModelDrafter
from repro.serving.router import NgramDrafter as JNgramDrafter
from repro.serving.router import PrefixCache as JPrefixCache
from repro.serving.router import ReplicaRouter as JReplicaRouter
from repro.serving.router import RouterConfig as JRouterConfig
from repro.serving.router import spec_generate as jspec_generate
from repro.serving.sched import ContinuousScheduler as JScheduler
from repro.serving.sched import Request as JRequest
from repro.serving.sched import SchedConfig as JSchedConfig
from repro_torch.configs import get_config
from repro_torch.core import hopper_mapping
from repro_torch.core.solver import reset_solver_stats, solver_stats
from repro_torch.faults import FaultInjector, FaultSpec, set_injector
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.obs.registry import get_registry
from repro_torch.planner import PlanStore
from repro_torch.serving import Engine, ServeConfig
from repro_torch.serving.router import (ModelDrafter, NgramDrafter,
                                        PrefixCache, ReplicaRouter,
                                        RouterConfig, spec_generate)
from repro_torch.serving.sched import (SUPPORTED_FAMILIES,
                                       ContinuousScheduler, Request,
                                       SchedConfig, ServingMetrics,
                                       TrafficConfig,
                                       ensure_supported_family,
                                       shared_prefix_trace)
from repro_torch.serving.sched.requests import RequestResult

CACHE = 128
ARCH = "llama3-8b"


@pytest.fixture(autouse=True)
def _port_observability():
    """The port keeps its own counter registry and fault injector: zero
    and clear them around every test, as conftest does the reference's."""
    get_registry().reset()
    set_injector(None)
    yield
    get_registry().reset()
    set_injector(None)


@dataclasses.dataclass
class Setup:
    cfg: object
    jmodel: object
    jparams: dict
    model: object
    params: dict
    engine: Engine
    oracle: Engine

    def jengine(self, **kw) -> JEngine:
        return JEngine(self.jmodel, self.jparams, JServeConfig(
            **{"max_new_tokens": 10, "cache_len": CACHE, **kw}))


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = build_model(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    engine = Engine(model, params, ServeConfig(max_new_tokens=10,
                                               cache_len=CACHE))
    oracle = Engine(model, params, ServeConfig(max_new_tokens=10,
                                               cache_len=CACHE))
    return Setup(cfg, jmodel, jparams, model, params, engine, oracle)


def _oracle_tokens(oracle: Engine, req: Request) -> list[int]:
    oracle.cfg.max_new_tokens = req.max_new_tokens
    oracle.cfg.stop_token = req.stop_token
    row = oracle.generate(req.tokens[None])[0]
    out = []
    for t in row[:req.max_new_tokens]:
        out.append(int(t))
        if req.stop_token is not None and int(t) == req.stop_token:
            break
    return out


def _assert_oracle_identical(results, reqs, oracle):
    by_id = {r.req_id: r for r in results}
    assert sorted(by_id) == sorted(r.req_id for r in reqs)
    for req in reqs:
        assert by_id[req.req_id].tokens == _oracle_tokens(oracle, req), \
            req.req_id


def _streams(results) -> dict:
    return {r.req_id: (list(r.tokens), r.finish_reason) for r in results}


def _jreqs(reqs) -> list:
    """The same requests for the JAX package."""
    return [JRequest(req_id=r.req_id, tokens=r.tokens,
                     max_new_tokens=r.max_new_tokens, arrival_s=r.arrival_s,
                     stop_token=r.stop_token) for r in reqs]


def _shared_prefix_requests(cfg, *, n=6, prefix_len=32, tail=5,
                            max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab, (prefix_len,)).astype(np.int32)
    reqs = []
    for i in range(n):
        t = rng.integers(0, cfg.vocab, (tail,)).astype(np.int32)
        reqs.append(Request(
            req_id=i, tokens=np.concatenate([shared, t]),
            max_new_tokens=max_new, arrival_s=0.001 * i))
    return reqs


def _kv_bytes(cache: dict, p: int) -> int:
    return sum(t[:, :, :p].numel() * t.element_size()
               for t in cache["layers"].values())


# ------------------------------------------------------- prefix cache

def test_prefix_cache_units(setup):
    """Boundary quantization, exact-token hit/miss, LRU byte budget."""
    pc = PrefixCache(16, max_bytes=1 << 20)
    assert pc._boundary(17) == 16
    assert pc._boundary(16) == 0       # P <= prompt_len - 1 always
    assert pc._boundary(33) == 32
    toks = np.arange(40, dtype=np.int32)
    cache = setup.engine.new_cache(1)
    assert pc.lookup(toks) is None                 # cold
    assert pc.insert(toks, cache)                  # stores P=32
    p, entry = pc.lookup(toks)
    assert p == 32 and entry.p == 32
    other = toks.copy()
    other[3] += 1
    assert pc.lookup(other) is None                # exact-token guard
    assert pc.lookup(toks[:20]) is None            # the P=32 entry only
    assert pc.insert(toks[:20], cache)
    p2, _ = pc.lookup(toks[:20])
    assert p2 == 16
    assert not pc.insert(toks[:9], cache)          # too short to store


def test_prefix_cache_lru_eviction_under_byte_pressure(setup):
    cache = setup.engine.new_cache(1)
    pc = PrefixCache(16, max_bytes=2 * _kv_bytes(cache, 16))  # room for 2
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 200, (20,)).astype(np.int32)
               for _ in range(3)]
    for p in prompts:
        assert pc.insert(p, cache)
    assert len(pc) == 2                               # oldest evicted
    assert pc.lookup(prompts[0]) is None
    assert pc.lookup(prompts[1]) is not None
    assert pc.lookup(prompts[2]) is not None
    snap = get_registry().snapshot()
    assert snap["prefix.evictions"] == 1
    assert pc.bytes_used <= pc.max_bytes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefix_graft_matches_reference_and_round_trips(setup, dtype):
    """A stored entry grafts back bit for bit (bf16 rows through their raw
    bits on the host), leaves the positions past P untouched, and on the
    same cache contents writes what the reference's graft writes."""
    rng = np.random.default_rng(4)
    cache = {"layers": {k: torch.from_numpy(rng.standard_normal(
        setup.engine.new_cache(1)["layers"][k].shape).astype(np.float32)
    ).to(dtype) for k in ("k", "v")}}
    toks = rng.integers(0, 200, (37,)).astype(np.int32)
    pc = PrefixCache(16)
    assert pc.insert(toks, cache)
    p, entry = pc.lookup(toks)
    dest = {"layers": {k: torch.zeros_like(v)
                       for k, v in cache["layers"].items()}}
    assert pc.graft(dest, entry) is dest
    for k in ("k", "v"):
        assert torch.equal(dest["layers"][k][:, :, :p],
                           cache["layers"][k][:, :, :p])
        assert not dest["layers"][k][:, :, p:].any()
    if dtype == torch.float32:
        jpc = JPrefixCache(16)
        jcache = {"layers": {k: jnp.asarray(v.numpy())
                             for k, v in cache["layers"].items()}}
        assert jpc.insert(toks, jcache)
        jgot = jpc.graft({"layers": {k: jnp.zeros(v.shape)
                                     for k, v in cache["layers"].items()}},
                         jpc.lookup(toks)[1])
        for k in ("k", "v"):
            np.testing.assert_array_equal(dest["layers"][k].numpy(),
                                          np.asarray(jgot["layers"][k]))


def test_prefix_serving_bit_identical_and_saves_prefill(setup):
    """Shared-prefix trace with the cache on: fewer prefill chunks,
    prefix.* traffic counted, tokens bit-identical to the oracle and
    streams equal to the JAX scheduler's with its own prefix cache."""
    cfg, engine, oracle = setup.cfg, setup.engine, setup.oracle
    reqs = _shared_prefix_requests(cfg)
    base = ContinuousScheduler(
        engine, SchedConfig(slots=2, chunk_widths=(8, 16)))
    base_results = base.run([Request(
        req_id=r.req_id, tokens=r.tokens,
        max_new_tokens=r.max_new_tokens) for r in reqs])
    _assert_oracle_identical(base_results, reqs, oracle)
    chunks_without = base.metrics.prefill_chunks

    get_registry().reset()
    pc = PrefixCache(16)
    sched = ContinuousScheduler(
        engine, SchedConfig(slots=2, chunk_widths=(8, 16)),
        prefix_cache=pc)
    results = sched.run(reqs)
    _assert_oracle_identical(results, reqs, oracle)
    assert sched.metrics.prefill_chunks < chunks_without
    snap = get_registry().snapshot()
    assert snap["prefix.hits"] >= len(reqs) - 1    # all but the first
    assert snap["sched.prefix_tokens_reused"] >= 32 * (len(reqs) - 1)
    jsched = JScheduler(setup.jengine(),
                        JSchedConfig(slots=2, chunk_widths=(8, 16)),
                        prefix_cache=JPrefixCache(16))
    assert _streams(results) == _streams(jsched.run(_jreqs(reqs)))
    assert sched.metrics.prefill_chunks == jsched.metrics.prefill_chunks


def test_prefix_grafted_rows_equal_recomputed_rows(setup):
    """The rows a hit grafts are bitwise the rows a prefill of the same
    prefix chunks computes in a fresh cache."""
    engine = setup.engine
    reqs = _shared_prefix_requests(setup.cfg, n=2)
    pc = PrefixCache(16)
    ContinuousScheduler(engine, SchedConfig(slots=2, chunk_widths=(8, 16)),
                        prefix_cache=pc).run(reqs[:1])
    p, entry = pc.lookup(reqs[1].tokens)
    grafted = pc.graft(engine.new_cache(1), entry)
    fresh = engine.new_cache(1)
    with torch.inference_mode():
        for start in range(0, p, 16):
            engine.prefill_chunk(fresh, reqs[1].tokens[None,
                                                       start:start + 16],
                                 start)
    for k in ("k", "v"):
        assert torch.equal(grafted["layers"][k][:, :, :p],
                           fresh["layers"][k][:, :, :p])


def test_prefix_eviction_during_serving_keeps_identity(setup):
    """A byte budget too small to hold every prefix thrashes the cache
    but never corrupts a stream."""
    cfg, engine, oracle = setup.cfg, setup.engine, setup.oracle
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(6):       # three distinct prefixes, interleaved
        shared = rng.integers(0, cfg.vocab, (32,)).astype(np.int32)
        for j in range(2):
            tail = rng.integers(0, cfg.vocab, (4,)).astype(np.int32)
            reqs.append(Request(
                req_id=10 * i + j,
                tokens=np.concatenate([shared, tail]),
                max_new_tokens=5))
    entry_bytes = _kv_bytes(engine.new_cache(1), 32)
    pc = PrefixCache(16, max_bytes=entry_bytes + entry_bytes // 2)
    sched = ContinuousScheduler(
        engine, SchedConfig(slots=2, chunk_widths=(8, 16)),
        prefix_cache=pc)
    results = sched.run(reqs)
    _assert_oracle_identical(results, reqs, oracle)
    assert get_registry().get("prefix.evictions") > 0


# ------------------------------------------------ speculative decoding

def test_verify_step_matches_reference(setup):
    """The port's verify_step and the reference's on the same cache and
    (B, W) window at per-row positions: equal greedy ids, equal finite
    flags (row 1's visible cache made non-finite), host arrays out."""
    rng = np.random.default_rng(6)
    B, W = 3, 4
    shape = setup.engine.new_cache(B)["layers"]["k"].shape
    kv = {k: (rng.standard_normal(shape) * 0.5).astype(np.float32)
          for k in ("k", "v")}
    kv["v"][0, 1, 2] = np.nan
    toks = rng.integers(0, setup.cfg.vocab, (B, W)).astype(np.int32)
    pos = np.array([5, 17, 40], np.int32)
    jgreedy, jfinite, _ = setup.jengine().verify_step(
        {"layers": {k: jnp.asarray(v) for k, v in kv.items()}}, toks, pos)
    greedy, finite, cache = setup.engine.verify_step(
        {"layers": {k: torch.from_numpy(v.copy()) for k, v in kv.items()}},
        toks, pos)
    assert isinstance(greedy, np.ndarray) and greedy.dtype == np.int32
    assert greedy.shape == (B, W) and finite.dtype == bool
    np.testing.assert_array_equal(finite, np.asarray(jfinite))
    assert finite.tolist() == [True, False, True]
    np.testing.assert_array_equal(greedy[finite], np.asarray(jgreedy)[finite])
    # the window's rows were written at each row's positions
    assert not np.array_equal(cache["layers"]["k"][:, 0, 5:9].numpy(),
                              kv["k"][:, 0, 5:9])


def test_spec_generate_ngram_byte_identical(setup):
    cfg, engine, oracle = setup.cfg, setup.engine, setup.oracle
    jengine = setup.jengine()
    for seed in range(3):
        prompt = np.random.default_rng(seed).integers(
            0, cfg.vocab, (11 + seed,)).astype(np.int32)
        oracle.cfg.max_new_tokens = 20
        oracle.cfg.stop_token = None
        want = [int(t) for t in oracle.generate(prompt[None])[0]]
        got = spec_generate(engine, prompt, NgramDrafter(),
                            max_new_tokens=20)
        assert list(got) == want
        assert list(got) == list(jspec_generate(
            jengine, prompt, JNgramDrafter(), max_new_tokens=20))
    assert get_registry().get("spec.rounds") > 0


def test_spec_generate_stop_token_identical(setup):
    """Stop tokens hit mid-verify-window truncate identically."""
    cfg, engine, oracle = setup.cfg, setup.engine, setup.oracle
    for seed in range(10):
        prompt = np.random.default_rng(seed).integers(
            0, cfg.vocab, (10,)).astype(np.int32)
        oracle.cfg.max_new_tokens = 16
        oracle.cfg.stop_token = None
        row = [int(t) for t in oracle.generate(prompt[None])[0]]
        stop = row[len(row) // 2]
        want = row[:row.index(stop) + 1]
        if len(want) == len(row):
            continue                     # stop would not fire early
        got = spec_generate(engine, prompt, NgramDrafter(),
                            max_new_tokens=16, stop_token=stop)
        assert list(got) == want
        return
    pytest.fail("no early-stopping prompt found")


def test_spec_generate_model_drafter_byte_identical(setup):
    """A draft model (another init, so other predictions): still the
    oracle's stream, and the JAX package's with the same draft weights —
    drafters set throughput, never content."""
    cfg, model, engine, oracle = setup.cfg, setup.model, setup.engine, \
        setup.oracle
    jdparams = setup.jmodel.init_params(jax.random.PRNGKey(9))
    dparams = params_from_jax(jax.tree.map(np.asarray, jdparams), cfg,
                              device="cpu")
    draft = Engine(model, dparams, ServeConfig(cache_len=CACHE))
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab, (12,)).astype(np.int32)
    oracle.cfg.max_new_tokens = 16
    oracle.cfg.stop_token = None
    want = [int(t) for t in oracle.generate(prompt[None])[0]]
    drafter = ModelDrafter(draft)
    got = spec_generate(engine, prompt, drafter, max_new_tokens=16)
    assert list(got) == want
    assert get_registry().get("spec.draft_steps") > 0
    jdraft = JEngine(setup.jmodel, jdparams, JServeConfig(cache_len=CACHE))
    jgot = jspec_generate(setup.jengine(), prompt, JModelDrafter(jdraft),
                          max_new_tokens=16)
    assert list(got) == list(jgot)
    # the drafter's own proposals equal the reference drafter's
    ctx = list(prompt) + want[:5]
    assert drafter.propose(ctx, 3) == JModelDrafter(jdraft).propose(ctx, 3)


def test_ngram_drafter_matches_reference():
    rng = np.random.default_rng(8)
    for _ in range(20):
        ctx = list(rng.integers(0, 5, int(rng.integers(0, 12))))
        for n in (1, 3):
            assert NgramDrafter(n).propose(ctx, 4) == \
                JNgramDrafter(n).propose(ctx, 4)


def test_scheduler_spec_decoding_token_identical(setup):
    cfg, engine, oracle = setup.cfg, setup.engine, setup.oracle
    rng = np.random.default_rng(4)
    reqs = [Request(req_id=i,
                    tokens=rng.integers(0, cfg.vocab,
                                        (9 + i,)).astype(np.int32),
                    max_new_tokens=10) for i in range(5)]
    sched = ContinuousScheduler(
        engine, SchedConfig(slots=3, chunk_widths=(8, 16), spec_width=4),
        drafter=NgramDrafter())
    results = sched.run(reqs)
    _assert_oracle_identical(results, reqs, oracle)
    snap = get_registry().snapshot()
    assert snap["sched.spec.rounds"] > 0
    assert snap["sched.spec.drafted"] == 3 * snap["sched.spec.rounds"]
    jsched = JScheduler(setup.jengine(),
                        JSchedConfig(slots=3, chunk_widths=(8, 16),
                                     spec_width=4),
                        drafter=JNgramDrafter())
    assert _streams(results) == _streams(jsched.run(_jreqs(reqs)))
    assert sched.metrics.decode_steps == jsched.metrics.decode_steps


def test_scheduler_spec_poisoned_row_evicts_only_that_request(setup):
    """kernel.nan_row in a verify step clears one active row's flag: that
    request ends ERRORED with an oracle prefix, the rest stay equal."""
    cfg, engine, oracle = setup.cfg, setup.engine, setup.oracle
    reqs = [Request(req_id=i, tokens=np.random.default_rng(i).integers(
        0, cfg.vocab, (12,)), max_new_tokens=8) for i in range(3)]
    set_injector(FaultInjector([FaultSpec("kernel.nan_row", at=(1,))],
                               seed=1))
    sched = ContinuousScheduler(
        engine, SchedConfig(slots=3, chunk_widths=(8, 16), spec_width=3),
        drafter=NgramDrafter())
    results = sched.run(reqs)
    set_injector(None)
    errored = [r for r in results if r.finish_reason == "errored"]
    assert len(errored) == 1 and len(results) == len(reqs)
    for r in results:
        want = _oracle_tokens(oracle, reqs[r.req_id])
        assert r.tokens == (want[:len(r.tokens)] if r in errored else want)


def test_spec_config_validation(setup):
    engine = setup.engine
    with pytest.raises(ValueError, match="greedy"):
        ContinuousScheduler(
            engine, SchedConfig(slots=2, temperature=0.7, spec_width=4),
            drafter=NgramDrafter())
    with pytest.raises(ValueError, match="spec_width"):
        ContinuousScheduler(
            engine, SchedConfig(slots=2), drafter=NgramDrafter())
    with pytest.raises(ValueError, match="cache positions"):
        # lookahead headroom: prompt + budget alone fit, + window not
        engine.validate_capacity(CACHE - 12, 12, lookahead=3)
    sched = ContinuousScheduler(
        engine, SchedConfig(slots=2, spec_width=4), drafter=NgramDrafter())
    with pytest.raises(ValueError, match="lookahead 3"):
        sched.submit(Request(req_id=0, tokens=np.ones(CACHE - 12),
                             max_new_tokens=12))


# --------------------------------------------------------------- router

def test_router_oracle_identity_and_load_spread(setup):
    cfg, engine, oracle = setup.cfg, setup.engine, setup.oracle
    rng = np.random.default_rng(6)
    reqs = [Request(req_id=i,
                    tokens=rng.integers(0, cfg.vocab,
                                        (8 + i % 7,)).astype(np.int32),
                    max_new_tokens=6, arrival_s=0.0005 * i)
            for i in range(10)]
    router = ReplicaRouter(
        engine, RouterConfig(replicas=2, sched=SchedConfig(
            slots=2, chunk_widths=(8, 16))))
    results = router.route_trace(reqs)
    _assert_oracle_identical(results, reqs, oracle)
    snap = get_registry().snapshot()
    assert snap["router.routed"] == len(reqs)
    assert snap["router.replica0.routed"] > 0      # both replicas
    assert snap["router.replica1.routed"] > 0      # carried load
    assert router.summary()["requests"] == len(reqs)
    jrouter = JReplicaRouter(setup.jengine(), JRouterConfig(
        replicas=2, sched=JSchedConfig(slots=2, chunk_widths=(8, 16))))
    assert _streams(results) == _streams(jrouter.route_trace(_jreqs(reqs)))


def test_router_fleet_zero_solver_invocations(setup, tmp_path):
    """One donor prewarm pass (enumerated, through a fresh store) covers
    the fleet: replicas 1..N-1 skip planning, yet steady-state traffic
    (chunk prefill, prefix grafts, spec verify windows through the fused
    MLP's chain plans) makes zero solver calls and zero store misses."""
    cfg = dataclasses.replace(setup.cfg, fused_mlp=True)
    model = build_model(cfg)
    store = PlanStore(tmp_path)
    engine = Engine(model, setup.params,
                    ServeConfig(max_new_tokens=10, cache_len=CACHE),
                    plan_store=store)
    hopper_mapping.plan_gemm_tiling.cache_clear()
    hopper_mapping._plan_fused_mlp.cache_clear()
    try:
        router = ReplicaRouter(
            engine, RouterConfig(replicas=3, sched=SchedConfig(
                slots=2, chunk_widths=(4, 16), spec_width=4,
                prewarm_source="enumerated")),
            arch_id=ARCH, prefix_cache=PrefixCache(16),
            drafter=NgramDrafter())
        assert router.prewarmed_plans > 0
        assert router.scheds[0].prewarmed_chains > 0 and store.puts > 0
        for s in router.scheds[1:]:
            assert s.prewarmed_plans == 0          # donor's pass reused
            assert "verify4" in s._plan_groups
            assert "verify4" in s._chain_groups
        misses0 = store.misses
        reset_solver_stats()
        reqs = _shared_prefix_requests(cfg, n=8, prefix_len=16,
                                       max_new=5, seed=7)
        results = router.route_trace(reqs)
        assert solver_stats()["calls"] == 0        # fleet-wide cert
        assert store.misses == misses0
        _assert_oracle_identical(results, reqs, setup.oracle)
        assert get_registry().get("prefix.hits") > 0
    finally:
        engine.plan_store = None
        hopper_mapping.set_plan_store(None)


def test_replica_down_failover_keeps_fidelity(setup):
    """Killing a replica mid-trace: its queued / in-flight-prefill
    requests fail over and finish oracle-identically on survivors; its
    decode slots are evicted as ERRORED keeping their streamed prefix."""
    cfg, engine, oracle = setup.cfg, setup.engine, setup.oracle
    rng = np.random.default_rng(0)
    reqs = [Request(req_id=i, tokens=rng.integers(
        0, cfg.vocab, (int(rng.integers(6, 20)),)).astype(np.int32),
        max_new_tokens=8, arrival_s=0.0005 * i) for i in range(8)]
    set_injector(FaultInjector(
        [FaultSpec("router.replica_down", at=(6,))], seed=0))
    router = ReplicaRouter(
        engine, RouterConfig(replicas=2, sched=SchedConfig(
            slots=2, chunk_widths=(8, 32))))
    results = router.route_trace(reqs)
    set_injector(None)
    assert sum(router.alive) == 1
    assert len(results) == len(reqs)
    for r in results:
        want = _oracle_tokens(oracle, reqs[r.req_id])
        assert r.tokens == (want[:len(r.tokens)]
                            if r.finish_reason == "errored" else want)
    snap = get_registry().snapshot()
    assert snap["faults.injected.router.replica_down"] == 1
    assert snap["router.replica_downs"] == 1
    assert snap.get("sched.evacuated", 0) + \
        snap.get("errors.sched.replica_down", 0) > 0


def test_replica_down_last_replica_survives(setup):
    cfg, engine, oracle = setup.cfg, setup.engine, setup.oracle
    rng = np.random.default_rng(3)
    reqs = [Request(req_id=i, tokens=rng.integers(
        0, cfg.vocab, (10,)).astype(np.int32), max_new_tokens=4)
        for i in range(3)]
    set_injector(FaultInjector(
        [FaultSpec("router.replica_down", prob=1.0)], seed=0))
    router = ReplicaRouter(
        engine, RouterConfig(replicas=2, sched=SchedConfig(
            slots=2, chunk_widths=(8, 32))))
    results = router.route_trace(reqs)
    set_injector(None)
    assert sum(router.alive) == 1           # exactly one kill honored
    for r in results:
        if not r.shed:
            assert r.tokens == _oracle_tokens(oracle, reqs[r.req_id])
    assert get_registry().snapshot()["router.replica_downs"] == 1


def test_unsupported_family_error_and_static_fallback():
    cfg = get_config("rwkv6-7b", smoke=True)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    engine = Engine(model, params, ServeConfig(max_new_tokens=5,
                                               cache_len=64))
    with pytest.raises(ValueError) as ei:
        ensure_supported_family(model.cfg)
    assert str(SUPPORTED_FAMILIES) in str(ei.value)
    with pytest.raises(ValueError, match="continuous batching supports"):
        ContinuousScheduler(engine, SchedConfig(slots=2))
    router = ReplicaRouter(engine, RouterConfig(replicas=2))
    assert router.static_reason is not None
    rng = np.random.default_rng(0)
    reqs = [Request(req_id=i,
                    tokens=rng.integers(0, cfg.vocab,
                                        (10,)).astype(np.int32),
                    max_new_tokens=5, arrival_s=0.001 * i)
            for i in range(3)]
    results = router.route_trace(reqs)
    assert len(results) == len(reqs)
    assert all(len(r.tokens) == 5 and r.finish_reason == "length"
               for r in results)
    assert "static_fallback" in router.summary()
    assert get_registry().get("router.static_fallback") == 1


def test_moe_behind_the_router_with_spec_and_prefix():
    """The MoE family serves behind the router with a prefix cache and
    spec decoding, every stream equal to its static oracle."""
    cfg = get_config("deepseek-moe-16b", smoke=True)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    engine = Engine(model, params, ServeConfig(cache_len=CACHE))
    oracle = Engine(model, params, ServeConfig(cache_len=CACHE))
    reqs = shared_prefix_trace(TrafficConfig(
        n_requests=5, arrival_rate=50.0, prompt_mix=((3, 12, 1.0),),
        max_new_tokens=6, vocab=cfg.vocab, seed=2), prefix_len=16)
    router = ReplicaRouter(
        engine, RouterConfig(replicas=2, sched=SchedConfig(
            slots=2, chunk_widths=(8, 16), spec_width=3)),
        prefix_cache=PrefixCache(16), drafter=NgramDrafter())
    _assert_oracle_identical(router.route_trace(reqs), reqs, oracle)
    assert get_registry().get("prefix.hits") > 0


# ---------------------------------------------------------- SLO metrics

def _result(req_id, *, arrival=0.0, first=0.1, finish=1.0, n=10,
            reason="length"):
    return RequestResult(
        req_id=req_id, tokens=list(range(n)), finish_reason=reason,
        prompt_len=8, arrival_s=arrival, first_token_s=first,
        finish_s=finish)


def test_slo_attainment_and_goodput():
    m = ServingMetrics(ttft_slo_s=0.5, tpot_slo_s=0.2)
    m.started_s, m.finished_s = 0.0, 2.0
    m.record_result(_result(0, first=0.1, finish=1.0, n=10))   # attains
    m.record_result(_result(1, first=0.9, finish=1.5, n=10))   # ttft miss
    m.record_result(_result(2, first=0.2, finish=3.0, n=10))   # tpot miss
    s = m.summary()
    assert s["slo_attainment"] == pytest.approx(1 / 3, abs=1e-4)
    assert s["goodput_tokens_per_s"] == pytest.approx(10 / 2.0)
    assert s["tokens_per_s"] == pytest.approx(30 / 2.0)


def test_slo_nan_and_empty_are_safe():
    m = ServingMetrics(ttft_slo_s=0.5)
    m.started_s, m.finished_s = 0.0, 1.0
    m.record_result(_result(0, first=float("nan"), n=0,
                            reason="rejected"))
    s = m.summary()
    assert s["slo_attainment"] == 0.0
    assert s["goodput_tokens_per_s"] == 0.0
    assert "slo_attainment" not in ServingMetrics().summary()


def test_merged_metrics_use_makespan():
    a = ServingMetrics()
    a.started_s, a.finished_s = 0.0, 2.0
    a.record_result(_result(0, n=4))
    b = ServingMetrics()
    b.started_s, b.finished_s = 0.0, 5.0
    b.record_result(_result(1, n=6))
    m = ServingMetrics.merged([a, b])
    assert m.elapsed_s == pytest.approx(5.0)       # slowest part
    assert m.total_generated == 10
    m2 = ServingMetrics.merged([a, b], elapsed_s=7.0)
    assert m2.elapsed_s == pytest.approx(7.0)
