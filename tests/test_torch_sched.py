"""The port's continuous-batching scheduler against the reference on the
llama3-8b smoke config (fp32), with the fused MLP on and off: the same
weights (the reference's init_params moved over with params_from_jax),
slot-indexed decode logits within 1e-4, token streams equal to the JAX
scheduler's and to the port's static oracle, and the scheduler's own
contracts (zero steady-state solves, fault isolation, sampling streams,
the capture prewarm source, refusals).  The plan store's scheduler tests
are in test_torch_store.py."""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro.serving.engine import _insert_row as jinsert_row
from repro.serving.sched import ContinuousScheduler as JScheduler
from repro.serving.sched import SchedConfig as JSchedConfig
from repro.serving.sched import TraceClock as JTraceClock
from repro.serving.sched import replay as jreplay
from repro_torch.configs import get_config
from repro_torch.core import hopper_mapping
from repro_torch.core.solver import reset_solver_stats, solver_stats
from repro_torch.faults import FaultInjector, FaultSpec, set_injector
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.obs.registry import get_registry
from repro_torch.serving import Engine, ServeConfig
from repro_torch.serving.sched import (ContinuousScheduler, Request,
                                       SchedConfig, TraceClock,
                                       TrafficConfig, poisson_trace, replay)
from repro_torch.serving.sched.scheduler import UNPORTED

LOGIT_TOL = 1e-4
CACHE = 96
SCHED = dict(slots=3, chunk_widths=(4, 16))


@pytest.fixture(autouse=True)
def _port_observability():
    """The port keeps its own counter registry and fault injector: zero
    and clear them around every test, as conftest does the reference's."""
    get_registry().reset()
    set_injector(None)
    yield
    get_registry().reset()
    set_injector(None)


@pytest.fixture(scope="module", params=[False, True],
                ids=["unfused", "fused"])
def pair(request):
    """(jax model, jax params, port model, port params) for llama3-8b
    smoke with fused_mlp on or off."""
    fused = request.param
    jcfg = dataclasses.replace(jget_config("llama3-8b", smoke=True),
                               fused_mlp=fused)
    tcfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                               fused_mlp=fused)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = build_model(tcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jmodel, jparams, tmodel, tparams


def _engine(pair, **kw):
    _, _, tmodel, tparams = pair
    return Engine(tmodel, tparams, ServeConfig(
        **{"max_new_tokens": 12, "cache_len": CACHE, **kw}))


def _oracle_tokens(oracle: Engine, req: Request) -> list[int]:
    """The request alone through the port's static Engine.generate,
    trimmed to the delivered sequence (up to its first stop token)."""
    oracle.cfg.max_new_tokens = req.max_new_tokens
    oracle.cfg.stop_token = req.stop_token
    out = []
    for t in oracle.generate(req.tokens[None])[0][:req.max_new_tokens]:
        out.append(int(t))
        if req.stop_token is not None and int(t) == req.stop_token:
            break
    return out


def _streams(results) -> dict:
    return {r.req_id: (r.tokens, r.finish_reason) for r in results}


def _trace(vocab: int, n: int = 8) -> list[Request]:
    """A Poisson trace with mixed prompt lengths and token budgets."""
    return poisson_trace(TrafficConfig(
        n_requests=n, arrival_rate=30.0,
        prompt_mix=((3, 10, 0.6), (11, 40, 0.4)), max_new_range=(3, 10),
        vocab=vocab, seed=5))


def _smoke_trace(vocab: int, stop: int = 7) -> list[Request]:
    """benchmarks/bench_serving.py's smoke trace: 8 staggered requests,
    prompts of 3-23 tokens, 12 new tokens, stop token 7."""
    rng = np.random.default_rng(0)
    return [Request(req_id=i,
                    tokens=rng.integers(0, vocab, (int(rng.integers(3, 24)),)),
                    max_new_tokens=12, arrival_s=0.05 * i, stop_token=stop)
            for i in range(8)]


def _at_once(vocab: int, n: int = 4) -> list[Request]:
    """n requests of 12-token prompts and 6 new tokens, all arriving at 0."""
    return [Request(req_id=i, tokens=np.random.default_rng(i).integers(
        0, vocab, (12,)), max_new_tokens=6) for i in range(n)]


def _replay(engine, reqs, **cfg):
    clock = TraceClock()
    sched = ContinuousScheduler(engine, SchedConfig(**{**SCHED, **cfg}),
                                clock=clock.now)
    return sched, replay(sched, reqs, clock)


# ------------------------------------------------- slot-indexed decode

@pytest.mark.parametrize("S", [1, 3])
def test_decode_step_per_row_positions(pair, S):
    """decode_step with a (B,) index against the reference's: staggered
    positions, the last one past the end of the cache (a freed slot's
    stale position), so the reference clamps its write and the port must
    clamp the same way.  Logits within 1e-4, caches equal after."""
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    rng = np.random.default_rng(S)
    B = 4
    jcache = jmodel.init_cache(B, CACHE)
    kv = {k: (rng.standard_normal(jcache["layers"][k].shape) * 0.5
              ).astype(np.float32) for k in ("k", "v")}
    jcache = {"layers": {k: jnp.asarray(v) for k, v in kv.items()}}
    tcache = {"layers": {k: torch.from_numpy(v.copy())
                         for k, v in kv.items()}}
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    index = np.array([0, 5, 40, CACHE - 1], np.int32)
    jlog, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tokens),
                                      jnp.asarray(index))
    with torch.inference_mode():
        tlog, tcache = tmodel.decode_step(
            tparams, tcache, torch.from_numpy(tokens).long(),
            torch.from_numpy(index).long())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache["layers"][k].numpy(),
                                   np.asarray(jcache["layers"][k]),
                                   rtol=1e-5, atol=1e-5)


def test_insert_row_matches_reference(pair):
    jmodel, _, tmodel, tparams = pair
    rng = np.random.default_rng(0)
    shape = jmodel.init_cache(3, CACHE)["layers"]["k"].shape
    big = {k: rng.standard_normal(shape).astype(np.float32)
           for k in ("k", "v")}
    small = {k: rng.standard_normal(shape[:1] + (1,) + shape[2:]
                                    ).astype(np.float32) for k in ("k", "v")}
    want = jinsert_row({"layers": {k: jnp.asarray(v)
                                   for k, v in big.items()}},
                       {"layers": {k: jnp.asarray(v)
                                   for k, v in small.items()}},
                       jnp.asarray(1, jnp.int32))
    eng = Engine(tmodel, tparams, ServeConfig(cache_len=CACHE))
    got = eng.insert_row(
        {"layers": {k: torch.from_numpy(v.copy()) for k, v in big.items()}},
        {"layers": {k: torch.from_numpy(v) for k, v in small.items()}}, 1)
    for k in ("k", "v"):
        np.testing.assert_array_equal(got["layers"][k].numpy(),
                                      np.asarray(want["layers"][k]))


# ------------------------------------------- streams against the oracles

def test_streams_equal_the_jax_scheduler(pair):
    """ROADMAP A6's gate 2: the same Poisson trace through the JAX
    scheduler and the port's gives the same token streams."""
    jmodel, jparams, _, _ = pair
    reqs = _trace(jmodel.cfg.vocab)
    jclock = JTraceClock()
    jsched = JScheduler(
        JEngine(jmodel, jparams, JServeConfig(cache_len=CACHE)),
        JSchedConfig(**SCHED), clock=jclock.now)
    want = _streams(jreplay(jsched, reqs, jclock))
    _, got = _replay(_engine(pair), reqs)
    assert _streams(got) == want
    assert len(want) == len(reqs)


def test_bench_serving_smoke_trace_equals_static_oracle(pair):
    """ROADMAP A6's gate 1: bench_serving's smoke trace, 8/8 requests
    token-identical to the port's static Engine.generate, with slots
    recycled and prompts chunked."""
    reqs = _smoke_trace(pair[2].cfg.vocab)
    sched, results = _replay(_engine(pair), reqs, stop_token=7)
    oracle = _engine(pair)
    got = _streams(results)
    assert sorted(got) == [r.req_id for r in reqs]
    for req in reqs:
        tokens, reason = got[req.req_id]
        assert tokens == _oracle_tokens(oracle, req), req.req_id
        assert (tokens[-1] == 7) if reason == "stop" else \
            (reason == "length" and len(tokens) == 12)
    assert sched.metrics.prefill_chunks >= len(reqs)
    assert sched.metrics.summary()["mean_slot_occupancy"] > 0


def test_second_replay_makes_no_solver_calls(pair):
    """Plans are memoized in process: a replay with the same buckets
    after a first one makes zero solver calls, and the first one, from
    cold plan caches, made some where the MLPs are planned (fused)."""
    hopper_mapping.plan_gemm_tiling.cache_clear()
    hopper_mapping._plan_fused_mlp.cache_clear()
    reqs = _trace(pair[2].cfg.vocab, n=4)
    reset_solver_stats()
    _replay(_engine(pair), reqs)
    assert (solver_stats()["calls"] > 0) == pair[2].cfg.fused_mlp
    reset_solver_stats()
    _, results = _replay(_engine(pair), reqs)
    assert solver_stats()["calls"] == 0
    assert len(results) == len(reqs)


def test_streaming_callbacks_and_metrics(pair):
    reqs = _trace(pair[2].cfg.vocab, n=3)
    streamed = collections.defaultdict(list)
    finished = []
    clock = TraceClock()
    sched = ContinuousScheduler(
        _engine(pair), SchedConfig(**SCHED), clock=clock.now,
        on_token=lambda req, tok: streamed[req.req_id].append(tok),
        on_finish=finished.append)
    results = replay(sched, reqs, clock)
    for res in results:
        assert streamed[res.req_id] == res.tokens
        assert 0 < res.ttft_s and res.first_token_s <= res.finish_s
    assert {f.req_id for f in finished} == {r.req_id for r in reqs}
    summ = sched.metrics.summary()
    assert summ["total_generated_tokens"] == sum(r.max_new_tokens
                                                 for r in reqs)
    snap = get_registry().snapshot()
    assert snap["sched.tokens"] == summ["total_generated_tokens"]
    assert snap["sched.decode_steps"] == summ["decode_steps"]


# ------------------------------------------------------- fault isolation

@pytest.mark.parametrize("value", [float("nan"), float("inf")])
def test_poisoned_row_evicts_only_that_request(pair, value):
    """kernel.nan_row poisons one active row of a decode: that request
    ends ERRORED with its oracle prefix, the others stay oracle-identical."""
    reqs = _at_once(pair[2].cfg.vocab)
    set_injector(FaultInjector([FaultSpec(
        "kernel.nan_row", at=(2,), payload={"value": value})], seed=1))
    sched = ContinuousScheduler(_engine(pair), SchedConfig(slots=2,
                                                           chunk_widths=(8,
                                                                         32)))
    results = sched.run(reqs)
    set_injector(None)
    oracle = _engine(pair)
    errored = [r.req_id for r in results if r.finish_reason == "errored"]
    assert len(errored) == 1 and len(results) == len(reqs)
    for r in results:
        want = _oracle_tokens(oracle, reqs[r.req_id])
        assert r.tokens == (want[:len(r.tokens)] if r.req_id in errored
                            else want)
    snap = get_registry().snapshot()
    assert snap["errors.sched.nan_row"] == 1
    assert snap["sched.errored"] == 1


def test_shed_expired_and_evacuated_requests_get_terminal_states(pair):
    reqs = _at_once(pair[2].cfg.vocab)
    sched = ContinuousScheduler(_engine(pair), SchedConfig(
        slots=2, chunk_widths=(8, 32), max_queue=1, shed_on_full=True,
        default_deadline_s=0.0))
    shed = [sched.submit(r) for r in reqs]
    assert sum(r is not None and r.finish_reason == "rejected"
               for r in shed) == 3
    sched.run()
    reasons = [r.finish_reason for r in sched.results]
    assert sorted(reasons) == ["expired", "rejected", "rejected",
                               "rejected"]
    # a replica-failure drain: queued and prefilling requests come back,
    # decoding ones end ERRORED with the tokens they streamed
    sched = ContinuousScheduler(_engine(pair), SchedConfig(**SCHED))
    for r in reqs:
        sched.submit(r)
    for _ in range(6):
        sched.step()
    decoding = sched.slots.n_busy - (sched._prefill is not None)
    back = sched.evacuate()
    assert not sched.busy and decoding > 0
    assert len(back) + len(sched.results) == len(reqs)
    assert sum(r.finish_reason == "errored" for r in sched.results) == \
        decoding


# --------------------------------------------------------------- sampling

def test_temperature_streams_do_not_depend_on_co_scheduled_requests(pair):
    """Each (request, token) draws from its own generator: a request's
    sampled stream is the same alone and beside others."""
    reqs = _trace(pair[2].cfg.vocab, n=5)
    _, alone = _replay(_engine(pair), reqs[2:3], temperature=1.0,
                       rng_seed=3)
    _, together = _replay(_engine(pair), reqs, temperature=1.0, rng_seed=3)
    assert _streams(alone)[2] == _streams(together)[2]
    _, reseeded = _replay(_engine(pair), reqs[2:3], temperature=1.0,
                          rng_seed=4)
    assert _streams(reseeded)[2] != _streams(alone)[2]


def _chi2_pvalue(draws: np.ndarray, p: np.ndarray) -> float:
    """Pearson's chi-square test of draws against p: each token expected
    at least 5 times is a bin of its own, the rest are pooled."""
    n = len(draws)
    own = np.flatnonzero(n * p >= 5)
    counts = np.bincount(draws, minlength=len(p))[own]
    obs = np.append(counts, n - counts.sum())
    exp = np.append(n * p[own], n * (1.0 - p[own].sum()))
    return float(scipy.stats.chisquare(obs, exp).pvalue)


def test_temperature_first_tokens_follow_the_oracle_distribution(pair):
    """The scheduler's first tokens over many requests of one prompt, and
    the static oracle's over a batch of it, both follow softmax(logits /
    T) by a chi-square test over all tokens; the same test rejects both
    against the distribution at another temperature and against uniform
    draws.  T = 0.3 peaks the smoke model's logits (top p about 0.44)."""
    _, _, tmodel, tparams = pair
    n, temp = 1000, 0.3
    prompt = np.arange(1, 6, dtype=np.int32)
    reqs = [Request(req_id=i, tokens=prompt, max_new_tokens=1)
            for i in range(n)]
    sched = ContinuousScheduler(_engine(pair), SchedConfig(
        slots=4, chunk_widths=(8,), temperature=temp))
    first = np.array([r.tokens[0] for r in sched.run(reqs)])
    oracle = Engine(tmodel, tparams, ServeConfig(
        max_new_tokens=1, cache_len=CACHE, temperature=temp))
    static = oracle.generate(np.tile(prompt, (n, 1)),
                             rng=torch.Generator().manual_seed(0))[:, 0]
    with torch.inference_mode():
        logits, _ = tmodel.prefill(
            tparams, {"tokens": torch.from_numpy(prompt)[None].long()},
            max_len=CACHE)

    def dist(t):
        return torch.softmax(logits[0, -1].double() / t, -1).numpy()

    uniform = np.random.default_rng(0).integers(0, len(dist(temp)), n)
    assert _chi2_pvalue(uniform, dist(temp)) < 1e-6
    for draws in (first, np.asarray(static)):
        assert _chi2_pvalue(draws, dist(temp)) > 1e-3
        for other in (0.5 * temp, 1.5 * temp):
            assert _chi2_pvalue(draws, dist(other)) < 1e-6, other


# --------------------------------------------------------------- refusals

def test_recurrent_families_are_refused():
    cfg = get_config("rwkv6-7b", smoke=True)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    engine = Engine(model, params, ServeConfig(cache_len=32))
    with pytest.raises(ValueError, match="continuous batching supports"):
        ContinuousScheduler(engine, SchedConfig(slots=2))
    with pytest.raises(ValueError, match="per-row positions"):
        engine.decode_slots(engine.new_cache(2), np.zeros((2, 1), np.int64),
                            np.zeros(2, np.int64))


def test_capacity_validation(pair):
    engine = _engine(pair)
    sched = ContinuousScheduler(engine, SchedConfig(**SCHED, max_queue=1))
    with pytest.raises(ValueError, match="cache_len"):
        sched.submit(Request(req_id=0, tokens=np.ones(90),
                             max_new_tokens=10))
    sched.submit(Request(req_id=2, tokens=np.ones(4), max_new_tokens=2))
    with pytest.raises(RuntimeError, match="queue full"):
        sched.submit(Request(req_id=3, tokens=np.ones(4), max_new_tokens=2))
    assert [r.req_id for r in sched.run()] == [2]


def test_capture_prewarm_source_is_taken(pair, tmp_path):
    """The reference's default prewarm source, program capture, is taken:
    with a plan store and no arch_id the scheduler reads its GEMM groups
    off the engine model's own traced programs (one per chunk width and
    the slot-batched decode, at the smoke config's widths), puts them in
    the store, and serves the trace with the streams of the JAX
    scheduler and no solver call after the prewarm."""
    from repro_torch.capture import captured_serving_plan_shape_groups
    from repro_torch.planner import PlanStore
    jmodel, jparams, tmodel, _ = pair
    reqs = _trace(tmodel.cfg.vocab)
    store = PlanStore(tmp_path)
    engine = _engine(pair)
    engine.plan_store = store
    clock = TraceClock()
    try:
        sched = ContinuousScheduler(engine, SchedConfig(**SCHED),
                                    clock=clock.now)
        want_groups = captured_serving_plan_shape_groups(
            tmodel, slots=SCHED["slots"], chunk_widths=SCHED["chunk_widths"],
            cache_len=CACHE)
        assert sched._plan_groups == want_groups
        assert sched.prewarmed_plans == len(
            {s for g in want_groups.values() for s in g}) > 0
        assert len(store) > 0     # shapes padding alike share a key
        reset_solver_stats()
        got = _streams(replay(sched, reqs, clock))
        assert solver_stats()["calls"] == 0
    finally:
        hopper_mapping.set_plan_store(None)
    jclock = JTraceClock()
    jsched = JScheduler(JEngine(jmodel, jparams, JServeConfig(
        max_new_tokens=12, cache_len=CACHE)), JSchedConfig(**SCHED),
        clock=jclock.now)
    assert got == _streams(jreplay(jsched, reqs, jclock))


def test_lifted_settings_are_taken(pair):
    """The scale-out settings that the scheduler refused before the router
    was ported are taken now: a window width without a drafter (decode
    stays width 1), a prefix cache, a drafter, and the router's shared
    plan groups, which a replica takes as they are, without a prewarm;
    no setting is refused any more."""
    from repro_torch.serving.router import NgramDrafter, PrefixCache
    engine = _engine(pair)
    for cfg_kw, kw in (({"spec_width": 4}, {}),
                       ({}, {"prefix_cache": PrefixCache(16)}),
                       ({"spec_width": 2}, {"drafter": NgramDrafter()}),
                       ({}, {"plan_groups": {"decode": [(3, 64, 64)]},
                             "chain_groups": {}})):
        sched = ContinuousScheduler(engine, SchedConfig(**SCHED, **cfg_kw),
                                    **kw)
        assert sched.prewarmed_plans == 0
    assert sched._plan_groups == {"decode": [(3, 64, 64)]}
    assert UNPORTED == ()
