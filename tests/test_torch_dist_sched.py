"""The continuous scheduler and the replica router on a tensor-parallel
engine, on the CPU, and the scheduler's ``state_of`` against the
reference's.

One subprocess per world size (2 and 4), both started together, spawns
gloo ranks (``tests/torch_dist_ranks.py sched``) that each replay
bench_serving's smoke trace through a ``ContinuousScheduler`` on their
shard of the smoke config, in trace time from a ``RankClock``:

- streams equal one rank's scheduler's and the JAX scheduler's, for
  llama3-8b with the fused MLP on and off and for deepseek-moe-16b;
- no solver call after rank 0's prewarm, on any rank, and none in the
  other ranks' prewarm (they read rank 0's plans from the store);
- two broadcasts a tick (rank 0's tick orders, and its tick time into
  every rank's clock);
- clock skew: rank 1's scheduler clock runs far ahead, past every
  request's deadline, and its ticks sleep longer; its decisions are
  still rank 0's, so nothing expires and the streams still agree;
- seeded fault injection fires on the same tick on every rank: a
  poisoned decode row evicts the same request everywhere, as on one
  rank and in the JAX scheduler;
- the router: a ``TPReplicaRouter`` of 2 replicas at TP 2 gives the
  one-rank router's streams.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.faults import FaultInjector as JFaultInjector
from repro.faults import FaultSpec as JFaultSpec
from repro.faults import set_injector as jset_injector
from repro.models import build_model as jbuild_model
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro.serving.sched import ContinuousScheduler as JScheduler
from repro.serving.sched import SchedConfig as JSchedConfig
from repro.serving.sched import TraceClock as JTraceClock
from repro.serving.sched import replay as jreplay
from repro_torch.configs import get_config
from repro_torch.faults import FaultInjector, FaultSpec, set_injector
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.obs.registry import get_registry
from repro_torch.serving import Engine, ServeConfig
from repro_torch.serving.router import ReplicaRouter, RouterConfig
from repro_torch.serving.sched import (ContinuousScheduler, Request,
                                       SchedConfig, TraceClock, replay)
from torch_dist_ranks import run_worlds

NEW, CACHE = 12, 96
SCHED = dict(slots=3, chunk_widths=(4, 16))
WORLDS = (2, 4)
# rank 1's clock in the skew case: this far ahead of rank 0's, past
# every request's deadline (arrival + DEADLINE_S), and its ticks this
# much slower
SKEW = dict(skew_s=1000.0, slow_tick_s=0.005)
DEADLINE_S = 60.0
# (name, arch, config knobs, extra case fields, worlds)
CASES = [("llama3-8b-fused", "llama3-8b", {"fused_mlp": True}, {}, WORLDS),
         ("llama3-8b-unfused", "llama3-8b", {}, {}, WORLDS),
         ("deepseek-moe-16b", "deepseek-moe-16b", {}, {}, WORLDS),
         ("llama3-8b-skew", "llama3-8b", {"fused_mlp": True},
          dict(SKEW, deadline_s=DEADLINE_S), WORLDS),
         ("llama3-8b-nan-row", "llama3-8b", {"fused_mlp": True},
          dict(faults=(("kernel.nan_row", (3,)),)), WORLDS),
         ("llama3-8b-router", "llama3-8b", {"fused_mlp": True},
          dict(replicas=2), (2,))]


def smoke_trace(vocab: int, stop: int = 7,
                deadline_s: float | None = None) -> list[Request]:
    """benchmarks/bench_serving.py's smoke trace: 8 staggered requests,
    prompts of 3-23 tokens, 12 new tokens, stop token 7; with
    ``deadline_s``, each request's deadline that long after its
    arrival."""
    rng = np.random.default_rng(0)
    return [Request(req_id=i,
                    tokens=rng.integers(0, vocab, (int(rng.integers(3, 24)),)),
                    max_new_tokens=NEW, arrival_s=0.05 * i, stop_token=stop,
                    deadline_s=None if deadline_s is None
                    else 0.05 * i + deadline_s)
            for i in range(8)]


def _streams(results) -> dict:
    return {r.req_id: (r.tokens, r.finish_reason) for r in results}


def _pair(arch: str, knobs: dict):
    jmodel = jbuild_model(dataclasses.replace(jget_config(arch, smoke=True),
                                              **knobs))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(arch, smoke=True), **knobs)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jmodel, jparams, build_model(cfg), params


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Per case: the JAX scheduler's streams (the JAX engine behind it)
    and one rank's (a ``ReplicaRouter`` for the router case); per world
    and case, what every rank saw."""
    single, cases = {}, {w: [] for w in WORLDS}
    pairs = {}
    for name, arch, knobs, extra, worlds in CASES:
        key = (arch, tuple(sorted(knobs.items())))
        if key not in pairs:
            pairs[key] = _pair(arch, knobs)
        jmodel, jparams, model, params = pairs[key]
        trace = smoke_trace(model.cfg.vocab)
        eng = Engine(model, params, ServeConfig(max_new_tokens=NEW,
                                                cache_len=CACHE))
        faults = extra.get("faults", ())
        set_injector(FaultInjector([FaultSpec(site, at=at)
                                    for site, at in faults], seed=0))
        jset_injector(JFaultInjector([JFaultSpec(site, at=at)
                                      for site, at in faults], seed=0))
        if extra.get("replicas"):
            one = _streams(ReplicaRouter(eng, RouterConfig(
                replicas=extra["replicas"], sched=SchedConfig(**SCHED)))
                .route_trace(trace))
        else:
            clock = TraceClock()
            one = _streams(replay(ContinuousScheduler(
                eng, SchedConfig(**SCHED), clock=clock.now), trace, clock))
        jclock = JTraceClock()
        want = _streams(jreplay(JScheduler(
            JEngine(jmodel, jparams, JServeConfig(max_new_tokens=NEW,
                                                  cache_len=CACHE)),
            JSchedConfig(**SCHED), clock=jclock.now), trace, jclock))
        set_injector(None)
        jset_injector(None)
        single[name] = dict(one=one, jax=want)
        case = dict(name=name, arch=arch, knobs=knobs, params=params,
                    trace=smoke_trace(model.cfg.vocab,
                                      deadline_s=extra.get("deadline_s")),
                    new=NEW, cache=CACHE, sched=SCHED, **extra)
        for w in worlds:
            cases[w].append(case)
    roots = {}
    for world in WORLDS:
        roots[world] = tmp_path_factory.mktemp(f"sched{world}")
        torch.save(cases[world], roots[world] / "cases.pt")
    out = {}
    for world, ranks in run_worlds(roots, "sched").items():
        for i, case in enumerate(cases[world]):
            out[world, case["name"]] = dict(
                single[case["name"]], case=case,
                ranks=[r[i] for r in ranks])
    return out


SERVED = [(w, c[0]) for c in CASES for w in c[4]]
IDS = [f"tp{w}-{n}" for w, n in SERVED]


@pytest.mark.parametrize("world,name", SERVED, ids=IDS)
def test_streams_equal_one_rank_and_the_jax_scheduler(served, world,
                                                      name):
    run = served[world, name]
    assert run["one"] == run["jax"]
    assert len(run["one"]) == 8
    for r in run["ranks"]:
        assert r["name"] == name
        assert r["streams"] == run["one"]


@pytest.mark.parametrize("world,name", SERVED, ids=IDS)
def test_zero_solves_after_rank_zero_prewarm(served, world, name):
    ranks = served[world, name]["ranks"]
    assert [r["solver_calls"] for r in ranks] == [0] * world
    assert [r["prewarm_solver_calls"] for r in ranks[1:]] == \
        [0] * (world - 1)


@pytest.mark.parametrize("world,name", SERVED, ids=IDS)
def test_one_orders_and_one_clock_broadcast_a_tick(served, world, name):
    ranks = served[world, name]["ranks"]
    for r in ranks:
        assert r["ticks"] > 0
        assert r["broadcasts"] == 2 * r["ticks"]
        assert (r["ticks"], r["token_checks"], r["per_replica"]) == (
            ranks[0]["ticks"], ranks[0]["token_checks"],
            ranks[0]["per_replica"])


@pytest.mark.parametrize("world", WORLDS)
def test_a_skewed_rank_takes_rank_zero_decisions(served, world):
    """Rank 1's own clock reads past every deadline at every tick: left
    to itself it would expire each queued request that rank 0 admits.
    Its ticks take rank 0's reading, so no request expires on any rank
    and the streams stay rank 0's (and the one rank's)."""
    run = served[world, "llama3-8b-skew"]
    own = run["ranks"][1]["own_clock"]
    last_deadline = max(r.deadline_s for r in run["case"]["trace"])
    assert len(own) == run["ranks"][1]["ticks"]
    assert min(own) > last_deadline
    for r in run["ranks"]:
        assert all(reason != "expired" for _, reason in
                   r["streams"].values())
        assert r["streams"] == run["one"]


@pytest.mark.parametrize("world", WORLDS)
def test_a_fault_fires_on_the_same_tick_on_every_rank(served, world):
    """kernel.nan_row at its fourth call poisons one decode row on every
    rank at once: the same request ends ERRORED everywhere, with the same
    streamed prefix as on one rank and in the JAX scheduler."""
    run = served[world, "llama3-8b-nan-row"]
    errored = [rid for rid, (_, reason) in run["one"].items()
               if reason == "errored"]
    assert len(errored) == 1
    for r in run["ranks"]:
        assert r["streams"] == run["one"] == run["jax"]


def test_router_spreads_the_trace_over_both_replicas(served):
    ranks = served[2, "llama3-8b-router"]["ranks"]
    assert all(n > 0 for n in ranks[0]["per_replica"])
    assert sum(ranks[0]["per_replica"]) == 8


# ------------------------------------------------------------ state_of
def test_state_of_equals_the_reference_at_every_tick():
    """Four requests at once through the JAX scheduler and the port's on
    llama3-8b smoke, tick by tick: every slot's state is the same in
    both (free slots FINISHED, the in-flight prefill's PREFILLING, the
    rest ACTIVE), through prefill, decode and eviction."""
    get_registry().reset()
    jmodel, jparams, model, params = _pair("llama3-8b", {})
    # 20-token prompts take two chunks (16 + 4), two ticks of prefill
    reqs = [Request(req_id=i, tokens=np.random.default_rng(i).integers(
        0, model.cfg.vocab, (20,)), max_new_tokens=3 + i)
        for i in range(4)]
    sched = ContinuousScheduler(
        Engine(model, params, ServeConfig(cache_len=CACHE)),
        SchedConfig(**SCHED))
    jsched = JScheduler(JEngine(jmodel, jparams,
                                JServeConfig(cache_len=CACHE)),
                        JSchedConfig(**SCHED))
    for r in reqs:
        sched.submit(r)
        jsched.submit(r)
    seen = set()
    while sched.busy or jsched.busy:
        sched.step()
        jsched.step()
        got = [sched.state_of(s).value for s in sched.slots.slots]
        want = [jsched.state_of(s).value for s in jsched.slots.slots]
        assert got == want
        seen.update(got)
    assert seen == {"finished", "prefilling", "active"}
    assert _streams(sched.results) == _streams(jsched.results)
