"""The port's MoE family against the reference on the deepseek-moe-16b
and granite-moe-1b-a400m smoke configs (fp32): the same weights (the
reference's init_params moved over with params_from_jax), moe_apply with
both dispatches and its aux loss within 1e-5, model logits within 1e-4
(prefill, scalar and per-row decode), identical greedy tokens, and
scheduler streams equal to the JAX scheduler's on a Poisson trace."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro.serving.sched import ContinuousScheduler as JScheduler
from repro.serving.sched import SchedConfig as JSchedConfig
from repro.serving.sched import TraceClock as JTraceClock
from repro.serving.sched import replay as jreplay
from repro_torch.configs import get_config
from repro_torch.kernels import goma_combine, goma_fused_matmul, goma_matmul
from repro_torch.models import build_model, moe
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import index_tree
from repro_torch.serving import Engine, ServeConfig
from repro_torch.serving.sched import (ContinuousScheduler, SchedConfig,
                                       TraceClock, TrafficConfig,
                                       poisson_trace, replay)

MOE_TOL = 1e-5
LOGIT_TOL = 1e-4
B, S, NEW, CACHE = 3, 12, 6, 48
ARCHS = ["deepseek-moe-16b", "granite-moe-1b-a400m"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax model, jax params, port model, port params) for a MoE smoke
    config."""
    jcfg = jget_config(request.param, smoke=True)
    tcfg = get_config(request.param, smoke=True)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = build_model(tcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jmodel, jparams, tmodel, tparams


def _layer0(jparams, tparams):
    return (jax.tree.map(lambda a: a[0], jparams["layers"]["moe"]),
            index_tree(tparams["layers"], 0)["moe"])


@pytest.mark.parametrize("dispatch", ["dense", "gathered"])
@pytest.mark.parametrize("shape", [(2, 7), (1, 1), (4, 33)])
def test_moe_apply_matches_reference(pair, dispatch, shape):
    """One layer's MoE on the same numpy-seeded activations: y and the
    aux loss within 1e-5 of the reference's.  (4, 33) routes 132 tokens
    into a capacity of 82 per expert, so the gathered dispatch drops
    tokens, and the drops must be the reference's."""
    jmodel, jparams, tmodel, tparams = pair
    jp, tp = _layer0(jparams, tparams)
    jcfg = dataclasses.replace(jmodel.cfg, moe_dispatch=dispatch)
    tcfg = dataclasses.replace(tmodel.cfg, moe_dispatch=dispatch)
    x = np.random.default_rng(sum(shape)).standard_normal(
        shape + (tcfg.d_model,)).astype(np.float32)
    jy, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    ty, taux = moe.moe_apply(tp, tcfg, torch.from_numpy(x))
    assert ty.dtype == torch.float32 and ty.shape == x.shape
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=MOE_TOL,
                               atol=MOE_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=MOE_TOL,
                               atol=MOE_TOL)


def test_gathered_dispatch_drops_what_the_reference_drops(pair):
    """With a capacity factor small enough that most routed tokens drop,
    the gathered dispatch still equals the reference's: the same stable
    sort on expert ids keeps the same tokens."""
    jmodel, jparams, tmodel, tparams = pair
    jp, tp = _layer0(jparams, tparams)
    x = np.random.default_rng(9).standard_normal(
        (2, 16, tmodel.cfg.d_model)).astype(np.float32)
    jy, _ = jmoe.moe_apply_gathered(jp, jmodel.cfg, jnp.asarray(x),
                                    capacity_factor=0.3)
    ty, _ = moe.moe_apply_gathered(tp, tmodel.cfg, torch.from_numpy(x),
                                   capacity_factor=0.3)
    dense, _ = moe.moe_apply(tp, tmodel.cfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=MOE_TOL,
                               atol=MOE_TOL)
    assert not np.allclose(ty.numpy(), dense.numpy(), atol=1e-3)


def test_init_params_layout_and_dtypes_match_reference(pair):
    """The port's own init has the reference's tree and shapes; at a bf16
    compute dtype the banks and shared experts are stored in bf16, the
    router in fp32, and params_from_jax stores them the same way."""
    jmodel, jparams, tmodel, _ = pair
    tparams = tmodel.init_params(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), tparams) == \
        jax.tree.map(lambda a: tuple(a.shape), jparams)
    cfg16 = dataclasses.replace(tmodel.cfg, compute_dtype="bfloat16")
    for p in (build_model(cfg16).init_params(
                  torch.Generator().manual_seed(0), "cpu"),
              params_from_jax(jax.tree.map(np.asarray, jparams), cfg16,
                              device="cpu")):
        m = p["layers"]["moe"]
        assert m["router"]["w"].dtype == torch.float32
        assert {m[w].dtype for w in ("wg", "wu", "wd")} == {torch.bfloat16}
        for w in m.get("shared", {}).values():
            assert w["w"].dtype == torch.bfloat16
        assert p["layers"]["attn"]["wq"]["w"].dtype == torch.bfloat16


def test_bf16_banks_equal_the_reference_at_bf16_params(pair):
    """At bf16 compute the port's banks hold the reference's bf16
    parameters: the reference run with param_dtype bfloat16 gives the
    same layer output within 1e-5 (the products run in fp32 in both)."""
    jmodel, jparams, tmodel, _ = pair
    jcfg = dataclasses.replace(jmodel.cfg, param_dtype="bfloat16")
    jp16 = jax.tree.map(lambda a: a[0].astype(jnp.bfloat16),
                        jparams["layers"]["moe"])
    jp16["router"] = jax.tree.map(lambda a: a[0],
                                  jparams["layers"]["moe"]["router"])
    tcfg = dataclasses.replace(tmodel.cfg, compute_dtype="bfloat16")
    tp = index_tree(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")["layers"], 0)["moe"]
    x = np.random.default_rng(3).standard_normal(
        (2, 5, tcfg.d_model)).astype(np.float32)
    jy, _ = jmoe.moe_apply(jp16, jcfg, jnp.asarray(x))
    ty, _ = moe.moe_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=MOE_TOL,
                               atol=MOE_TOL)


def test_prefill_and_decode_logits(pair):
    """Prefill, two scalar-index decode steps and a per-row decode with
    staggered positions: logits within 1e-4 of the reference's."""
    jmodel, jparams, tmodel, tparams = pair
    prompts = np.random.default_rng(0).integers(
        0, tmodel.cfg.vocab, (B, S)).astype(np.int32)
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompts)},
                                  max_len=CACHE)
    with torch.inference_mode():
        tlog, tcache = tmodel.prefill(
            tparams, {"tokens": torch.from_numpy(prompts).long()},
            max_len=CACHE)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    nxt = np.argmax(np.asarray(jlog)[:, -1], -1).astype(np.int32)
    for step in range(2):
        jlog, jcache = jmodel.decode_step(
            jparams, jcache, jnp.asarray(nxt[:, None]), S + step)
        with torch.inference_mode():
            tlog, tcache = tmodel.decode_step(
                tparams, tcache, torch.from_numpy(nxt[:, None]).long(),
                S + step)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        nxt = np.argmax(np.asarray(jlog)[:, -1], -1).astype(np.int32)
    index = np.array([S + 2, 3, CACHE - 1], np.int32)
    toks = np.random.default_rng(1).integers(
        0, tmodel.cfg.vocab, (B, 2)).astype(np.int32)
    jlog, _ = jmodel.decode_step(jparams, jcache, jnp.asarray(toks),
                                 jnp.asarray(index))
    with torch.inference_mode():
        tlog, _ = tmodel.decode_step(tparams, tcache,
                                     torch.from_numpy(toks).long(),
                                     torch.from_numpy(index).long())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("dispatch", ["dense", "gathered"])
def test_generate_greedy_tokens_identical(pair, dispatch):
    """Static greedy generation: the reference's tokens, and no GOMA
    kernel on the path (the family has no dense MLP)."""
    jmodel, jparams, tmodel, tparams = pair
    jmodel = jbuild_model(dataclasses.replace(jmodel.cfg,
                                              moe_dispatch=dispatch))
    tmodel = build_model(dataclasses.replace(tmodel.cfg,
                                             moe_dispatch=dispatch))
    prompts = np.random.default_rng(2).integers(
        0, tmodel.cfg.vocab, (B, S)).astype(np.int32)
    want = JEngine(jmodel, jparams, JServeConfig(
        max_new_tokens=NEW, cache_len=CACHE)).generate(prompts)
    before = [k.launches for k in (goma_matmul, goma_fused_matmul,
                                   goma_combine)]
    got = Engine(tmodel, tparams, ServeConfig(
        max_new_tokens=NEW, cache_len=CACHE)).generate(prompts)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert [k.launches for k in (goma_matmul, goma_fused_matmul,
                                 goma_combine)] == before


def test_scheduler_streams_equal_the_jax_scheduler(pair):
    """A Poisson trace through the JAX scheduler and the port's gives the
    same token streams (dense dispatch, rows independent)."""
    jmodel, jparams, tmodel, tparams = pair
    reqs = poisson_trace(TrafficConfig(
        n_requests=6, arrival_rate=30.0,
        prompt_mix=((3, 10, 0.6), (11, 30, 0.4)), max_new_range=(3, 8),
        vocab=tmodel.cfg.vocab, seed=5))
    sched_cfg = dict(slots=3, chunk_widths=(4, 16))
    jclock = JTraceClock()
    jsched = JScheduler(JEngine(jmodel, jparams,
                                JServeConfig(cache_len=CACHE)),
                        JSchedConfig(**sched_cfg), clock=jclock.now)
    want = {r.req_id: (r.tokens, r.finish_reason)
            for r in jreplay(jsched, reqs, jclock)}
    clock = TraceClock()
    sched = ContinuousScheduler(Engine(tmodel, tparams,
                                       ServeConfig(cache_len=CACHE)),
                                SchedConfig(**sched_cfg), clock=clock.now)
    got = {r.req_id: (r.tokens, r.finish_reason)
           for r in replay(sched, reqs, clock)}
    assert got == want and len(got) == len(reqs)


def test_scheduler_refuses_gathered_dispatch(pair):
    _, _, tmodel, tparams = pair
    cfg = dataclasses.replace(tmodel.cfg, moe_dispatch="gathered")
    engine = Engine(build_model(cfg), tparams, ServeConfig(cache_len=CACHE))
    with pytest.raises(ValueError, match="gathered"):
        ContinuousScheduler(engine, SchedConfig(slots=2))


def test_moe_deployment_prewarms_through_a_store(pair, tmp_path):
    """A MoE deployment's scheduler prewarms through a plan store from the
    enumerated tables, serves the streams it serves without one, and a
    second scheduler on the store makes no put and no solver call."""
    from repro_torch.core import hopper_mapping
    from repro_torch.core.solver import reset_solver_stats, solver_stats
    from repro_torch.planner import PlanStore
    _, _, tmodel, tparams = pair
    arch = tmodel.cfg.name.removesuffix("-smoke")
    reqs = poisson_trace(TrafficConfig(
        n_requests=3, prompt_mix=((3, 12, 1.0),), max_new_tokens=4,
        vocab=tmodel.cfg.vocab, seed=1))
    sched_cfg = dict(slots=2, chunk_widths=(4, 16),
                     prewarm_source="enumerated")

    def run(store):
        sched = ContinuousScheduler(
            Engine(tmodel, tparams, ServeConfig(cache_len=CACHE),
                   plan_store=store),
            SchedConfig(**sched_cfg),
            arch_id=arch if store is not None else None)
        return sched, {r.req_id: r.tokens for r in sched.run(reqs)}

    try:
        _, want = run(None)
        sched, got = run(PlanStore(tmp_path))
        assert sched.prewarmed_plans > 0 and got == want
        store = PlanStore(tmp_path)
        hopper_mapping.set_plan_store(store)        # flushes the caches
        reset_solver_stats()
        _, again = run(store)
        assert again == want and store.puts == 0
        assert solver_stats()["calls"] == 0
    finally:
        hopper_mapping.set_plan_store(None)
