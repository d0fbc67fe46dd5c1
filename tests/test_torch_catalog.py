"""The rest of the model catalog in the port against the reference, on
the smoke configs in fp32: gemma2-27b (sliding windows on alternate
layers, attention and logit softcaps, the scaled embedding), the VLM
llava-next-34b (a prefix of patch embeddings) and the encoder-decoder
seamless-m4t-medium (frame embeddings, cross-attention), each with the
reference's init_params moved over with params_from_jax and the frontend
inputs made with numpy from a seed: prefill and decode_step logits within
1e-4, identical greedy tokens from Engine.generate, the fused MLP on and
off, and gemma2 behind the continuous scheduler, streams equal to the
JAX scheduler's."""
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
from repro.serving.sched import ContinuousScheduler as JScheduler
from repro.serving.sched import SchedConfig as JSchedConfig
from repro.serving.sched import TraceClock as JTraceClock
from repro.serving.sched import replay as jreplay
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.goma_fused import goma_fused_matmul
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import Engine, ServeConfig
from repro_torch.serving.sched import (ContinuousScheduler, SchedConfig,
                                       TraceClock, TrafficConfig,
                                       poisson_trace, replay)

LOGIT_TOL = 1e-4
B, NEW = 2, 5
# gemma2's prompt runs past its smoke window of 8, and its cache past one
# key block of 512 (three blocks, the last one padded)
PROMPT = {"gemma2-27b": 24, "llava-next-34b": 10, "seamless-m4t-medium": 10}
CACHE = {"gemma2-27b": 1100, "llava-next-34b": 40,
         "seamless-m4t-medium": 40}
PAIRS = [("gemma2-27b", False), ("gemma2-27b", True),
         ("llava-next-34b", False), ("llava-next-34b", True),
         ("seamless-m4t-medium", False)]


@pytest.fixture(scope="module", params=PAIRS,
                ids=[f"{a}-{'fused' if f else 'unfused'}" for a, f in PAIRS])
def pair(request):
    """(arch, jax model, jax params, port model, port params) for the
    arch's smoke config with fused_mlp on or off."""
    arch, fused = request.param
    jmodel = jbuild_model(dataclasses.replace(
        jget_config(arch, smoke=True), fused_mlp=fused))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config(arch, smoke=True), fused_mlp=fused)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return arch, jmodel, jparams, build_model(tcfg), tparams


def _inputs(cfg, seed):
    """Prompts, and the frontend's embeddings (frames or patches, std
    0.02 as the embedding's), from a seed."""
    rng = np.random.default_rng(seed)
    arch = cfg.name.removesuffix("-smoke")
    prompts = rng.integers(0, cfg.vocab, (B, PROMPT[arch])).astype(np.int32)
    extra = {}
    if cfg.family in ("vlm", "encdec"):
        key = "patches" if cfg.family == "vlm" else "frames"
        extra[key] = (0.02 * rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model))).astype(np.float32)
    return prompts, extra


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_prefill_and_decode_logits(pair):
    arch, jmodel, jparams, tmodel, tparams = pair
    prompts, extra = _inputs(tmodel.cfg, 0)
    jlog, jcache = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(prompts),
                  **{k: jnp.asarray(v) for k, v in extra.items()}},
        max_len=CACHE[arch])
    with torch.inference_mode():
        tlog, tcache = tmodel.prefill(
            tparams, {"tokens": torch.from_numpy(prompts).long(),
                      **{k: torch.from_numpy(v) for k, v in extra.items()}},
            max_len=CACHE[arch])
    _close(tlog, jlog)
    if tmodel.cfg.family == "encdec":
        _close(tcache["enc_out"], jcache["enc_out"])
    start = prompts.shape[1] + tmodel.cfg.frontend_len * (
        tmodel.cfg.family == "vlm")
    nxt = np.argmax(np.asarray(jlog)[:, -1], axis=-1).astype(np.int32)
    for step in range(3):
        jlog, jcache = jmodel.decode_step(jparams, jcache,
                                          jnp.asarray(nxt[:, None]),
                                          start + step)
        with torch.inference_mode():
            tlog, tcache = tmodel.decode_step(
                tparams, tcache, torch.from_numpy(nxt[:, None]).long(),
                start + step)
        _close(tlog, jlog)
        nxt = np.argmax(np.asarray(jlog)[:, -1], axis=-1).astype(np.int32)


def test_generate_greedy_tokens_identical(pair):
    arch, jmodel, jparams, tmodel, tparams = pair
    prompts, extra = _inputs(tmodel.cfg, 1)
    want = JEngine(jmodel, jparams, JServeConfig(
        max_new_tokens=NEW, cache_len=CACHE[arch])).generate(
        prompts, extra_batch={k: jnp.asarray(v) for k, v in extra.items()}
        or None)
    launches = goma_fused_matmul.launches
    got = Engine(tmodel, tparams, ServeConfig(
        max_new_tokens=NEW, cache_len=CACHE[arch])).generate(
        prompts, extra_batch=extra or None)
    assert got.dtype == np.int32 and got.shape == (B, NEW)
    np.testing.assert_array_equal(got, want)
    assert goma_fused_matmul.launches == launches     # plain on the CPU


def test_vlm_prefix_enters_the_capacity_check():
    """The patches' positions come before the prompt's in the cache: a
    cache that holds prompt + new tokens but not the prefix is refused,
    as the reference's engine refuses it."""
    cfg = get_config("llava-next-34b", smoke=True)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    prompts, extra = _inputs(cfg, 2)
    short = prompts.shape[1] + NEW
    with pytest.raises(ValueError, match=f"prefix {cfg.frontend_len}"):
        Engine(model, params, ServeConfig(
            max_new_tokens=NEW, cache_len=short)).generate(
            prompts, extra_batch=extra)
    out = Engine(model, params, ServeConfig(
        max_new_tokens=NEW, cache_len=short + cfg.frontend_len)).generate(
        prompts, extra_batch=extra)
    assert out.shape == (B, NEW)


def test_gemma2_logits_within_the_softcap():
    """gemma2's logits are capped at 30 (after the product, before the
    vocab mask); the same weights without the cap run past it."""
    cfg = get_config("gemma2-27b", smoke=True)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    # a head large enough that the uncapped logits pass the cap
    params["lm_head"]["w"] *= 400.0
    prompts, _ = _inputs(cfg, 3)
    toks = {"tokens": torch.from_numpy(prompts).long()}
    with torch.inference_mode():
        capped, _ = model.prefill(params, toks, max_len=32)
        uncapped, _ = build_model(dataclasses.replace(
            cfg, logit_softcap=None)).prefill(params, toks, max_len=32)
    assert float(capped.abs().max()) <= cfg.logit_softcap
    assert float(uncapped.abs().max()) > cfg.logit_softcap
    torch.testing.assert_close(
        capped, cfg.logit_softcap * torch.tanh(uncapped / cfg.logit_softcap),
        rtol=1e-6, atol=1e-5)


def test_gemma2_alternates_local_and_global_layers():
    """Even layers see the window, odd layers every earlier key: at a
    prompt past the window, dropping the alternation (every layer local)
    and dropping the window (every layer global) both change the
    logits."""
    cfg = get_config("gemma2-27b", smoke=True)
    params = build_model(cfg).init_params(torch.Generator().manual_seed(1),
                                          "cpu")
    prompts, _ = _inputs(cfg, 4)
    toks = {"tokens": torch.from_numpy(prompts).long()}
    out = {}
    for name, knobs in (("alternating", {}),
                        ("all local", dict(alt_local_global=False)),
                        ("all global", dict(window=None))):
        with torch.inference_mode():
            out[name] = build_model(dataclasses.replace(cfg, **knobs)
                                    ).prefill(params, toks, max_len=32)[0]
    assert not torch.allclose(out["alternating"], out["all local"])
    assert not torch.allclose(out["alternating"], out["all global"])


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_every_config_builds(smoke):
    """build_model takes every name in ARCHS; the parameter tree (on the
    meta device: shape-level) has the reference's layout."""
    for name in ARCHS:
        model = build_model(get_config(name, smoke=smoke))
        tree = model.init_params(torch.Generator(), "meta")
        if smoke:
            jtree = jax.eval_shape(jbuild_model(jget_config(
                name, smoke=True)).init_params, jax.random.PRNGKey(0))
            assert jax.tree.map(lambda t: tuple(t.shape), tree) == \
                jax.tree.map(lambda a: tuple(a.shape), jtree), name
        cache = model.init_cache(2, 16, device="meta")
        if model.cfg.family == "encdec":
            assert set(cache["layers"]) == {"self"}


def _gemma2_trace(vocab):
    """A Poisson trace whose longest prompts run past gemma2's smoke
    window of 8 and span several chunks."""
    return poisson_trace(TrafficConfig(
        n_requests=6, arrival_rate=30.0,
        prompt_mix=((3, 9, 0.5), (20, 40, 0.5)), max_new_range=(3, 8),
        vocab=vocab, seed=5))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_gemma2_scheduler_streams_equal_the_jax_schedulers(fused):
    """gemma2's windows per row behind the continuous scheduler: the same
    Poisson trace through the JAX scheduler and the port's gives the same
    token streams, and each equals the port's static oracle."""
    jmodel = jbuild_model(dataclasses.replace(
        jget_config("gemma2-27b", smoke=True), fused_mlp=fused))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config("gemma2-27b", smoke=True),
                               fused_mlp=fused)
    tmodel = build_model(tcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    knobs = dict(slots=3, chunk_widths=(4, 16))
    reqs = _gemma2_trace(tcfg.vocab)
    assert max(len(r.tokens) for r in reqs) > tcfg.window
    jclock = JTraceClock()
    want = {r.req_id: (r.tokens, r.finish_reason) for r in jreplay(
        JScheduler(JEngine(jmodel, jparams, JServeConfig(cache_len=64)),
                   JSchedConfig(**knobs), clock=jclock.now), reqs, jclock)}
    clock = TraceClock()
    got = {r.req_id: (r.tokens, r.finish_reason) for r in replay(
        ContinuousScheduler(Engine(tmodel, tparams, ServeConfig(
            cache_len=64)), SchedConfig(**knobs), clock=clock.now),
        reqs, clock)}
    assert got == want and len(got) == len(reqs)
    oracle = Engine(tmodel, tparams, ServeConfig(cache_len=64))
    for req in reqs:
        oracle.cfg.max_new_tokens = req.max_new_tokens
        assert got[req.req_id][0] == \
            oracle.generate(req.tokens[None])[0].tolist(), req.req_id


@pytest.mark.parametrize("arch,flags,line", [
    ("gemma2-27b", ["--fused-mlp"], "gemma2-27b-smoke on cpu"),
    ("gemma2-27b", ["--fused-mlp", "--continuous", "--requests", "3"],
     "gemma2-27b-smoke continuous on cpu: 3 requests, 9 tokens"),
    ("llava-next-34b", ["--fused-mlp"], "llava-next-34b-smoke on cpu"),
    ("seamless-m4t-medium", [], "seamless-m4t-medium-smoke on cpu")])
def test_serve_runs_the_catalog_on_cpu(arch, flags, line, capsys):
    """launch.serve takes the three archs (zero patches or frames, as the
    reference's serve supplies them), and gemma2 behind the scheduler."""
    from repro_torch.launch.serve import main
    main(["--arch", arch, "--smoke", *flags, "--batch", "2",
          "--prompt-len", "12", "--new-tokens", "3", "--device", "cpu"])
    assert line in capsys.readouterr().out
