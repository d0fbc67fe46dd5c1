"""The port's dense model and engine against the reference on the
llama3-8b smoke config, with the fused MLP on and off: the same weights
(the reference's init_params moved over with params_from_jax), logits
within 1e-4 and identical greedy tokens."""
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
from repro_torch.configs import get_config
from repro_torch.kernels.goma_fused import goma_fused_matmul
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import Engine, ServeConfig

LOGIT_TOL = 1e-4
B, S, NEW, CACHE = 4, 16, 6, 32


@pytest.fixture(scope="module", params=[False, True],
                ids=["unfused", "fused"])
def pair(request):
    """(jax cfg, jax model, jax params, port cfg, port model, port params)
    for llama3-8b smoke with fused_mlp on or off."""
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
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams


def _prompts(vocab, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_configs_are_copies(smoke):
    from repro.configs import ARCHS as JARCHS
    from repro_torch.configs import ARCHS
    assert sorted(ARCHS) == sorted(JARCHS)
    for name in ARCHS:
        assert dataclasses.asdict(get_config(name, smoke=smoke)) == \
            dataclasses.asdict(jget_config(name, smoke=smoke))


def test_prefill_and_decode_logits(pair):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair
    prompts = _prompts(jcfg.vocab)
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompts)},
                                  max_len=CACHE)
    with torch.inference_mode():
        tlog, tcache = tmodel.prefill(
            tparams, {"tokens": torch.from_numpy(prompts).long()},
            max_len=CACHE)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    nxt = np.argmax(np.asarray(jlog)[:, -1], axis=-1).astype(np.int32)
    for step in range(2):
        jlog, jcache = jmodel.decode_step(jparams, jcache,
                                          jnp.asarray(nxt[:, None]), S + step)
        with torch.inference_mode():
            tlog, tcache = tmodel.decode_step(
                tparams, tcache, torch.from_numpy(nxt[:, None]).long(),
                S + step)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        nxt = np.argmax(np.asarray(jlog)[:, -1], axis=-1).astype(np.int32)


def test_generate_greedy_tokens_identical(pair):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair
    prompts = _prompts(jcfg.vocab, seed=1)
    want = JEngine(jmodel, jparams, JServeConfig(
        max_new_tokens=NEW, cache_len=CACHE)).generate(prompts)
    launches = goma_fused_matmul.launches
    got = Engine(tmodel, tparams, ServeConfig(
        max_new_tokens=NEW, cache_len=CACHE)).generate(prompts)
    assert got.dtype == np.int32 and got.shape == (B, NEW)
    np.testing.assert_array_equal(got, want)
    # the CPU run takes the plain versions: no kernel launches
    assert goma_fused_matmul.launches == launches


def test_chunked_prefill_matches_prefill(pair):
    """prefill_chunk over the prompt in two chunks gives the last-token
    logits of one prefill."""
    _, _, _, tcfg, tmodel, tparams = pair
    prompts = _prompts(tcfg.vocab, seed=2)
    eng = Engine(tmodel, tparams, ServeConfig(cache_len=CACHE))
    with torch.inference_mode():
        want, _ = tmodel.prefill(
            tparams, {"tokens": torch.from_numpy(prompts).long()},
            max_len=CACHE)
        cache = eng.new_cache(B)
        _, cache = eng.prefill_chunk(cache, prompts[:, :10], 0)
        got, _ = eng.prefill_chunk(cache, prompts[:, 10:], 10)
    np.testing.assert_allclose(got[:, -1:].numpy(), want.numpy(),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_stop_token_and_capacity(pair):
    _, _, _, tcfg, tmodel, tparams = pair
    prompts = _prompts(tcfg.vocab, seed=3)
    free = Engine(tmodel, tparams, ServeConfig(
        max_new_tokens=NEW, cache_len=CACHE)).generate(prompts)
    stop = int(free[0, 1])
    out = Engine(tmodel, tparams, ServeConfig(
        max_new_tokens=NEW, cache_len=CACHE, stop_token=stop)
    ).generate(prompts)
    # every row is cut at its first stop token and padded with it
    for row, ref in zip(out, free):
        hit = np.flatnonzero(ref == stop)
        if hit.size:
            assert (row[:hit[0] + 1] == ref[:hit[0] + 1]).all()
            assert (row[hit[0]:] == stop).all() or (row[hit[0] + 1:] == 0
                                                    ).any()
    with pytest.raises(ValueError):
        Engine(tmodel, tparams, ServeConfig(
            max_new_tokens=CACHE, cache_len=CACHE)).generate(prompts)


def test_temperature_sampling_distribution():
    """Gumbel-max sampling with a torch.Generator draws each token with
    its softmax probability (held by distribution, not by bits)."""
    from repro_torch.serving.engine import gumbel_argmax
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.2]])).repeat(20000, 1)
    gen = torch.Generator().manual_seed(0)
    draws = gumbel_argmax(logits, 1.0, gen)
    freq = torch.bincount(draws.long(), minlength=3).double() / len(draws)
    np.testing.assert_allclose(freq.numpy(), [0.5, 0.3, 0.2], atol=0.02)


def test_init_params_layout_matches_reference():
    cfg = get_config("llama3-8b", smoke=True)
    tparams = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                           "cpu")
    jparams = jbuild_model(jget_config("llama3-8b", smoke=True)
                           ).init_params(jax.random.PRNGKey(0))
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    tshapes = jax.tree.map(lambda t: tuple(t.shape), tparams)
    assert tshapes == jshapes
