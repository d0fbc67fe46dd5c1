"""The port's recurrent families against the reference on the rwkv6-7b and
zamba2-2.7b smoke configs, with the scan kernels' knob
(``use_pallas_scan``) on and off: the same weights (the reference's
init_params, with the bonus, decay bias, A_log, dt_bias and D perturbed
by seeded numpy noise, moved over with params_from_jax), prefill and
decode logits within 1e-4, final states within the reference's scan
tolerances (2e-3 WKV6, 1e-3 SSD), and identical greedy tokens.  A prompt
of 12 tokens against the smoke chunk of 8 gives two chunks, the second
one padded."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import rwkv as JRW
from repro.models import ssm as JSSM
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.kernels import ssd_scan, wkv6_scan
from repro_torch.models import build_model
from repro_torch.models import rwkv as RW
from repro_torch.models import ssm as SSM
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import index_tree
from repro_torch.serving import Engine, ServeConfig

LOGIT_TOL = 1e-4
STATE_TOL = {"rwkv6-7b": 2e-3, "zamba2-2.7b": 1e-3}
B, S, NEW, CACHE = 4, 12, 6, 32
ARCHS = ["rwkv6-7b", "zamba2-2.7b"]


def _perturb(tree: dict, rng) -> dict:
    """The reference's init leaves u = 0, w_bias = -6, A_log = 0,
    dt_bias = 0 and D = 1: no bonus and nearly no spread of decays.
    Draw them instead, so both are exercised."""
    draws = {"u": lambda s: rng.normal(0.0, 0.5, s),
             "w_bias": lambda s: rng.uniform(-4.0, 1.0, s),
             "A_log": lambda s: rng.normal(0.0, 0.5, s),
             "dt_bias": lambda s: rng.normal(0.0, 0.5, s),
             "D": lambda s: 1.0 + rng.normal(0.0, 0.5, s)}
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in draws:
            out[k] = draws[k](v.shape).astype(v.dtype)
        else:
            out[k] = v
    return out


def _configs(arch, scan):
    kw = dict(use_pallas_scan=scan, fused_mlp=True)
    return (dataclasses.replace(jget_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


@pytest.fixture(scope="module",
                params=[(a, s) for a in ARCHS for s in (False, True)],
                ids=[f"{a}-{k}" for a in ARCHS
                     for k in ("chunked", "scan_kernel")])
def pair(request):
    """(arch, jax model, jax params, port model, port params)."""
    arch, scan = request.param
    jcfg, tcfg = _configs(arch, scan)
    jmodel = jbuild_model(jcfg)
    numpy_tree = _perturb(
        jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0))),
        np.random.default_rng(0))
    jparams = jax.tree.map(jnp.asarray, numpy_tree)
    tmodel = build_model(tcfg)
    return (arch, jmodel, jparams, tmodel,
            params_from_jax(numpy_tree, tcfg, device="cpu"))


def _prompts(vocab, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, S)).astype(np.int32)


def test_prefill_and_decode_logits(pair):
    arch, jmodel, jparams, tmodel, tparams = pair
    prompts = _prompts(jmodel.cfg.vocab)
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompts)},
                                  max_len=CACHE)
    with torch.inference_mode():
        tlog, tcache = tmodel.prefill(
            tparams, {"tokens": torch.from_numpy(prompts).long()},
            max_len=CACHE)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # the final recurrent states at the scan tolerance; the shift and conv
    # carries and the shared block's KV caches at the logits'
    jflat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    tflat = jax.tree.leaves(tcache)
    assert [tuple(t.shape) for t in tflat] == [a.shape for _, a in jflat]
    for got, (path, want) in zip(tflat, jflat):
        tol = (STATE_TOL[arch] if "'state'" in jax.tree_util.keystr(path)
               else LOGIT_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)
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
    arch, jmodel, jparams, tmodel, tparams = pair
    prompts = _prompts(jmodel.cfg.vocab, seed=1)
    want = JEngine(jmodel, jparams, JServeConfig(
        max_new_tokens=NEW, cache_len=CACHE)).generate(prompts)
    launches = (wkv6_scan.launches, ssd_scan.launches)
    got = Engine(tmodel, tparams, ServeConfig(
        max_new_tokens=NEW, cache_len=CACHE)).generate(prompts)
    assert got.dtype == np.int32 and got.shape == (B, NEW)
    np.testing.assert_array_equal(got, want)
    # the CPU run takes the plain versions: no kernel launches
    assert (wkv6_scan.launches, ssd_scan.launches) == launches


@pytest.mark.parametrize("scan", [False, True], ids=["chunked", "kernel"])
def test_rwkv_time_apply_matches_sequential(scan):
    """The prefill form (chunked or B3's plain version) against the
    token-by-token recurrence, and the port's recurrence against the
    reference's."""
    jcfg, tcfg = _configs("rwkv6-7b", scan)
    numpy_tree = _perturb(jax.tree.map(
        np.asarray, jbuild_model(jcfg).init_params(jax.random.PRNGKey(1))),
        np.random.default_rng(1))
    tp = index_tree(params_from_jax(numpy_tree, tcfg, device="cpu")
                    ["layers"], 0)["time"]
    x = np.random.default_rng(2).standard_normal(
        (2, 13, tcfg.d_model)).astype(np.float32)
    with torch.inference_mode():
        got, _ = RW.rwkv_time_apply(tp, tcfg, torch.from_numpy(x))
        want = RW.rwkv_time_ref(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      numpy_tree["layers"]["time"])
    np.testing.assert_allclose(
        want.numpy(), np.asarray(JRW.rwkv_time_ref(jp, jcfg, jnp.asarray(x))),
        rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("scan", [False, True], ids=["chunked", "kernel"])
def test_ssm_apply_matches_sequential(scan):
    jcfg, tcfg = _configs("zamba2-2.7b", scan)
    numpy_tree = _perturb(jax.tree.map(
        np.asarray, jbuild_model(jcfg).init_params(jax.random.PRNGKey(3))),
        np.random.default_rng(3))
    tp = index_tree(params_from_jax(numpy_tree, tcfg, device="cpu")
                    ["layers"], 0)["ssm"]
    x = np.random.default_rng(4).standard_normal(
        (2, 13, tcfg.d_model)).astype(np.float32)
    with torch.inference_mode():
        got, _ = SSM.ssm_apply(tp, tcfg, torch.from_numpy(x))
        want = SSM.ssm_ref_scan(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      numpy_tree["layers"]["ssm"])
    np.testing.assert_allclose(
        want.numpy(), np.asarray(JSSM.ssm_ref_scan(jp, jcfg, jnp.asarray(x))),
        rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_reference(arch):
    cfg = get_config(arch, smoke=True)
    tparams = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                           "cpu")
    jparams = jbuild_model(jget_config(arch, smoke=True)
                           ).init_params(jax.random.PRNGKey(0))
    assert (jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)
                                    .removeprefix("torch.")), tparams)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                            jparams))
    cache = build_model(cfg).init_cache(2, 16, device="cpu")
    jcache = jbuild_model(jget_config(arch, smoke=True)).init_cache(2, 16)
    assert (jax.tree.map(lambda t: tuple(t.shape), cache)
            == jax.tree.map(lambda a: tuple(a.shape), jcache))


@pytest.mark.parametrize("arch", ["llama3-8b", *ARCHS])
def test_converted_and_made_params_share_dtypes(arch):
    """params_from_jax casts exactly the weights that init_params makes
    in the compute dtype (model.PROJECTIONS), for every ported family."""
    kw = dict(compute_dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), **kw)
    made = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        "cpu")
    moved = params_from_jax(jax.tree.map(
        np.asarray, jbuild_model(jcfg).init_params(jax.random.PRNGKey(0))),
        cfg, device="cpu")
    dtypes = jax.tree.map(lambda t: t.dtype, made)
    assert dtypes == jax.tree.map(lambda t: t.dtype, moved)
    assert torch.bfloat16 in jax.tree.leaves(dtypes)
