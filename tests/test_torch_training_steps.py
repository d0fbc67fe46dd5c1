"""The port's training steps against the reference on the same
numpy-seeded inputs: the first AdamW steps and microbatch accumulation
against the reference's jitted ``make_train_step`` (the reference's
``init_params`` moved over as fp32 masters), the optimizer's schedule,
decay and update against the reference's, and twins of
``tests/test_train_serve_integration.py`` (descent, exact resume, the
loop's watchdog) and ``tests/test_fault_tolerance.py`` (the straggler
count, the NaN guard).  ``tests/test_torch_training.py`` holds the loss
and its gradients."""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_config as jget_config
from repro.data import DataConfig as JDataConfig, host_batch
from repro.models import build_model as jbuild_model
from repro.training import optimizer as jopt
from repro.training.train_step import make_train_step as jmake_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, RankRows, global_arrays
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.training import LoopConfig, optimizer as opt, run_training
from repro_torch.training.train_step import jit_train_step, make_train_step

STEP_LOSS_TOL = 1e-4


def _pair(arch, **knobs):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), **knobs)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **knobs)
    jmodel, tmodel = jbuild_model(jcfg), build_model(tcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu", masters=True)
    return jcfg, jmodel, jparams, tmodel, tparams


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _run_both(arch, steps, *, microbatches=1, lr=3e-3, seq=16, batch=4,
              **knobs):
    """The reference's jitted make_train_step and the port's on the same
    weights and host_batch stream: (ref losses, port losses, ref
    metrics, port metrics, ref params, port params)."""
    jcfg, jmodel, jparams, tmodel, tparams = _pair(arch, **knobs)
    kw = dict(lr=lr, warmup_steps=2, total_steps=20)
    jstep = jax.jit(jmake_train_step(jmodel, jopt.AdamWConfig(**kw),
                                     microbatches=microbatches))
    tstep = make_train_step(tmodel, opt.AdamWConfig(**kw),
                            microbatches=microbatches)
    jstate, tstate = jopt.init_state(jparams), opt.init_state(tparams)
    data = dict(vocab=jcfg.vocab, seq_len=seq, global_batch=batch)
    jdc, tdc = JDataConfig(**data), DataConfig(**data)
    stub = {}
    if jcfg.family in ("encdec", "vlm"):
        key = "frames" if jcfg.family == "encdec" else "patches"
        stub = {key: np.zeros((batch, jcfg.frontend_len, jcfg.d_model),
                              np.float32)}
    jl, tl, jm, tm = [], [], [], []
    for i in range(steps):
        hb = {**host_batch(jdc, i), **stub}
        jparams, jstate, m = jstep(jparams, jstate,
                                   {k: jnp.asarray(v) for k, v in hb.items()})
        jl.append(float(m["loss"]))
        jm.append(m)
        tb = {**global_arrays(tdc, i, RankRows()),
              **{k: torch.from_numpy(v) for k, v in stub.items()}}
        tparams, tstate, m = tstep(tparams, tstate, tb)
        tl.append(float(m["loss"]))
        tm.append(m)
    return jl, tl, jm, tm, jparams, tparams


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_first_five_adamw_steps_match_reference(arch):
    jl, tl, jm, tm, _, _ = _run_both(arch, 5)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=STEP_LOSS_TOL *
                               max(1.0, max(map(abs, jl))))
    for a, b in zip(jm, tm):
        np.testing.assert_allclose(float(b["lr"]), float(a["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(b["grad_norm"]),
                                   float(a["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-moe-16b"])
def test_microbatches_match_reference(arch):
    """make_train_step(microbatches=2): fp32 accumulation in microbatch
    order, then x 1/2, as the reference's scan; params after 3 steps
    within 1e-4 of scale."""
    jl, tl, _, _, jp, tp = _run_both(arch, 3, microbatches=2)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=STEP_LOSS_TOL * 10)
    for path, a in jax.tree_util.tree_flatten_with_path(jp)[0]:
        a = np.asarray(a)
        np.testing.assert_allclose(
            _leaf(tp, path).numpy(), a, rtol=0,
            atol=1e-4 * max(1.0, float(np.abs(a).max())))


# ------------------------------------- twins of the integration tests
@pytest.fixture(scope="module")
def tiny_setup():
    cfg = get_config("llama3-8b", smoke=True)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu",
                               masters=True)
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    step = make_train_step(model, ocfg, remat=False)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8,
                          seed=0)
    return cfg, model, params, ocfg, step, data_cfg


def _run(step, params, opt_state, data_cfg, n, start=0):
    losses = []
    for i in range(start, start + n):
        batch = global_arrays(data_cfg, i, RankRows())
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
    return params, opt_state, losses


def test_training_descends(tiny_setup):
    cfg, model, params, ocfg, step, data_cfg = tiny_setup
    _, _, losses = _run(step, params, opt.init_state(params), data_cfg, 30)
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


@pytest.mark.parametrize("donate", [False, True])
def test_restart_resumes_exactly(tiny_setup, tmp_path, donate):
    """12 steps straight == 6 steps, a save, a restore in a fresh
    manager and 6 more, bit for bit (losses and every leaf); with
    ``donate`` through the in-place step a run takes."""
    cfg, model, params, ocfg, _, data_cfg = tiny_setup
    step = (jit_train_step(model, ocfg, remat=False) if donate
            else make_train_step(model, ocfg, remat=False))
    fresh = lambda: opt.tree_map(torch.clone, params)
    p_ref, _, losses_ref = _run(step, fresh(), opt.init_state(params),
                                data_cfg, 12)
    p6, s6, losses_a = _run(step, fresh(), opt.init_state(params),
                            data_cfg, 6)
    CheckpointManager(tmp_path, async_save=False).save(6, (p6, s6))
    del p6, s6
    (p_r, s_r), step0 = CheckpointManager(tmp_path).restore(
        (params, opt.init_state(params)))
    assert step0 == 6 and int(s_r["step"]) == 6
    p_fin, _, losses_b = _run(step, p_r, s_r, data_cfg, 6, start=6)
    assert losses_a + losses_b == losses_ref
    for a, b in zip(opt.tree_leaves(p_fin), opt.tree_leaves(p_ref)):
        assert torch.equal(a, b)


def test_run_training_loop_with_watchdog(tiny_setup, tmp_path):
    cfg, model, params, ocfg, step, data_cfg = tiny_setup
    mgr = CheckpointManager(tmp_path, async_save=False)
    _, _, state = run_training(
        step, params, opt.init_state(params), data_cfg, RankRows(),
        LoopConfig(total_steps=8, ckpt_every=4, log_every=100),
        mgr, log=lambda s: None)
    assert state.step == 8 and len(state.step_seconds) == 8
    assert mgr.latest_step() == 8
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        f"step_{4:010d}", f"step_{8:010d}"]
    # restart picks up from the final checkpoint and does nothing
    _, _, state2 = run_training(
        step, params, opt.init_state(params), data_cfg, None,
        LoopConfig(total_steps=8), mgr, log=lambda s: None)
    assert state2.step == 8 and not state2.losses


# ------------------------------- twins of the fault-tolerance tests
@pytest.fixture()
def host_data():
    return DataConfig(vocab=97, seq_len=8, global_batch=2, seed=0)


def test_straggler_watchdog_counts(host_data):
    calls = {"n": 0}

    def slow_step(params, opt_state, batch):
        calls["n"] += 1
        time.sleep(0.6 if calls["n"] == 6 else 0.02)
        return params, opt_state, {"loss": torch.tensor(1.0)}

    _, _, state = run_training(
        slow_step, {}, {}, host_data, None,
        LoopConfig(total_steps=8, ckpt_every=100, log_every=100,
                   straggler_factor=3.0), None, log=lambda s: None)
    assert state.straggler_steps >= 1
    assert state.step == 8


def test_nan_guard_checkpoints_and_raises(host_data, tmp_path):
    def nan_step(params, opt_state, batch):
        return params, opt_state, {"loss": torch.tensor(float("nan"))}

    mgr = CheckpointManager(tmp_path, async_save=False)
    with pytest.raises(FloatingPointError):
        run_training(nan_step, {"w": torch.ones(3)}, {}, host_data, None,
                     LoopConfig(total_steps=5), mgr, log=lambda s: None)
    # the abort path left a checkpoint for post-mortem restart
    assert mgr.latest_step() == 1
    (w,), _ = mgr.restore(({"w": torch.zeros(3)},))
    assert torch.equal(w["w"], torch.ones(3))


def test_lr_schedule_equals_the_reference_at_every_step():
    jcfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                            min_lr_frac=0.1)
    tcfg = opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                           min_lr_frac=0.1)
    want = [float(jopt.schedule(jcfg, jnp.asarray(s))) for s in range(120)]
    got = [float(opt.schedule(tcfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(120)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] < got[9] <= tcfg.lr + 1e-9           # warmup rises
    assert abs(max(got) - tcfg.lr) < 1e-4 * tcfg.lr     # peaks at lr
    assert got[99] >= tcfg.lr * tcfg.min_lr_frac * 0.99  # floor respected
    assert got[99] < got[50]                            # cosine decays


def test_adamw_decays_matrices_not_vectors():
    cfg = opt.AdamWConfig(lr=1e-2, weight_decay=0.5, warmup_steps=1,
                          total_steps=10)
    params = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
    grads = {"w": torch.zeros((4, 4)), "b": torch.zeros((4,))}
    new_params, _, _ = opt.apply_updates(params, grads,
                                         opt.init_state(params), cfg)
    assert float(new_params["w"].max()) < 1.0   # decayed
    assert float(new_params["b"].max()) == 1.0  # exempt


def test_apply_updates_equals_the_reference_bitwise_on_one_step():
    """One update of a mixed tree (clipped: the global norm over 1) from
    non-zero moments, against the reference's, leaf for leaf; and in
    place (``donate``) gives the same bits."""
    rng = np.random.default_rng(0)
    shapes = {"a": (8, 4), "b": {"c": (5,), "d": (3, 2, 2)}}
    mk = lambda s: (rng.standard_normal(s)).astype(np.float32)
    tree = lambda: opt.tree_map(lambda s: mk(s), shapes,)
    p, g, mu, nu = (tree() for _ in range(4))
    nu = opt.tree_map(np.abs, nu)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=10, grad_clip=1.0)
    jstate = {"mu": jax.tree.map(jnp.asarray, mu),
              "nu": jax.tree.map(jnp.asarray, nu),
              "step": jnp.asarray(4, jnp.int32)}
    jp, js, jm = jopt.apply_updates(jax.tree.map(jnp.asarray, p),
                                    jax.tree.map(jnp.asarray, g), jstate,
                                    jopt.AdamWConfig(**kw))
    tt = lambda t: opt.tree_map(torch.from_numpy, t)
    outs = []
    for donate in (False, True):
        tstate = {"mu": tt(opt.tree_map(np.copy, mu)),
                  "nu": tt(opt.tree_map(np.copy, nu)),
                  "step": torch.tensor(4, dtype=torch.int32)}
        outs.append(opt.apply_updates(tt(opt.tree_map(np.copy, p)), tt(g),
                                      tstate, opt.AdamWConfig(**kw),
                                      donate=donate))
    (tp, ts, tm), (dp, ds, _) = outs
    assert float(tm["grad_norm"]) > 1.0
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    for x, y, z in zip(jax.tree.leaves(jp), opt.tree_leaves(tp),
                       opt.tree_leaves(dp)):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=2e-6,
                                   atol=1e-7)
        assert torch.equal(y, z)
    for key in ("mu", "nu"):
        for x, y in zip(jax.tree.leaves(js[key]),
                        opt.tree_leaves(ts[key])):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=2e-6,
                                       atol=1e-7)
    assert int(ts["step"]) == int(js["step"]) == 5
