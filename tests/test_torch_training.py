"""The port's training loss (``Model.loss``) against the reference on
the same numpy-seeded inputs: the reference's ``init_params`` moved over
as fp32 masters (``params_from_jax(..., masters=True)``), the same
batches.  The twin of ``tests/test_models_smoke.py::test_smoke_train_step``
on every smoke config, remat on, off and "dots", the MoE aux loss, the
master weights, the backward through the plain scans, and the kernels'
refusal under grad, held against the reference's.
``tests/test_torch_training_steps.py`` holds the optimizer, the train
step and the loop."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.kernels.goma_gemm import NoBackwardError
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.training import optimizer as opt

# the loss and each grad leaf, relative to max(1, the reference's scale);
# the chunked scans sum in another order than the reference's einsums
LOSS_TOL = {"rwkv": 1e-4, "hybrid": 1e-4}
GRAD_TOL = 1e-4
B, S = 2, 8


def _pair(arch, **knobs):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), **knobs)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **knobs)
    jmodel, tmodel = jbuild_model(jcfg), build_model(tcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu", masters=True)
    return jcfg, jmodel, jparams, tmodel, tparams


def _batches(cfg, seed=3, b=B, s=S):
    """(reference batch, port batch): tokens, labels rolled by one with
    the last label of row 0 masked (-1), and the frontends' inputs."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, -1] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    if cfg.family in ("encdec", "vlm"):
        key = "frames" if cfg.family == "encdec" else "patches"
        f = (rng.standard_normal((b, cfg.frontend_len, cfg.d_model))
             * 0.1).astype(np.float32)
        jb[key], tb[key] = jnp.asarray(f), torch.from_numpy(f)
    return jb, tb


def _with_grad(tree):
    return opt.tree_map(lambda p: p.detach().requires_grad_(), tree)


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_smoke_train_step_matches_reference(arch):
    """Twin of test_smoke_train_step: the loss (remat on) within 1e-5 of
    the reference's (1e-4 for the recurrent and hybrid families), and
    every grad leaf present and within 1e-4 of max(1, max |g_ref|)."""
    jcfg, jmodel, jparams, tmodel, tparams = _pair(arch)
    jb, tb = _batches(jcfg)
    jl, jg = jax.value_and_grad(
        lambda p: jmodel.loss(p, jb, remat=True))(jparams)
    live = _with_grad(tparams)
    tl = tmodel.loss(live, tb, remat=True)
    tl.backward()
    tl = tl.detach()
    tol = LOSS_TOL.get(jcfg.family, 1e-5)
    assert abs(float(tl) - float(jl)) <= tol * max(1.0, abs(float(jl)))
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(flat) == len(opt.tree_leaves(live))
    for path, g in flat:
        t = _leaf(live, path)
        assert t.grad is not None, (arch, path)
        g = np.asarray(g)
        np.testing.assert_allclose(
            t.grad.numpy(), g, rtol=0,
            atol=GRAD_TOL * max(1.0, float(np.abs(g).max())),
            err_msg=f"{arch} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-7b", "zamba2-2.7b",
                                  "deepseek-moe-16b"])
def test_remat_on_off_and_dots_give_equal_grads(arch):
    cfg = get_config(arch, smoke=True)
    jb, tb = _batches(cfg)
    grads = {}
    for name, policy, remat in (("off", "full", False), ("full", "full", True),
                                ("dots", "dots", True)):
        c = dataclasses.replace(cfg, remat_policy=policy)
        model = build_model(c)
        params = _with_grad(model.init_params(
            torch.Generator().manual_seed(0), "cpu", masters=True))
        loss = model.loss(params, tb, remat=remat)
        leaves = opt.tree_leaves(params)
        grads[name] = (float(loss.detach()),
                       torch.autograd.grad(loss, leaves))
    for name in ("full", "dots"):
        assert grads[name][0] == grads["off"][0]
        for a, b in zip(grads[name][1], grads["off"][1]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_dots_policy_keeps_the_matmul_outputs():
    """remat_policy="dots" saves the 2-D matmuls' outputs (the
    projections), so the backward runs as many as without remat, and
    full remat recomputes them; batched products are recomputed under
    both."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[func] = self.n.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    cfg = get_config("llama3-8b", smoke=True)
    _, tb = _batches(cfg)
    counts = {}
    for policy, remat in (("full", False), ("full", True), ("dots", True)):
        model = build_model(dataclasses.replace(cfg, remat_policy=policy))
        params = _with_grad(model.init_params(
            torch.Generator().manual_seed(0), "cpu", masters=True))
        loss = model.loss(params, tb, remat=remat)
        with Count() as c:
            loss.backward()
        counts[(policy, remat)] = (c.n[torch.ops.aten.mm.default],
                                   c.n[torch.ops.aten.bmm.default])
    off, full, dots = (counts[k] for k in (("full", False), ("full", True),
                                           ("dots", True)))
    assert dots[0] == off[0] < full[0]
    assert dots[1] == full[1] > off[1]


def test_moe_aux_loss_is_in_the_loss():
    """The MoE layers' summed load-balancing loss enters the loss at
    0.01, as in the reference (the twin test above holds the total)."""
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu",
                               masters=True)
    _, tb = _batches(cfg)
    with torch.no_grad():
        x = model._embed_in(params, tb["tokens"])
        _, aux = model._forward_stack(params, x, torch.arange(S))
        total = model.loss(params, tb)
    assert float(aux) > 0.0
    logits = model._lm_logits(params, model._forward_stack(
        params, x, torch.arange(S))[0])
    valid = (tb["labels"] >= 0).float()
    nll = -torch.gather(torch.log_softmax(logits.float(), -1), -1,
                        tb["labels"].clamp(min=0)[..., None])[..., 0]
    base = (nll * valid).sum() / valid.sum()
    torch.testing.assert_close(total, base + 0.01 * aux)


def test_master_weights_are_the_parameter_dtype():
    """Training's masters keep every leaf in param_dtype, cast at use;
    serving's projections stay in the compute dtype."""
    cfg = get_config("stablelm-1.6b", smoke=True)
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    model = build_model(cfg)
    serve = model.init_params(torch.Generator().manual_seed(0), "cpu")
    train = model.init_params(torch.Generator().manual_seed(0), "cpu",
                              masters=True)
    assert serve["layers"]["mlp"]["wg"]["w"].dtype == torch.bfloat16
    assert {t.dtype for t in opt.tree_leaves(train)} == {torch.float32}
    _, tb = _batches(cfg)
    loss = model.loss(_with_grad(train), tb)
    assert math.isfinite(float(loss.detach()))


# -------------------------------------------------- the kernels' refusal
def _ref_refuses(jmodel, jparams, jb):
    with pytest.raises(Exception):
        jax.grad(lambda p: jmodel.loss(p, jb, remat=False))(jparams)


@pytest.mark.parametrize("arch,knob,kernel", [
    ("llama3-8b", "fused_mlp", "fused_mlp"),
    ("rwkv6-7b", "use_pallas_scan", "wkv6_scan")])
def test_grad_through_a_kernel_raises_as_the_reference(arch, knob, kernel):
    """A loss through the fused MLP (dense) or the scan kernel (rwkv)
    cannot be differentiated: the reference's jax.grad fails in its
    Pallas kernels, and the port raises before the kernel runs, on the
    CPU as on the card, so that no leaf trains on a missing gradient."""
    knobs = {knob: True}
    if knob == "use_pallas_scan":
        knobs["ssd_chunk"] = 8
    jcfg, jmodel, jparams, tmodel, tparams = _pair(arch, **knobs)
    jb, tb = _batches(jcfg)
    _ref_refuses(jmodel, jparams, jb)
    with pytest.raises(NoBackwardError, match=kernel):
        tmodel.loss(_with_grad(tparams), tb, remat=False)
    # without grad the kernel path's loss is the plain path's
    with torch.no_grad():
        got = tmodel.loss(tparams, tb, remat=False)
    plain = build_model(dataclasses.replace(tmodel.cfg, **{knob: False}))
    with torch.no_grad():
        want = plain.loss(tparams, tb, remat=False)
    assert abs(float(got) - float(want)) < 1e-5


def test_rwkv_scan_kernel_loss_matches_reference():
    """Twin of test_rwkv_pallas_scan_path_matches_jax: the loss through
    the scan kernel's path (its plain version here), without grad,
    equals the reference's through its Pallas kernel and its pure-JAX
    path."""
    jcfg, jmodel, jparams, tmodel, tparams = _pair(
        "rwkv6-7b", ssd_chunk=8, use_pallas_scan=True)
    jb, tb = _batches(jcfg, s=12)
    l_ref = float(jmodel.loss(jparams, jb, remat=False))
    l_jax = float(jbuild_model(dataclasses.replace(
        jcfg, use_pallas_scan=False)).loss(jparams, jb, remat=False))
    with torch.no_grad():
        got = float(tmodel.loss(tparams, tb, remat=False))
    assert abs(got - l_ref) < 1e-5 and abs(got - l_jax) < 1e-5


def test_every_wrapper_refuses_under_grad_and_not_under_no_grad():
    from repro_torch.core.hopper_mapping import (plan_fused_mlp,
                                                 plan_gemm_tiling)
    from repro_torch.kernels import (goma_combine, goma_fused_matmul,
                                     goma_matmul, ops, ssd_scan, wkv6_scan)
    g = torch.Generator().manual_seed(0)
    a = torch.randn(4, 64, generator=g)
    w = torch.randn(64, 128, generator=g)
    wd = torch.randn(128, 64, generator=g)
    plan = plan_gemm_tiling(4, 128, 64, dtype_bytes=4)
    fplan = plan_fused_mlp(4, 128, 64, dtype_bytes=4)
    pm, pn, pk = plan.padded
    ap = torch.nn.functional.pad(a, (0, pk - 64, 0, pm - 4))
    wp = torch.nn.functional.pad(w, (0, pn - 128, 0, pk - 64))
    r = torch.randn(1, 8, 1, 64, generator=g)
    xh = torch.randn(1, 8, 1, 16, generator=g)
    calls = {
        "gemm": lambda t: ops.gemm(t, w),
        "fused_mlp": lambda t: ops.fused_mlp(t, w, w, wd),
        "goma_matmul": lambda t: goma_matmul(
            torch.nn.functional.pad(t, (0, pk - 64, 0, pm - 4)), wp, plan),
        "goma_combine": lambda t: goma_combine(t, t),
        "goma_fused_matmul": lambda t: goma_fused_matmul(
            *_fused_operands(t, w, wd, fplan), fplan),
        "wkv6_scan": lambda t: wkv6_scan(
            r * t.sum(), r, r, -r.abs(), r[0, 0], chunk=8),
        "ssd_scan": lambda t: ssd_scan(
            xh * t.sum(), xh[..., 0].abs(), torch.zeros(1), xh[:, :, 0],
            xh[:, :, 0], chunk=8),
    }
    assert fplan.fused
    for name, call in calls.items():
        with pytest.raises(NoBackwardError, match=name):
            call(a.clone().requires_grad_())
        with torch.no_grad():
            call(a.clone().requires_grad_())
        call(a)     # no operand requires grad
    # the plain products differentiate
    out = ops.gemm(a.clone().requires_grad_(), w, force_plain=True)
    assert out.grad_fn is not None
    del ap


def _fused_operands(a, w, wd, plan):
    pm, pff, pk, pn2 = plan.padded
    pad = torch.nn.functional.pad
    return (pad(a, (0, pk - a.shape[1], 0, pm - a.shape[0])),
            pad(w, (0, pff - w.shape[1], 0, pk - w.shape[0])),
            pad(w, (0, pff - w.shape[1], 0, pk - w.shape[0])),
            pad(wd, (0, pn2 - wd.shape[1], 0, pff - wd.shape[0])))


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b"])
def test_backward_through_the_plain_scans(arch):
    """The recurrent families' training path: backward() through the
    chunked plain scans (no cache) gives finite grads on every leaf,
    with strong decays too (the masked exponents carry zero
    gradient)."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = _with_grad(model.init_params(torch.Generator().manual_seed(0),
                                          "cpu", masters=True))
    if arch == "rwkv6-7b":
        params["layers"]["time"]["w_bias"] = torch.full_like(
            params["layers"]["time"]["w_bias"], 3.0).requires_grad_()
    else:
        params["layers"]["ssm"]["A_log"] = torch.full_like(
            params["layers"]["ssm"]["A_log"], 3.0).requires_grad_()
    _, tb = _batches(cfg, s=24)
    model.loss(params, tb, remat=False).backward()
    for t in opt.tree_leaves(params):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())


