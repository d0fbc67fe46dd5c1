"""The plain reference against the port's plain path at smoke size, in
fp32 on the CPU; the reference imports nothing of the port, the test
does, to hold one against the other."""
import pytest
import torch

from portbench.harness import traffic as T
from portbench.harness import train as TR
from portbench.harness import weights as W
from portbench.harness.run_record import arch_config
from portbench.reference import dense as R
from portbench.tests.tiny import tiny_config


def port_logits(cfg, params, tokens):
    from repro_torch.models import build_model
    model = build_model(arch_config(dict(cfg, run=dict(cfg["run"],
                                                       fused_mlp=False))))
    with torch.no_grad():
        x = model._embed_in(params, tokens[None])
        pos = torch.arange(tokens.shape[0])
        x, _ = model._forward_stack(params, x, pos)
        return model._lm_logits(params, x)[0]


@pytest.mark.parametrize("name", ["yi-34b", "stablelm-1.6b"])
def test_reference_forward_equals_the_ports_plain_path(name):
    cfg = tiny_config(name)
    params = W.make(cfg, 11, "cpu", masters=True)
    tokens = torch.randint(0, cfg["vocab_size"], (40,),
                           generator=torch.Generator().manual_seed(2))
    want = port_logits(cfg, params, tokens)
    got, _ = R.served_logits(params, R.Spec.of(cfg), [tokens],
                             [torch.arange(40)])
    # both fp32; the port's online softmax over key blocks sums in
    # another order than the plain softmax: rounding, well under 1e-5
    scale = want.abs().max()
    assert (got[0] - want).abs().max() <= 1e-5 * scale


def test_served_weights_keep_the_configured_dtypes():
    cfg = tiny_config("yi-34b", dtype="bfloat16")
    p = W.make(cfg, 1, "cpu", masters=False)
    assert p["layers"]["mlp"]["wg"]["w"].dtype == torch.bfloat16
    assert p["embed"]["e"].dtype == torch.float32
    assert "bias" not in p["layers"]["ln1"]
    q = W.make(cfg, 1, "cpu", masters=True)
    assert q["layers"]["mlp"]["wg"]["w"].dtype == torch.float32
    # the same seed gives the same tensors
    assert torch.equal(W.make(cfg, 1, "cpu", masters=True)["embed"]["e"],
                       q["embed"]["e"])


def port_train(cfg, job, seed, steps):
    """The port's three first steps as the harness records them."""
    from repro_torch.models import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import jit_train_step
    params = W.make(cfg, seed, "cpu", masters=True)
    state = opt.init_state(params)
    step = jit_train_step(build_model(arch_config(cfg)),
                          TR.adamw_config(job), remat=True)
    rec = {"losses": []}
    for i in range(steps):
        params, state, m = step(params, state, batch(cfg, job, seed, i))
        rec["losses"].append(float(m["loss"]))
        if i == 0:
            rec["grad_norms"] = {
                k: float(mu.norm()) / (1 - job["beta1"])
                for k, mu in W.leaves(state["mu"])}
    p0 = W.make(cfg, seed, "cpu", masters=True)
    rec["change"] = {k: float((dict(W.leaves(params))[k] - p).norm())
                     for k, p in W.leaves(p0)}
    return rec, p0


def batch(cfg, job, seed, i):
    return {k: torch.as_tensor(v) for k, v in T.train_rows(
        seed, i, job["batch"], job["seq"], cfg["vocab_size"]).items()}


@pytest.mark.parametrize("name", ["stablelm-1.6b", "yi-34b"])
def test_reference_training_equals_the_ports_steps(name):
    from portbench.harness import spec
    cfg = tiny_config(name)
    cfg["run"]["fused_mlp"] = False
    job = dict(spec.load_json(spec.HERE / "traffic" / "train4k.json"),
               batch=2, seq=24)
    prog, p0 = port_train(cfg, job, 5, 3)
    ref = R.train(p0, [batch(cfg, job, 5, i) for i in range(3)],
                  R.Spec.of(cfg), job)
    # both fp32 on the CPU: the gaps are rounding, far under the cell's
    # limits (set from bf16 on the card) and under the fp8 control's
    nums = TR.compare(prog, ref)
    assert nums["loss"] < 1e-6 and nums["grad"] < 1e-5 and \
        nums["change"] < 1e-5, nums
    assert set(ref["grad_norms"]) == set(prog["grad_norms"])
