"""DeepSeek-V2's plain reference against the port at smoke size, in fp32
on the CPU: latent attention through the latent cache and in its two
forms, YaRN, the dropless experts, the dense first layer and the loss.
The reference imports nothing of the port; the test does, to hold one
against the other.

Tolerance: 1e-5 of the logits' (or outputs') scale, the port's own for
fp32 paths that sum in another order (the absorbed attention, the online
softmax of the walk, grouped products against a loop)."""
import math

import pytest
import torch

from portbench.harness import weights_mla as W
from portbench.harness.serve_mla import arch_config
from portbench.reference import deepseek_v2 as R
from portbench.tests.tiny_mla import tiny_config

TOL = 1e-5


def setup(seed=5, **kw):
    from repro_torch.models import build_model
    cfg = tiny_config(**kw)
    mcfg = arch_config(dict(cfg, run=dict(cfg["run"], fused_mlp=False)))
    return cfg, build_model(mcfg), W.make(cfg, seed, "cpu")


def close(got, want, tol=TOL):
    return (got - want).abs().max() <= tol * want.abs().max()


def test_prefill_then_decode_through_the_latent_cache_equals_the_reference():
    """Two rows: chunked prefill at one write position, then decode steps
    at each row's own position, as the scheduler runs them."""
    cfg, model, params = setup()
    g = torch.Generator().manual_seed(3)
    seqs = [torch.randint(0, cfg["vocab_size"], (n,), generator=g)
            for n in (29, 23)]
    cache = model.init_cache(2, 48, device="cpu")
    n = cfg["num_hidden_layers"]
    assert set(cache["layers"]) == {"ckv"}
    assert cache["layers"]["ckv"].shape == (n, 2, 48, 32 + 8)
    prompt = 20
    got = [[], []]
    with torch.no_grad():
        for start, w in ((0, 8), (8, 8), (16, 4)):
            lg, _ = model.decode_step(
                params, cache, torch.stack([s[start:start + w]
                                            for s in seqs]), start)
        for r in range(2):
            got[r].append(lg[r, -1])
        pos = torch.tensor([prompt, prompt])
        for step in range(3):
            # row 1 pauses a step: its position stays, as a slot may
            lg, _ = model.decode_step(
                params, cache, torch.stack([s[p:p + 1] for s, p in
                                            zip(seqs, pos.tolist())]), pos)
            for r in range(2):
                if r == 0 or step != 1:
                    got[r].append(lg[r, -1])
            pos = pos + torch.tensor([1, 0 if step == 1 else 1])
    want, _ = R.served_logits(
        params, R.Spec.of(cfg), [s[:prompt + 3] for s in seqs],
        [torch.arange(prompt - 1, prompt + 3),
         torch.arange(prompt - 1, prompt + 2)])
    for r in range(2):
        assert close(torch.stack(got[r]), want[r])


def test_absorbed_latent_attention_equals_the_expanded_form():
    from repro_torch.models import mla
    cfg, model, params = setup()
    mcfg = model.cfg
    lp = layer_of(params["layers"]["attn"])
    x = torch.randn(2, 13, 64, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(13)
    with torch.no_grad():
        expanded = mla.mla_apply(lp, mcfg, x, pos)
        cache = {"ckv": torch.zeros(2, 16, 40)}
        absorbed = mla.mla_apply(lp, mcfg, x, pos, cache=cache,
                                 cache_index=0)
    assert close(absorbed, expanded)
    assert (cache["ckv"][:, 13:] == 0).all()


def test_yarn_frequencies_and_the_softmax_scale_are_the_closed_form():
    from repro_torch.configs.deepseek_v2_lite import CONFIG
    from repro_torch.models import mla
    cfg = tiny_config()
    cfg.update(qk_rope_head_dim=64, qk_nope_head_dim=128)
    spec = R.Spec.of(cfg)
    assert mla.correction_range(CONFIG) == (10, 23)
    assert R.correction_dims(spec) == (10, 23)
    # the closed form, element by element: the ramp over the 32 pairs
    theta, factor, low, high = 10000.0, 40.0, 10, 23
    want = []
    for i in range(32):
        extra = theta ** (-2 * i / 64)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(extra / factor * ramp + extra * (1 - ramp))
    want = torch.tensor(want, dtype=torch.float64)
    for got in (mla.yarn_inv_freq(CONFIG), R.inv_freq(spec)):
        assert torch.allclose(got.double(), want, rtol=1e-6, atol=0)
    assert got[0] == 1.0 and torch.isclose(got[31].double(),
                                           want[31], rtol=1e-6)
    scale = 192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2
    assert abs(scale - 0.11472) < 5e-6
    assert mla.softmax_scale(CONFIG) == pytest.approx(scale, rel=1e-12)
    assert R.softmax_scale(spec) == pytest.approx(scale, rel=1e-12)


def layer_of(stack: dict, i: int = 0) -> dict:
    from repro_torch.models.model import index_tree
    return index_tree(stack, i)


@pytest.mark.parametrize("renormalise", [False, True])
def test_dropless_experts_equal_the_reference_and_count_every_row(
        renormalise):
    from repro_torch.models import moe
    from repro_torch.obs.registry import get_registry
    cfg, model, params = setup(norm_topk_prob=renormalise)
    mcfg = model.cfg
    assert mcfg.moe_dispatch == "dropless"
    p = layer_of(params["layers"]["moe"])
    w = {f"moe/{k}": v[0] for k, v in
         R._leaves(params["layers"]["moe"]).items()}
    x = torch.randn(3, 17, 64, generator=torch.Generator().manual_seed(4))
    reg = get_registry()
    reg.reset("moe.")
    moe.ROUTE_LOAD.reset()
    moe.ROUTE_LOAD.on = True
    try:
        with torch.no_grad():
            got, _ = moe.moe_apply(p, mcfg, x)
    finally:
        moe.ROUTE_LOAD.on = False
    spec = R.Spec.of(cfg)
    want, _, top_i = R.experts(x.reshape(-1, 64), w, spec, False)
    assert close(got.reshape(-1, 64), want)
    rows = 3 * 17 * cfg["num_experts_per_tok"]
    assert reg.get("moe.dropless.calls") == 1
    assert reg.get("moe.rows_routed") == rows
    load = moe.ROUTE_LOAD.read()
    E = cfg["n_routed_experts"]
    counts = torch.bincount(top_i.reshape(-1), minlength=E)
    assert load["rows"] == counts.tolist() and sum(load["rows"]) == rows
    assert load["max_share_sum"] == pytest.approx(
        counts.max().item() / (rows / E))
    # the other choice of renormalisation is a different layer
    other = R.experts(x.reshape(-1, 64), w,
                      R.Spec.of(dict(cfg, norm_topk_prob=not renormalise)),
                      False)[0]
    assert not close(other, want, 1e-2)


def test_grouped_products_agree_with_a_loop_at_any_width():
    from repro_torch.models import moe
    g = torch.Generator().manual_seed(0)
    for d_out in (32, 30):          # 30 fp32: strides not of 16 bytes
        w = torch.randn(4, 12, d_out, generator=g)
        xs = torch.randn(9, 12, generator=g)
        ends = torch.tensor([2, 2, 7, 9])
        got = moe.grouped_mm(xs, w, ends)
        want = torch.cat([xs[:2] @ w[0], xs[2:7] @ w[2], xs[7:] @ w[3]])
        assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)
    meta = moe.grouped_mm(xs.to("meta"), w.to("meta"), ends.to("meta"))
    assert meta.shape == (9, 30) and meta.device.type == "meta"


def test_layer_zero_is_dense_and_the_rest_are_experts():
    cfg, model, params = setup()
    port = model.init_params(torch.Generator().manual_seed(0), "cpu")
    for tree in (params, port):
        dense, moe_layers = tree["dense_layers"], tree["layers"]
        assert set(dense) == {"ln1", "attn", "ln2", "mlp"}
        assert dense["mlp"]["wg"]["w"].shape == (1, 64, 128)
        assert set(moe_layers) == {"ln1", "attn", "ln2", "moe"}
        n, E = cfg["num_hidden_layers"] - 1, cfg["n_routed_experts"]
        assert moe_layers["moe"]["wg"].shape == (n, E, 64, 32)
        assert moe_layers["moe"]["shared"]["wg"]["w"].shape == (n, 64, 64)
    # the first layer's output is the reference's dense layer
    x = torch.randn(1, 10, 64, generator=torch.Generator().manual_seed(2))
    lp = layer_of(params["dense_layers"])
    with torch.no_grad():
        got, aux = model._attn_block(lp, x, torch.arange(10))
    assert aux is None
    want, routed = R.layer([x[0]], R.layer_weights(params, 0, R.Spec.of(
        cfg)), R.Spec.of(cfg))
    assert routed is None and close(got[0], want[0])


def test_the_loss_matches_the_reference():
    cfg, model, params = setup()
    g = torch.Generator().manual_seed(9)
    tokens = torch.randint(0, cfg["vocab_size"], (2, 24), generator=g)
    labels = torch.cat([tokens[:, 1:], torch.full((2, 1), -1)], 1)
    batch = {"tokens": tokens, "labels": labels}
    from repro_torch.obs.registry import get_registry
    get_registry().reset("attn.")
    got = model.loss(params, batch)
    n = cfg["num_hidden_layers"]
    assert get_registry().get("attn.walk") == n
    assert get_registry().get("attn.mla") == n
    want = R.loss(params, batch, R.Spec.of(cfg))
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_fp8_control_fails_the_cells_gap(seed):
    """The reference in fp8 (the step below the configuration's bf16), put
    in the program's place, at a size the CPU holds, against the cell's
    limit; the same readings at the cell's size, on the card, are in
    PERF.md."""
    from portbench.harness import serve, spec
    cell = spec.load_cell("dsv2lite.chat8k")
    cfg = tiny_config(num_hidden_layers=5, hidden_size=128,
                      kv_lora_rank=64, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32,
                      intermediate_size=512, moe_intermediate_size=64,
                      vocab_size=1024)
    params = W.make(cfg, seed, "cpu")
    tokens = torch.randint(0, 1024, (320,),
                           generator=torch.Generator().manual_seed(seed))
    ref, ctl = R.served_logits(params, R.Spec.of(cfg), [tokens],
                               [torch.arange(64, 320)], control=True)
    assert max(serve.gaps(ref, [ctl[0].argmax(-1)])) > cell.limits["gap"]


def test_the_yardsticks_counts_are_the_hand_counts():
    """work_mla at the published widths: per layer W_q 2048 x 3072, W_kva
    2048 x 576, W_kvb 512 x 4096, W_o 2048 x 2048; the dense MLP 3 x 2048
    x 10944; an MoE layer's router 2048 x 64, 6 routed and 2 shared
    experts of 3 x 2048 x 1408."""
    from portbench.harness import spec, work_mla
    cfg = spec.load_cell("dsv2lite.chat8k").config
    attn = 2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048
    moe = 2048 * 64 + 8 * 3 * 2048 * 1408
    assert work_mla.attn_params(cfg) == attn == 13_762_560
    assert work_mla.active_params(cfg) == (27 * attn + 3 * 2048 * 10944
                                           + 26 * moe) == 2_241_593_344
    assert work_mla.head_params(cfg) == 2048 * 102400
    # the published form: 2 x 16 heads x (192 + 128) a key a layer
    assert work_mla.attn_flops(cfg, 10) == 2.0 * 16 * 10 * 320 * 27
    per_token = [work_mla.token_flops(cfg, c, head=False)
                 for c in range(101, 151)]
    assert work_mla.chunk_flops(cfg, 100, 50) == pytest.approx(
        sum(per_token), rel=1e-12)


def _chunks_then_decode(run, model, params, cfg, device="cpu"):
    """Prefill chunks of one row over a cache whose later rows are stale,
    then decode steps of two rows at their own positions, each step
    through ``run(cache, tokens, index)``: the logits (copied, since a
    graph's next replay overwrites its own) and both caches."""
    g = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg["vocab_size"], (2, 40), generator=g)
    toks = toks.to(device)
    one = model.init_cache(1, 48, device=device)
    two = model.init_cache(2, 48, device=device)
    one["layers"]["ckv"][:, :, 30:] = 1.0
    out = []
    with torch.inference_mode():
        for start, w in ((0, 8), (8, 16), (24, 8), (0, 8)):
            out.append(run(one, toks[:1, start:start + w],
                           start)[0].clone())
        pos = torch.tensor([20, 33], device=device)
        for step in range(3):
            cur = torch.stack([toks[0, 20 + step], toks[1, 33 + step]])
            out.append(run(two, cur[:, None], pos + step)[0].clone())
    return out, one, two


def test_a_passs_fixed_form_for_step_graphs_equals_the_plain_call():
    """``serving.graphs``' fixed form, run eagerly: chunks at a per-row
    position over a bucket of 16 keys (stale keys inside it masked),
    decode steps as they are."""
    from repro_torch.serving.graphs import StepGraphs
    cfg, model, params = setup()
    graphs = StepGraphs(model, params, context_step=16)

    def plain(cache, tokens, index):
        return model.decode_step(params, cache, tokens, index)
    want, w1, w2 = _chunks_then_decode(plain, model, params, cfg)
    got, g1, g2 = _chunks_then_decode(graphs.run, model, params, cfg)
    for a, b in zip(got, want):
        assert close(a, b)
    for a, b in ((g1, w1), (g2, w2)):
        assert close(a["layers"]["ckv"], b["layers"]["ckv"])


def test_the_routed_row_sums_are_switched_on_the_device():
    from repro_torch.models import moe
    load = moe.RouteLoad()
    counts = torch.tensor([3, 1, 0, 4])
    load.add(counts, 8)
    assert load.read()["calls"] == 0 and load.rows is None
    with load.recording():          # a graph's capture, switched off
        load.add(counts, 8)
    assert load.read() == {"calls": 0, "rows": [0, 0, 0, 0],
                           "max_share_sum": 0.0}
    rows = load.rows
    load.on = True
    with load.recording():
        load.add(counts, 8)
    load.add(counts, 8)
    assert load.read() == {"calls": 2, "rows": [6, 2, 0, 8],
                           "max_share_sum": 2 * 4 / (8 / 4)}
    load.on = False
    load.add(counts, 8)
    load.reset()
    assert load.rows is rows and load.read()["rows"] == [0, 0, 0, 0]


@pytest.mark.cuda
def test_step_graphs_replay_the_eager_passes_on_the_card():
    """bf16 with the shared experts on the GOMA kernels, as the cell
    serves: each pass's graph gives the eager fixed form's logits and
    caches bit for bit, counts what the eager passes count, and sums the
    routed rows while switched on."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: CUDA graphs run only there")
    from repro_torch.models import build_model, moe
    from repro_torch.obs.registry import get_registry
    from repro_torch.serving.graphs import StepGraphs
    cfg = tiny_config()
    cfg["run"]["compute_dtype"] = "bfloat16"
    model = build_model(arch_config(cfg))
    params = W.make(cfg, 5, "cuda")
    reg = get_registry()
    runs = {}
    for graphed in (False, True):
        graphs = StepGraphs(model, params, context_step=16)
        graphs.failed = not graphed
        reg.reset("attn.")
        reg.reset("moe.")
        moe.ROUTE_LOAD.reset()
        moe.ROUTE_LOAD.on = True
        runs[graphed] = _chunks_then_decode(graphs.run, model, params, cfg,
                                            "cuda")
        moe.ROUTE_LOAD.on = False
        torch.cuda.synchronize()
        runs[graphed] += (reg.get("attn.mla"), reg.get("moe.rows_routed"),
                          moe.ROUTE_LOAD.read())
        assert len(graphs.graphs) == (4 if graphed else 0)
        assert not graphs.failed or not graphed
    (want, w1, w2, *wn), (got, g1, g2, *gn) = runs[False], runs[True]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in ((g1, w1), (g2, w2)):
        assert torch.equal(a["layers"]["ckv"], b["layers"]["ckv"])
    # 7 passes of 8 layers; the graphs' first passes count once
    assert wn[0] == 7 * 8 and gn == wn
    assert gn[2]["calls"] == 7 * 7 and sum(gn[2]["rows"]) == gn[1]
