"""Program capture on the port (``repro_torch.capture``): the twins of
tests/test_capture.py's walk, chain, plan-pass, serving and CLI tests,
and the port's model captures held against the reference's jaxpr capture
of the same smoke configs (GEMM multisets; ROADMAP C1 keeps the
reference's chains out of the comparison, C9 and C10 list the sites the
two packages lower differently; C11, attention past one key block, is
closed).  The paper enumerations are in
test_torch_capture_paper.py."""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.capture import (capture_model_decode,
                                 capture_model_prefill, capture_spec_prefill,
                                 captured_program, plan_program,
                                 serving_capture_shapes)
from repro_torch.capture.plan import captured_spec_plan_shape_groups
from repro_torch.configs import get_config
from repro_torch.core import hopper_mapping as hm
from repro_torch.core.hardware import TEMPLATES
from repro_torch.core.solver import reset_solver_stats, solver_stats
from repro_torch.core.workloads import LlmSpec, scenario_gemms
from repro_torch.models import build_model
from repro_torch.models.model import index_tree
from repro_torch.planner import PlanStore

TINY = LlmSpec("tiny", layers=2, d_model=64, n_heads=4, kv_heads=2,
               head_dim=16, d_ff=128, vocab=512)


@pytest.fixture(autouse=True)
def _no_store_left_behind():
    yield
    hm.set_plan_store(None)


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------------------------------ graph walk

def test_loop_trip_counts_multiply_weights():
    """Python loops unroll: 5 x 3 identical products dedupe to weight 15
    (the reference's nested scans)."""
    w = meta(8, 8)

    def outer(x):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x

    prog = captured_program(outer, meta(4, 8))
    assert prog.gemm_multiset() == {(4, 8, 8): 15}


def test_lhs_batch_dims_flatten_into_m():
    """Leading dims of A alone (what the reference's vmap adds) flatten
    into m, not into the weight: a batched-lhs GEMM is one bigger GEMM."""
    w = meta(8, 16)
    prog = captured_program(lambda x: x @ w, meta(3, 5, 4, 8))
    assert prog.gemm_multiset() == {(60, 16, 8): 1}
    prog = captured_program(lambda x, w: torch.nn.functional.linear(x, w),
                            meta(3, 5, 4, 8), meta(16, 8))
    assert prog.gemm_multiset() == {(60, 16, 8): 1}


def test_shared_batch_dims_flatten_into_weight():
    fn = lambda a, b: torch.einsum("bhsd,bhtd->bhst", a, b)  # noqa: E731
    prog = captured_program(fn, meta(2, 4, 8, 16), meta(2, 4, 8, 16))
    assert prog.gemm_multiset() == {(8, 8, 16): 8}      # B*H repeats
    prog = captured_program(torch.bmm, meta(6, 3, 5), meta(6, 5, 7))
    assert prog.gemm_multiset() == {(3, 7, 5): 6}


def test_einsum_operand_order_follows_jax():
    """jnp.einsum puts the second operand on the left of its dot_general
    when the first's free dims do not lead the output: the attention
    scores' m is the key length, as in the reference's capture."""
    fn = lambda q, k: torch.einsum("bskgh,btkh->bskgt", q, k)  # noqa
    prog = captured_program(fn, meta(2, 3, 2, 4, 8), meta(2, 7, 2, 8))
    assert prog.gemm_multiset() == {(7, 12, 8): 4}
    fn = lambda q, k: torch.einsum("hsd,htd->hst", q, k)  # noqa: E731
    assert captured_program(fn, meta(4, 3, 8), meta(4, 7, 8)) \
        .gemm_multiset() == {(3, 7, 8): 4}


def test_cond_branches_harvested_once_each():
    def fn(pred, x, w):
        return torch.cond(pred, lambda v, w: v @ w,
                          lambda v, w: (v @ w) @ w, (x, w))

    prog = captured_program(fn, meta(dtype=torch.bool), meta(4, 8),
                            meta(8, 8))
    assert prog.gemm_multiset() == {(4, 8, 8): 3}


def test_kernel_wrappers_are_opaque():
    """ops.gemm and ops.fused_mlp are one opaque node each in a trace,
    whatever device the example tensors were on: no plain product leaks
    into the harvest (the reference's pallas_call), and nothing runs."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.goma_gemm import goma_matmul
    before = goma_matmul.launches
    prog = captured_program(lambda a, b: ops.gemm(a, b) @ b.T,
                            torch.zeros(8, 64), torch.zeros(64, 64))
    assert prog.gemm_multiset() == {(8, 64, 64): 1}    # the plain @ only
    prog = captured_program(
        lambda a, g, u, d: ops.fused_mlp(a, g, u, d), meta(8, 64),
        meta(64, 128), meta(64, 128), meta(128, 64))
    assert prog.gemm_multiset() == {} and prog.chains == []
    assert goma_matmul.launches == before
    with pytest.raises(ValueError):
        goma_matmul(meta(64, 64), meta(64, 64), hm.plan_gemm_tiling(
            64, 64, 64, dtype_bytes=4))


# ------------------------------------------------- chain detection

def _mlp(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def _args(m=8, k=4, f=16):
    return meta(m, k), meta(k, f), meta(k, f), meta(f, k)


def test_chain_detected_silu_mul():
    prog = captured_program(_mlp, meta(32, 16), meta(16, 64),
                            meta(16, 64), meta(64, 16))
    assert prog.chain_multiset() == {
        ((32, 64, 16), (32, 16, 64), 2, "silu_mul"): 1}


def test_chain_detected_through_sigmoid_and_casts():
    """silu written as x * sigmoid(x), in bf16 with fp32 casts around the
    activation, is still the silu_mul combine."""
    def fn(x, wg, wu, wd):
        g = x @ wg
        gf = g.to(torch.float32)
        act = (gf * torch.sigmoid(gf)).to(torch.bfloat16)
        return (act * (x @ wu)) @ wd

    args = [t.to(torch.bfloat16) for t in _args()]
    assert [c.chain.elementwise for c in captured_program(fn, *args)
            .chains] == ["silu_mul"]


def test_chain_detected_gelu_and_identity():
    def gelu_mlp(x, wg, wu, wd):
        return (F.gelu(x @ wg, approximate="tanh") * (x @ wu)) @ wd

    def plain(x, w1, w2):
        return (x @ w1) @ w2

    p1 = captured_program(gelu_mlp, *_args())
    assert [c.chain.elementwise for c in p1.chains] == ["gelu_mul"]
    p2 = captured_program(plain, meta(8, 4), meta(4, 16), meta(16, 4))
    assert [(c.chain.producer_count, c.chain.elementwise)
            for c in p2.chains] == [(1, "identity")]


def test_chain_detected_sqrelu():
    def fn(x, wk, wv):
        return torch.square(torch.relu(x @ wk)) @ wv

    prog = captured_program(fn, meta(8, 4), meta(4, 16), meta(16, 4))
    assert prog.chain_multiset() == {
        ((8, 16, 4), (8, 4, 16), 1, "sqrelu_mul"): 1}


def test_chain_not_detected_for_non_kernel_combines():
    def additive(x, wg, wu, wd):
        return (F.silu(x @ wg) + (x @ wu)) @ wd

    def both_activated(x, wg, wu, wd):
        return (F.silu(x @ wg) * F.silu(x @ wu)) @ wd

    for fn in (additive, both_activated):
        assert captured_program(fn, *_args()).chains == []

    def product(x, wg, wu, wd):
        return ((x @ wg) * (x @ wu)) @ wd

    prog = captured_program(product, *_args())
    assert [(c.chain.producer_count, c.chain.elementwise)
            for c in prog.chains] == [(2, "identity")]


def test_chain_not_detected_through_reshape_or_softmax():
    def reshaped(x, w1, w2):
        h = (x @ w1).reshape(4, 2, 8).reshape(8, 8)
        return h @ w2

    def softmaxed(x, w1, w2):
        return torch.softmax(x @ w1, dim=-1) @ w2

    def transposed(x, w1, w2):
        return (x @ w1).T.contiguous() @ w2

    for fn in (reshaped, softmaxed, transposed):
        prog = captured_program(fn, meta(8, 4), meta(4, 8), meta(8, 4))
        assert prog.chains == []


def test_chain_not_detected_when_intermediate_escapes():
    def escaping(x, wg, wu, wd):
        h = F.silu(x @ wg) * (x @ wu)
        return h @ wd, torch.sum(h)

    assert captured_program(escaping, *_args()).chains == []


def test_chain_not_detected_when_a_sibling_output_escapes():
    """A value derived from the producer output outside the path (the
    reference's multi-output call sibling) still needs the intermediate
    written: no chain."""
    def escaping(x, wg, wu, wd):
        h = x @ wg
        a, b = F.silu(h), h * 2
        return (a * (x @ wu)) @ wd, torch.sum(b)

    assert captured_program(escaping, *_args()).chains == []


# ------------------------------------------------ model apply capture

def _layer(cfg, *path):
    model = build_model(cfg)
    params = model.init_params(torch.Generator(), "meta")
    lp = index_tree(params["layers"], 0)
    for p in path:
        lp = lp[p]
    return lp


def test_capture_moe_apply():
    from repro_torch.models.moe import moe_apply
    cfg = get_config("deepseek-moe-16b", smoke=True)
    p = _layer(cfg, "moe")
    prog = captured_program(lambda p, x: moe_apply(p, cfg, x)[0], p,
                            meta(1, 8, cfg.d_model), name="moe")
    ms = prog.gemm_multiset()
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    assert ms[(8, E, d)] == 1                  # router
    assert ms[(8, E * ff, d)] == 2             # gate + up (dense dispatch)
    # the shared experts' MLP; the routed experts' down product runs
    # after a permute (ROADMAP C9), so their chain is not a chain here
    assert prog.chains


def test_capture_ssm_apply():
    from repro_torch.models.ssm import ssm_apply, ssm_dims
    cfg = get_config("zamba2-2.7b", smoke=True)
    d_inner, nh, hd, ns = ssm_dims(cfg)
    p = _layer(cfg, "ssm")
    S = 16
    prog = captured_program(lambda p, x: ssm_apply(p, cfg, x)[0], p,
                            meta(1, S, cfg.d_model), name="ssm")
    ms = prog.gemm_multiset()
    proj_out = 2 * d_inner + 2 * ns + nh
    assert ms[(S, proj_out, cfg.d_model)] == 1     # in_proj
    assert ms[(S, cfg.d_model, d_inner)] == 1      # out_proj
    assert len(ms) > 2                             # SSD scan contractions


def test_capture_rwkv_applies():
    from repro_torch.models.rwkv import rwkv_channel_apply, rwkv_time_apply
    cfg = get_config("rwkv6-7b", smoke=True)
    d, ff, S = cfg.d_model, cfg.d_ff, 16
    x = meta(1, S, d)
    time_prog = captured_program(
        lambda p, x: rwkv_time_apply(p, cfg, x)[0], _layer(cfg, "time"), x)
    assert time_prog.gemm_multiset()[(S, d, d)] == 6
    chan_prog = captured_program(
        lambda p, x: rwkv_channel_apply(p, cfg, x)[0], _layer(cfg, "chan"),
        x)
    ms = chan_prog.gemm_multiset()
    assert ms[(S, ff, d)] == 1 and ms[(S, d, ff)] == 1
    assert chan_prog.chain_multiset() == {
        ((S, ff, d), (S, d, ff), 1, "sqrelu_mul"): 1}


# ROADMAP C9 and C10: the sites the two packages lower differently at
# the smoke configs (prefill: batch 2 x 16 tokens against a cache of 32;
# decode: batch 2 against 32), as (reference only, port only).  C9: the
# reference's routed experts' down product is one three-operand einsum
# (per expert (d, T, ff) products, then the combine contracted over the
# experts), the port's one (T, E * ff) @ (E * ff, d) product.  C10: the
# reference's chunked scans (models/rwkv.py, models/ssm.py) are
# three-operand einsums, the port's plain scans (kernels/wkv6.py,
# mamba2_ssd.py) follow the kernels' algorithm.
LOWERED_APART = {
    ("deepseek-moe-16b", "prefill"): ({(1, 64, 4): 64, (64, 32, 128): 8},
                                      {(32, 64, 512): 2}),
    ("deepseek-moe-16b", "decode"): ({(1, 64, 4): 4, (64, 2, 128): 8},
                                     {(2, 64, 512): 2}),
    ("rwkv6-7b", "prefill"): ({(1, 1, 64): 128, (8, 1, 64): 128}, {}),
    ("zamba2-2.7b", "prefill"): ({(8, 16, 1): 128, (8, 16, 8): 128,
                                  (8, 16, 16): 128},
                                 {(8, 128, 16): 16, (16, 8, 8): 128}),
}


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("arch,fused", [
    ("llama3-8b", False), ("llama3-8b", True), ("deepseek-moe-16b", False),
    ("rwkv6-7b", False), ("zamba2-2.7b", True), ("gemma2-27b", True),
    ("llava-next-34b", True), ("seamless-m4t-medium", False)])
def test_model_capture_gemms_equal_the_reference(arch, fused, phase):
    """The port's capture_model_{prefill,decode} harvest the reference's
    GEMM multiset on the same smoke config, weights included, apart from
    the listed lowering differences; with the fused MLP the kernel is
    opaque in both."""
    from repro.capture import plan as ref_plan
    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model
    jmodel = jbuild_model(dataclasses.replace(
        jget_config(arch, smoke=True), fused_mlp=fused))
    tmodel = build_model(dataclasses.replace(get_config(arch, smoke=True),
                                             fused_mlp=fused))
    if phase == "prefill":
        ref = ref_plan.capture_model_prefill(jmodel, 2, 16, cache_len=32)
        got = capture_model_prefill(tmodel, 2, 16, cache_len=32)
    else:
        ref = ref_plan.capture_model_decode(jmodel, 2, 32)
        got = capture_model_decode(tmodel, 2, 32)
    r, g = ref.gemm_multiset(), got.gemm_multiset()
    apart = ({d: w for d, w in r.items() if g.get(d) != w},
             {d: w for d, w in g.items() if r.get(d) != w})
    assert apart == LOWERED_APART.get((arch, phase), ({}, {}))
    assert len(g) > 2


def test_attention_past_one_key_block_is_the_only_other_difference():
    """ROADMAP C11, closed: past 512 cache positions the port's attention
    walks the keys in blocks of 512 as the reference's does (the last
    block padded to the full width), so at a cache of 1200 the GEMM
    multisets are equal, the three blocks' attention products included."""
    from repro.capture import plan as ref_plan
    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model
    ref = ref_plan.capture_model_decode(
        jbuild_model(jget_config("llama3-8b", smoke=True)), 2, 1200)
    got = capture_model_decode(
        build_model(get_config("llama3-8b", smoke=True)), 2, 1200)
    r, g = ref.gemm_multiset(), got.gemm_multiset()
    assert g == r
    assert g[(512, 4, 16)] == g[(16, 4, 512)] == 12


def test_full_width_capture_is_shape_level():
    """llama3-8b at full width (32 layers): the scheduler's decode
    program is captured on meta tensors, every projection at 8 rows, the
    attention products against the 272-position cache."""
    model = build_model(get_config("llama3-8b"))
    prog = capture_model_decode(model, 8, 272, slot_indexed=True)
    ms = prog.gemm_multiset()
    assert ms[(8, 4096, 4096)] == 2 * 32             # wq, wo
    assert ms[(8, 1024, 4096)] == 2 * 32             # wk, wv
    assert ms[(8, 14336, 4096)] == 2 * 32            # wg, wu
    assert ms[(8, 128256, 4096)] == 1                # lm head
    assert ms[(272, 4, 128)] == 8 * 8 * 32           # scores: B x KV x L


# ------------------------------------------------------ plan pass

def test_plan_program_zero_gap(tmp_path):
    hw = TEMPLATES["gemmini-like"]
    prog = capture_spec_prefill(TINY, 64)
    store = PlanStore(tmp_path)
    plan = plan_program(prog, hw, store=store, jobs=1)
    assert plan.feasible and plan.zero_gap
    assert len(plan.manifest.entries) == len(prog.gemms)
    assert len(plan.chain_rows) == len(prog.chains) == 1
    for e in store.entries():
        assert e.certificate.gap == 0.0
    assert store.num_fused() == 1
    reset_solver_stats()
    plan2 = plan_program(prog, hw, store=store, jobs=1)
    assert solver_stats()["calls"] == 0
    assert all(e.cached for e in plan2.manifest.entries)


def test_batch_planner_solves_each_unique_shape_once():
    from repro_torch.planner.batch import BatchPlanner
    hw = TEMPLATES["gemmini-like"]
    rows = scenario_gemms(TINY, prefill_seqs=(64, 64, 128),
                          decode_batches=(4,), cache_len=256)
    keys = {(t, g) for t, g, _ in rows}
    assert len(keys) == len(rows)
    unique_dims = {g.dims for _, g, _ in rows}
    planner = BatchPlanner(None, jobs=1, warm_start=False)
    reset_solver_stats()
    entries = planner.plan_gemms(rows, hw)
    assert solver_stats()["calls"] == len(unique_dims)
    assert planner.last_report.unique_gemms == len(unique_dims)
    assert len(entries) == len(unique_dims)


def test_workloads_program_helpers_resolve_to_the_ports_ir():
    """core/workloads.py is the reference's file verbatim; its *_program
    helpers import ``capture.program`` relative to the package, so in the
    port they build the port's PlanProgram."""
    from repro_torch.capture.program import PlanProgram
    from repro_torch.core.workloads import (arch_decode_program,
                                            arch_program, decode_program,
                                            prefill_program,
                                            scenario_program)
    progs = [prefill_program(TINY, 64), decode_program(TINY, 4, 256),
             scenario_program(TINY, prefill_seqs=(64,)),
             arch_program("llama3-8b", seq=64),
             arch_decode_program("llama3-8b", batch=4, cache_len=256)]
    assert all(type(p) is PlanProgram and p.source == "enumerated"
               for p in progs)
    assert all(p.gemms for p in progs)


# ------------------------------------------------ serving integration

def test_engine_prewarm_routes_through_capture(tmp_path):
    from repro_torch.serving import Engine, ServeConfig
    cfg = get_config("llama3-8b", smoke=True)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    store = PlanStore(tmp_path)
    engine = Engine(model, params, ServeConfig(cache_len=32),
                    plan_store=store)
    n = engine.prewarm_plans(None, 1, 8)          # captured: no arch_id
    shapes = serving_capture_shapes(model, 1, 8, 32)
    assert n == len(shapes) > 0
    assert len(store) > 0


def test_spec_groups_include_the_drafters_programs():
    """With a draft model, the captured spec groups hold the target's
    verify window and the drafter's own width-1 decode and catch-up
    chunk, each read off a traced program."""
    target = build_model(get_config("llama3-8b", smoke=True))
    draft = build_model(dataclasses.replace(
        get_config("llama3-8b", smoke=True), layers=1))
    groups = captured_spec_plan_shape_groups(
        target, batch=3, cache_len=64, spec_widths=(4,), draft_model=draft)
    assert sorted(groups) == ["draft.chunk4", "draft.decode", "verify4"]
    assert groups["verify4"] == capture_model_decode(
        target, 3, 64, width=4, slot_indexed=True).shapes()
    assert groups["draft.decode"] == capture_model_decode(
        draft, 1, 64, slot_indexed=True).shapes()
    assert (12, target.cfg.d_model, target.cfg.d_model) in \
        groups["verify4"]


def test_scheduler_model_drafter_prewarm_puts_the_drafters_groups(
        tmp_path):
    """The scheduler with a ModelDrafter and the capture source prewarms
    the drafter's groups through the store; its replay then makes no
    solver call and no store miss."""
    import numpy as np
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.router import ModelDrafter
    from repro_torch.serving.sched import (ContinuousScheduler, Request,
                                           SchedConfig, TraceClock,
                                           replay)
    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                              fused_mlp=True)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    dparams = model.init_params(torch.Generator().manual_seed(1), "cpu")
    store = PlanStore(tmp_path)
    scfg = ServeConfig(cache_len=64)
    drafter = ModelDrafter(Engine(model, dparams, scfg, plan_store=store))
    clock = TraceClock()
    sched = ContinuousScheduler(
        Engine(model, params, scfg, plan_store=store),
        SchedConfig(slots=3, chunk_widths=(4, 16), spec_width=4),
        drafter=drafter, clock=clock.now)
    assert {"draft.decode", "draft.chunk4", "verify4"} <= \
        set(sched._plan_groups)
    rng = np.random.default_rng(0)
    reqs = [Request(req_id=i, tokens=rng.integers(0, cfg.vocab, (9,)),
                    max_new_tokens=5) for i in range(4)]
    reset_solver_stats()
    misses = store.misses
    results = replay(sched, reqs, clock)
    assert len(results) == 4
    assert solver_stats()["calls"] == 0 and store.misses == misses


# --------------------------------------------------------------- CLI

def test_cli_capture_and_fused_inspect_verify(tmp_path, capsys):
    from repro_torch.core.fusion import mlp_chain
    from repro_torch.planner.batch import cached_solve_chain
    from repro_torch.planner.cli import main
    db = str(tmp_path / "db")
    rc = main(["capture", "--arch", "stablelm-1.6b", "--smoke",
               "--phase", "decode", "--batch", "2", "--cache-len", "64",
               "--hw", "gemmini-like", "--store", db, "--jobs", "1",
               "--manifest", str(tmp_path / "m.json")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[program]" in out and "[manifest]" in out
    store = PlanStore(db)
    n0 = store.num_fused()
    assert n0 >= 1                # captured chain landed in fused/
    cached_solve_chain(mlp_chain(64, 128, 64, name="t"),
                       TEMPLATES["gemmini-like"], store=store)
    assert store.num_fused() == n0 + 1
    assert main(["inspect", "--store", db, "-v"]) == 0
    out = capsys.readouterr().out
    assert "fused chain plans" in out
    assert main(["verify", "--store", db]) == 0
    out = capsys.readouterr().out
    assert "chain certificates verified" in out and "FAILED" not in out
