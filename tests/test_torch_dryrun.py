"""The port's program analyzer, Hopper roofline and meta-device dry-run
(``repro_torch.launch.{hlo_analysis,roofline,dryrun}``) against the
reference's ``launch/{hlo_analysis,roofline,dryrun}.py``.

- ``analyze_program`` counts a hand-made loop of 5 matmuls of 8 x 16 x 16
  at 5 x 2 x 8 x 16 x 16 flops, with its exact argument and output bytes
  and a temp peak of one live intermediate; a training step's remat
  recompute adds one forward's products; the kernel wrappers report
  their own work on meta tensors.
- Each ring formula equals the reference's ``parse_collectives`` on an
  HLO line of that collective; the ``Roofline`` terms and bottleneck on
  the H100 constants as ``tests/test_sharding_dryrun.py`` checks the
  reference's; ``model_flops_estimate`` equals the reference's for every
  (arch, shape).
- Every smoke config's prefill and decode contraction flops equal the
  reference's ``analyze_hlo`` flops of a one-device CPU compile of the
  same function, apart from ROADMAP C9 (the MoE down product) and C10
  (the RWKV chunked scan), whose differences the test computes.
- On a (2, 2) mesh (gloo ranks, ``tests/torch_train_ranks.py``) a cell's
  program run for real makes the collectives by kind, calls and bytes,
  that its dry-run counts on meta tensors, with the same argument bytes.
- ``python -m repro_torch.launch.dryrun`` writes llama3-8b ``decode_32k``
  on pod256 at full width to ``--out`` (nothing under ``benchmarks/``)
  with the reference's keys; a skipped shape is recorded as skipped.
"""
import dataclasses
import json
import math
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.roofline import model_flops_estimate as jmodel_flops
from repro.launch.roofline import parse_collectives
from repro.models import build_model as jbuild_model
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, get_config
from repro_torch.dist.serve import shard_model
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import analyze_program
from repro_torch.launch.mesh import HostMesh
from repro_torch.launch.roofline import (HBM_BW, NVLINK_BW, PEAK_FLOPS,
                                         Roofline, collective_stats,
                                         model_flops_estimate,
                                         ring_link_bytes)
from repro_torch.models import build_model
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import jit_train_step
from torch_train_ranks import run_worlds

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, S, T = 2, 16, 32          # smoke prefill batch x prompt, cache


def test_five_matmuls_read_their_flops():
    def prog(x, w):
        for _ in range(5):
            x = torch.tanh(x @ w)
        return x
    res = analyze_program(prog, torch.zeros(8, 16), torch.zeros(16, 16))
    assert res["flops"] == 5 * 2 * 8 * 16 * 16
    assert res["flops_by_dtype"] == {"float32": 5 * 2 * 8 * 16 * 16}
    assert res["memory"]["argument_size_in_bytes"] == (8 * 16 + 16 * 16) * 4
    assert res["memory"]["output_size_in_bytes"] == 8 * 16 * 4
    # a matmul's result lives until its tanh has read it
    assert res["memory"]["temp_size_in_bytes"] == 2 * 8 * 16 * 4
    # each mm reads x and w and writes x; each tanh reads and writes x
    assert res["bytes"] == 5 * (2 * 8 * 16 + 16 * 16 + 2 * 8 * 16) * 4
    assert res["ops"] == 10


def test_train_step_counts_forward_recompute_and_backward():
    """Without remat a step runs its forward's products three times (the
    forward and the backward's two a product); with remat also the layer
    bodies' recompute, which torch's non-reentrant checkpoint stops once
    the backward's saved tensors are back: the last product of a layer
    (the MLP's down projection, whose output the backward does not read)
    and the LM head outside the layers are not recomputed."""
    cfg = get_config("llama3-8b", smoke=True)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(), "meta", masters=True)
    batch = model.input_specs(ShapeSpec("t", 16, 2, "train"))
    flops = {}
    for remat in (False, True):
        step = jit_train_step(model, opt.AdamWConfig(), remat=remat)
        flops[remat] = analyze_program(step, params,
                                       opt.init_state(params),
                                       batch)["flops"]

    def forward(params, batch):
        return model.loss(params, batch, remat=False)
    fwd = analyze_program(forward, params, batch)["flops"]
    tokens = 2 * 16
    head = 2 * tokens * cfg.d_model * cfg.vocab
    down = cfg.layers * 2 * tokens * cfg.d_ff * cfg.d_model
    assert flops[False] == 3 * fwd
    assert flops[True] == 4 * fwd - head - down


def test_inference_mode_counts_as_no_grad():
    """Under inference_mode composite ops (matmul, einsum, casts) reach
    the recorder whole; it runs their decompositions, so a decode step
    counts the same ops either way."""
    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                              fused_mlp=True)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(), "meta")
    res = {}
    for ctx in (torch.no_grad, torch.inference_mode):
        def step(params, cache, tok, ctx=ctx):
            with ctx():
                return model.decode_step(params, cache, tok, 7)
        res[ctx] = analyze_program(step, params, model.init_cache(
            2, 8, "meta"), torch.empty((2, 1), dtype=torch.int64,
                                       device="meta"))
        res[ctx].pop("trace_s")
    assert res[torch.no_grad] == res[torch.inference_mode]
    assert res[torch.no_grad]["kernels"]["goma_fused_matmul"]["calls"] == \
        cfg.layers


def test_kernel_wrappers_report_their_work_on_meta():
    """The fused MLP's B1 composition at llama3-8b's widths (unfused) and
    the scans: each call's shape and work, with no launch."""
    from repro_torch.kernels import goma_matmul, ops, ssd_scan, wkv6_scan
    from repro_torch.kernels.mamba2_ssd import ssd_bytes, ssd_work
    from repro_torch.kernels.wkv6 import wkv6_bytes, wkv6_work
    before = goma_matmul.launches
    a = torch.empty((4, 4096), dtype=torch.bfloat16, device="meta")
    wg = torch.empty((4096, 14336), dtype=torch.bfloat16, device="meta")
    wd = torch.empty((14336, 4096), dtype=torch.bfloat16, device="meta")

    def mlp(a, wg, wu, wd):
        with torch.no_grad():
            return ops.fused_mlp(a, wg, wu, wd)
    res = analyze_program(mlp, a, wg, wg.clone(), wd)
    k = res["kernels"]
    assert k["goma_matmul"] == {"calls": 3, "shapes": {
        "4x14336x4096": 2, "4x4096x14336": 1}}
    assert k["goma_combine"]["calls"] == 1
    assert res["flops_by_dtype"]["bfloat16"] == 3 * 2 * 4 * 4096 * 14336
    assert goma_matmul.launches == before
    r = torch.empty((1, 64, 2, 64), device="meta")
    u = torch.empty((2, 64), device="meta")
    res = analyze_program(lambda *t: wkv6_scan(*t, chunk=32), r, r, r, r, u)
    assert res["flops_by_dtype"] == {"tf32": wkv6_work(1, 64, 2, 64)[0]}
    assert res["other_ops"] == wkv6_work(1, 64, 2, 64)[1]
    assert res["bytes"] == wkv6_bytes(1, 64, 2, 64, 4)
    xh = torch.empty((1, 64, 2, 16), device="meta")
    dt = torch.empty((1, 64, 2), device="meta")
    bm = torch.empty((1, 64, 16), device="meta")
    res = analyze_program(lambda *t: ssd_scan(*t, chunk=32), xh, dt,
                          torch.empty(2, device="meta"), bm, bm)
    assert res["flops_by_dtype"] == {"tf32": ssd_work(1, 64, 2, 16, 16)[0]}
    assert res["bytes"] == ssd_bytes(1, 64, 2, 16, 16, 4)


_HLO_OPS = {"all-reduce": "all-reduce", "all-gather": "all-gather",
            "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
            "collective-permute": "collective-permute-start"}


@pytest.mark.parametrize("kind", list(_HLO_OPS))
@pytest.mark.parametrize("group", [1, 4, 16])
def test_ring_formula_is_the_references(kind, group):
    groups = ",".join(map(str, range(group)))
    line = (f"  %c = f32[256,8]{{1,0}} {_HLO_OPS[kind]}(f32[256,8]{{1,0}} "
            f"%p), replica_groups={{{{{groups}}}}}, to_apply=%add")
    want = parse_collectives(line, num_devices=group).ops[kind]
    assert ring_link_bytes(kind, 256 * 8 * 4, group) == pytest.approx(
        want["link_bytes"])


def test_collective_stats_charge_each_kind_as_its_collective():
    comm = {"tp_sum": {"calls": 3, "bytes": 3 * 4096},
            "fsdp_gather": {"calls": 2, "bytes": 2 * 8192},
            "reduce_scatter": {"calls": 2, "bytes": 2 * 8192},
            "data_mean": {"calls": 0, "bytes": 0}}
    got = collective_stats(comm, {"tp_sum": 4, "fsdp_gather": 8,
                                  "reduce_scatter": 8, "data_mean": 8})
    assert got.ops["all-reduce"]["link_bytes"] == 3 * 2 * 4096 * 3 / 4
    assert got.ops["all-gather"]["link_bytes"] == 2 * 8192 * 7 / 8
    # the rank's block of the reduced tensor is the result
    assert got.ops["reduce-scatter"]["link_bytes"] == 2 * 8192 / 8 * 7
    assert got.link_bytes == sum(v["link_bytes"] for v in got.ops.values())


def test_roofline_terms_on_hopper_constants():
    bf16 = PEAK_FLOPS["bfloat16"]
    rl = Roofline(flops=bf16, hbm_bytes=HBM_BW, link_bytes=NVLINK_BW,
                  chips=256, model_flops=bf16 * 256)
    assert rl.t_compute == pytest.approx(1.0)
    assert rl.t_memory == pytest.approx(1.0)
    assert rl.t_collective == pytest.approx(1.0)
    assert rl.roofline_fraction == pytest.approx(1.0)
    rl2 = Roofline(flops=1e12, hbm_bytes=HBM_BW * 10, link_bytes=0,
                   chips=256, model_flops=1e12 * 256)
    assert rl2.bottleneck == "memory"
    # each dtype over its own unit's peak
    rl3 = Roofline(flops=bf16 + 67e12, hbm_bytes=0, link_bytes=0, chips=1,
                   flops_by_dtype={"bfloat16": bf16, "float32": 67e12})
    assert rl3.t_compute == pytest.approx(2.0)
    assert rl3.bottleneck == "compute"
    assert (bf16, PEAK_FLOPS["float32"], PEAK_FLOPS["tf32"], HBM_BW,
            NVLINK_BW) == (989e12, 67e12, 495e12, 3.35e12, 450e9)


def test_model_flops_estimate_is_the_references():
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for name, shape in SHAPES.items():
            assert model_flops_estimate(cfg, shape, 10**9) == \
                jmodel_flops(jcfg, JSHAPES[name], 10**9), (arch, name)


def _reference_flops(arch: str) -> tuple[float, float]:
    """The reference's analyze_hlo flops of a one-device CPU compile of the
    smoke config's prefill into a cache of its prompt (as the dry-run's
    cell) and of one decode step at position T - 1 of a T cache (the
    logits and the cache returned)."""
    cfg = jget_config(arch, smoke=True)
    model = jbuild_model(cfg)
    params = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0)))
    cdt = jnp.dtype(cfg.compute_dtype)
    sds = jax.ShapeDtypeStruct
    batch = {"tokens": sds((B, S), jnp.int32)}
    extra = cfg.frontend_len if cfg.family == "vlm" else 0
    if cfg.family == "encdec":
        batch["frames"] = sds((B, cfg.frontend_len or S, cfg.d_model), cdt)
    if cfg.family == "vlm":
        batch["patches"] = sds((B, cfg.frontend_len, cfg.d_model), cdt)
    pre = jax.jit(lambda p, b: model.prefill(p, b, max_len=S + extra))
    cache = jax.eval_shape(lambda: model.init_cache(B, T))
    if cfg.family == "encdec":
        cache = {**cache,
                 "enc_out": sds((B, cfg.frontend_len or S, cfg.d_model),
                                cdt)}
    dec = jax.jit(lambda p, c, t: model.decode_step(p, c, t, T - 1))
    return (analyze_hlo(pre.lower(params, batch).compile().as_text())
            ["flops"],
            analyze_hlo(dec.lower(params, cache, sds((B, 1), jnp.int32))
                        .compile().as_text())["flops"])


def _port_flops(arch: str) -> tuple[float, ...]:
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    out = []
    for kind, seq in (("prefill", S), ("decode", T)):
        fn, args, _ = dryrun.cell_program(model, cfg,
                                          ShapeSpec(kind, seq, B, kind))
        out.append(analyze_program(fn, *args)["flops"])
    return tuple(out)


def _lowering_gap(arch: str) -> tuple[float, float]:
    """The reference's flops less the port's, by ROADMAP entry: C9, the
    reference's three-operand MoE down product, splits into the expert
    products and a second product with the combine weights (2 T E d a
    layer, T the tokens); C10, the reference's chunked WKV scan takes the
    scores (2 B S C H P a layer, C the chunk) and the bonus (2 B S H P) as
    products, where the port's plain scan sums them elementwise."""
    cfg = get_config(arch, smoke=True)
    if cfg.n_experts:
        return tuple(cfg.layers * 2 * t * cfg.n_experts * cfg.d_model
                     for t in (B * S, B))
    if cfg.family == "rwkv":
        H, P = cfg.d_model // 64, 64
        C = min(cfg.ssd_chunk, S)
        return cfg.layers * (2 * B * S * C * H * P + 2 * B * S * H * P), 0
    return 0, 0


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_smoke_contraction_flops_are_the_references(arch):
    (rp, rd), (pp, pd) = _reference_flops(arch), _port_flops(arch)
    gp, gd = _lowering_gap(arch)
    assert rp - pp == gp and rd - pd == gd, (rp, pp, rd, pd)


# the (2, 2) mesh's cells: (arch, config overrides, shape kind, seq,
# rank rows); llama3-8b widened so that FSDP splits leaves
MESH_CELLS = [("llama3-8b", {"d_ff": 1024, "vocab": 1024}, k, 16, 2)
              for k in ("train", "prefill", "decode")] + [
    ("deepseek-moe-16b", {}, "train", 8, 2),
    ("zamba2-2.7b", {}, "train", 16, 2),
    ("rwkv6-7b", {}, "prefill", 16, 2)]


def _mesh_cell(cell, rank: int):
    arch, over, kind, seq, rows = cell
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    mesh = HostMesh(shape={"data": 2, "model": 2},
                    axis_names=("data", "model"), rank=rank,
                    coords={"data": rank // 2, "model": rank % 2})
    model = shard_model(build_model(cfg), mesh, mode="fsdp")
    return dryrun.cell_program(model, cfg, ShapeSpec(kind, seq, rows, kind))


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dryrun_mesh")
    torch.save([dict(kind="program", arch=a, overrides=o, mesh=(2, 2),
                     mode="fsdp", shape=k, seq=s, batch=r)
                for a, o, k, s, r in MESH_CELLS], root / "jobs.pt")
    return [list(r) for r in zip(*run_worlds({4: root})[4])]


@pytest.mark.parametrize("index", range(len(MESH_CELLS)),
                         ids=[f"{a}-{k}" for a, _, k, _, _ in MESH_CELLS])
def test_dry_run_collectives_are_a_gloo_runs(mesh_runs, index):
    """Every rank's collectives by kind (calls, bytes) and argument bytes
    in the dry-run on meta tensors equal that rank's real run's."""
    for rank, real in enumerate(mesh_runs[index]):
        fn, args, comm = _mesh_cell(MESH_CELLS[index], rank)
        res = analyze_program(fn, *args)
        got = {k: {"calls": v["calls"], "bytes": v["bytes"]}
               for k, v in comm().items() if v["calls"]}
        assert got == real["comm"], (rank, got, real["comm"])
        assert got, "the mesh's cell made no collective"
        assert res["memory"]["argument_size_in_bytes"] == \
            real["argument_bytes"]


def test_dry_run_cli_writes_a_full_width_cell(tmp_path):
    """llama3-8b decode_32k on pod256 at full width, on meta tensors: one
    record with the reference's keys and the Hopper roofline, in --out
    only; then a skipped shape."""
    bench = ROOT / "benchmarks"
    before = sorted(p for p in bench.rglob("*")) if bench.exists() else []
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3-8b", "--shape", "decode_32k", "--mesh", "pod256", "--out",
         str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "CUDA_VISIBLE_DEVICES": ""}, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "dry-run: 1 ok, 0 skipped, 0 errors" in res.stdout
    assert (sorted(p for p in bench.rglob("*")) if bench.exists()
            else []) == before
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == ["llama3-8b_decode_32k_pod256_fsdp.json"]
    rec = json.loads(files[0].read_text())
    assert {"cell", "status", "arch", "shape", "mesh", "sharding", "chips",
            "n_params", "lower_s", "compile_s", "memory", "cost",
            "hlo_analysis", "collectives", "roofline"} <= set(rec)
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["n_params"] == 8030261248
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes"):
        assert rec["memory"][k] > 0
    rl = rec["roofline"]
    assert rl["t_memory_s"] == pytest.approx(rec["hlo_analysis"]["bytes"]
                                             / HBM_BW)
    assert rl["t_compute_s"] == pytest.approx(sum(
        f / PEAK_FLOPS[d] for d, f in
        rec["hlo_analysis"]["flops_by_dtype"].items()))
    assert rl["t_collective_s"] == pytest.approx(
        rec["collectives"]["link_bytes"] / NVLINK_BW)
    # one rank's 8 rows of the 128: the TP sums, the logits gather and
    # every layer's FSDP gathers, with the ring's link bytes
    kinds = {k for op in rec["collectives"]["ops"].values()
             for k in op["kinds"]}
    assert kinds == {"tp_sum", "logits_gather", "fsdp_gather"}
    assert rec["rank_batch"] == 8
    rec = dryrun.run_cell("llama3-8b", "long_500k", False, out_dir=tmp_path)
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
    assert math.isfinite(rl["roofline_fraction"])
