"""Tensor-parallel serving in the port against the reference, on the CPU.

- The rule twin (``repro_torch.sharding.rules``) gives the reference's
  spec for every parameter and cache leaf of every config in ``ARCHS``,
  full (shapes by ``jax.eval_shape``) and smoke, on the meshes (1, 2),
  (1, 4), (2, 2), (4, 2) and the production meshes; strict mode raises
  where the reference's does.
- A rank's local slice is the block of the whole tensor that its spec
  and mesh coordinates name; the execution layout differs from the rule
  specs only where the rule cuts inside an attention head (ROADMAP C13)
  and where it splits packed or gating columns of the recurrent mixers
  (C14), for every family.
- One subprocess per world size (2 and 4) spawns gloo ranks with a
  ``file://`` rendezvous in a temporary directory and serves the smoke
  configs sharded: greedy tokens equal the single-rank port's and the
  JAX engine's, fp32 prefill logits are within 1e-5 of the single-rank
  port's (the all-reduces reassociate the sums), all-reduce counts are
  exact, and there are no solver calls after the prewarm.
- The mesh's refusals: nccl with fewer cards than ranks, a mesh that does
  not tile the world.  ``shard_engine(mode="fsdp")`` is held in
  ``test_torch_fsdp.py``.

The other families under TP are in ``test_torch_dist_families.py``, the
scheduler and the router under TP in ``test_torch_dist_sched.py``.
"""
import dataclasses
import datetime
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro.sharding import rules as jrules
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import HostMesh, make_host_mesh, \
    make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.parallel import TensorParallel, ssm_columns
from repro_torch.serving import Engine, ServeConfig
from repro_torch.sharding import rules

ROOT = pathlib.Path(__file__).resolve().parent.parent
MESHES = [(1, 2), (1, 4), (2, 2), (4, 2)]
LOGIT_TOL = 1e-5


def _mesh(data: int, model: int, rank: int = 0) -> HostMesh:
    """A (data, model) mesh description at rank ``rank``'s coordinates,
    data-major, with no process group."""
    return HostMesh(shape={"data": data, "model": model},
                    axis_names=("data", "model"), rank=rank,
                    coords={"data": rank // model, "model": rank % model})


def _all_meshes():
    return [_mesh(d, m) for d, m in MESHES] + [
        make_production_mesh(), make_production_mesh(multi_pod=True)]


def _jleaves(tree) -> dict:
    flat, _ = jrules._flatten_with_paths(tree)
    return {path: tuple(leaf.shape) for path, leaf in flat}


def _tleaves(tree: dict) -> dict:
    return dict(rules.flatten_with_paths(tree))


CONFIGS = [(a, s) for a in ARCHS for s in (False, True)]


@pytest.mark.parametrize("arch,smoke", CONFIGS,
                         ids=[f"{a}-{'smoke' if s else 'full'}"
                              for a, s in CONFIGS])
def test_rule_twin_equals_the_reference(arch, smoke):
    """Every parameter and cache leaf of the config: the port's leaf paths
    and shapes are the reference's, and spec_for_param, sanitize_spec,
    apply_fsdp, param_shardings and cache_spec give the reference's spec
    on every mesh."""
    jmodel = jbuild_model(jget_config(arch, smoke=smoke))
    jparams = _jleaves(jax.eval_shape(jmodel.init_params,
                                      jax.random.PRNGKey(0)))
    jcache = _jleaves(jax.eval_shape(lambda: jmodel.init_cache(2, 64)))
    tmodel = build_model(get_config(arch, smoke=smoke))
    tparams = tmodel.init_params(torch.Generator(), "meta")
    tcache = tmodel.init_cache(2, 64, device="meta")
    assert {p: tuple(t.shape) for p, t in _tleaves(tparams).items()} \
        == jparams
    assert {p: tuple(t.shape) for p, t in _tleaves(tcache).items()} \
        == jcache
    for mesh in _all_meshes():
        by_mode = {m: _tleaves(rules.param_shardings(tparams, mesh, mode=m))
                   for m in ("tp", "fsdp")}
        for path, shape in jparams.items():
            spec = jrules.spec_for_param(path, len(shape))
            assert tuple(rules.spec_for_param(path, len(shape))) \
                == tuple(spec), path
            assert tuple(rules.spec_for_param(path, len(shape),
                                              strict=True)) == tuple(spec)
            sane = jrules.sanitize_spec(spec, shape, mesh)
            assert tuple(rules.sanitize_spec(rules.P(*spec), shape, mesh)) \
                == tuple(sane), (path, mesh.shape)
            fsdp = jrules.apply_fsdp(sane, shape, mesh)
            assert tuple(rules.apply_fsdp(rules.P(*sane), shape, mesh)) \
                == tuple(fsdp), (path, mesh.shape)
            assert tuple(by_mode["tp"][path]) == tuple(sane)
            assert tuple(by_mode["fsdp"][path]) == tuple(fsdp)
        port_cache = _tleaves(rules.cache_shardings(tcache, mesh))
        for path, shape in jcache.items():
            assert tuple(rules.cache_spec(path, shape, mesh)) == tuple(
                jrules.cache_spec(path, shape, mesh)), (path, mesh.shape)
            assert tuple(port_cache[path]) == tuple(
                jrules.cache_spec(path, shape, mesh))
        batch = {"tokens": torch.zeros(8, 16), "lens": torch.zeros(6),
                 "one": torch.zeros(1, 16)}
        for path, spec in rules.flatten_with_paths(
                rules.data_shardings(batch, mesh)):
            assert tuple(spec) == tuple(jrules.batch_spec(
                tuple(batch[path].shape), mesh))
        assert tuple(rules.batch_spec((), mesh)) == tuple(
            jrules.batch_spec((), mesh))


def test_strict_raises_on_an_unknown_path_as_the_reference_does():
    with pytest.raises(ValueError, match="no sharding rule"):
        jrules.spec_for_param("layers/novel/w", 3, strict=True)
    with pytest.raises(ValueError, match="no sharding rule"):
        rules.spec_for_param("layers/novel/w", 3, strict=True)
    assert tuple(rules.spec_for_param("layers/novel/w", 3)) == ()
    params = {"embed": {"e": torch.zeros(8, 4)},
              "novel": {"w": torch.zeros(4, 4)}}
    with pytest.raises(ValueError, match="no sharding rule"):
        rules.shard_params(params, _mesh(1, 2))
    assert rules.shard_params(params, _mesh(1, 2),
                              strict=False)["novel"]["w"].shape == (4, 4)


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-moe-16b",
                                  "stablelm-1.6b"])
@pytest.mark.parametrize("mode", ["tp", "fsdp"])
def test_local_slice_is_the_block_the_spec_names(arch, mode):
    """At every rank of every mesh, each leaf's local slice equals the
    block of the whole tensor that its spec names: along a split dim, the
    block at the rank's index on the entry's axes, the first axis of a
    tuple the most significant (numpy's ravel order); split leaves are
    copies of their own."""
    cfg = get_config(arch, smoke=True)
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                          "cpu")
    whole = _tleaves(params)
    for data, model in MESHES:
        for rank in range(data * model):
            mesh = _mesh(data, model, rank)
            specs = _tleaves(rules.param_shardings(params, mesh, mode=mode))
            local = _tleaves(rules.shard_params(params, mesh, mode=mode))
            for path, t in whole.items():
                want = t
                for dim, entry in enumerate(specs[path]):
                    axes = rules._axes(entry)
                    if not axes:
                        continue
                    sizes = [mesh.shape[a] for a in axes]
                    i = int(np.ravel_multi_index(
                        [mesh.coords[a] for a in axes], sizes))
                    want = torch.chunk(want, int(np.prod(sizes)), dim)[i]
                assert torch.equal(local[path], want), (path, mesh.coords)
                if local[path].shape != t.shape:
                    assert local[path].untyped_storage().data_ptr() != \
                        t.untyped_storage().data_ptr()


# the execution layout replicates what the rule splits inside a head:
# the smoke configs with fewer KV heads than ranks (ROADMAP C13); no full
# config is among them at 2 or 4 ranks
C13 = {("llama3-8b", 2), ("llama3-8b", 4), ("yi-34b", 2), ("yi-34b", 4),
       ("gemma2-27b", 4), ("granite-moe-1b-a400m", 4),
       ("llava-next-34b", 2), ("llava-next-34b", 4)}
# ... and, in the recurrent mixers (ROADMAP C14), replicates the RWKV
# channel mix's gate, and the time mix where the ranks cut inside its
# heads of 64 (rwkv6-7b smoke's 2 heads at TP 4), and relays the time
# mix's decay bias (rule: replicated) by heads and the Mamba2 packed
# columns by [z_r, x_r, B, C, dt_r] and [x_r, B, C]
TIME_MIX = [f"layers/time/w{w}/w" for w in "gkorvw"]
C14 = {"rwkv6-7b": (["layers/chan/wr/w"], ["layers/time/w_bias"]),
       "zamba2-2.7b": ([], ["layers/ssm/conv_w", "layers/ssm/in_proj/w"])}
C14_SMOKE_TP4 = {"rwkv6-7b": (["layers/chan/wr/w"] + TIME_MIX, [])}
# the cache leaves C14 lays out otherwise than ``cache_spec``: the RWKV
# token-shift carries stay whole, the Mamba2 conv carry holds [x_r, B, C]
CACHE_C14 = {"tshift", "cshift", "conv"}


def _leaves_of(tree: dict) -> dict:
    return dict(rules.flatten_with_paths(tree))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_execution_layout_differs_from_the_rules_only_at_c13(arch):
    """Every family: the execution layout's replicated and relaid
    parameters are C13's and C14's and no others, and every cache leaf
    is ``cache_spec``'s local block but where C13 replicates the KV
    heads or C14 keeps a carry whole or relaid."""
    for smoke in (False, True):
        model = build_model(get_config(arch, smoke=smoke))
        for tp in (2, 4):
            for rank in range(tp):
                mesh = _mesh(1, tp, rank)
                layout = TensorParallel(model, mesh)
                want = (["layers/attn/wk/w", "layers/attn/wv/w"]
                        if smoke and (arch, tp) in C13 else [], [])
                if arch in C14:
                    want = (C14_SMOKE_TP4 if smoke and tp == 4
                            else C14).get(arch, C14[arch])
                assert (layout.replicated, layout.relaid) == want, \
                    (arch, smoke, tp)
                cache = _leaves_of(model.__class__(
                    model.cfg, tp=layout).init_cache(2, 8, device="meta"))
                whole = _leaves_of(model.init_cache(2, 8, device="meta"))
                for path, t in whole.items():
                    spec = rules.cache_spec(path, tuple(t.shape), mesh)
                    leaf = path.rsplit("/", 1)[-1]
                    if leaf in ("k", "v") and layout.replicated \
                            and arch not in C14:
                        spec = rules.P()
                    if leaf in CACHE_C14:
                        continue
                    assert cache[path].shape == rules.local_slice(
                        t, spec, mesh).shape, (arch, smoke, tp, path)
                for path in set(whole) & set(cache):
                    leaf = path.rsplit("/", 1)[-1]
                    if leaf in ("tshift", "cshift"):
                        assert cache[path].shape == whole[path].shape
                    if leaf == "conv":
                        cols = ssm_columns(model.cfg, rank, tp)["conv_w"]
                        assert cache[path].shape[-1] == len(cols)


# ------------------------------------------------------ served on ranks
B, NEW, CACHE = 2, 5, 32
# (name, arch, config knobs, mesh (data, model) or None for all on
# model, prompt length); gemma2's prompt runs past its window of 8; the
# padded vocab (264) splits the embedding and the LM head
CASES = [("llama3-8b-fused", "llama3-8b", {"fused_mlp": True}, None, 10),
         ("llama3-8b-unfused", "llama3-8b", {}, None, 10),
         ("llama3-8b-padded-vocab", "llama3-8b",
          {"fused_mlp": True, "vocab_pad_multiple": 8}, None, 10),
         ("stablelm-1.6b", "stablelm-1.6b", {}, None, 10),
         ("gemma2-27b", "gemma2-27b", {"fused_mlp": True}, None, 12),
         ("deepseek-moe-16b", "deepseek-moe-16b", {}, None, 10),
         ("llama3-8b-data2", "llama3-8b", {"fused_mlp": True}, (2, 2), 10)]
WORLDS = (2, 4)


def _cases(world: int):
    return [c for c in CASES if c[3] is None or c[3][0] * c[3][1] == world]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Per world size and case: the JAX engine's tokens, the single-rank
    port's tokens and fp32 prefill logits, and what every rank saw."""
    out = {}
    for world in WORLDS:
        root = tmp_path_factory.mktemp(f"world{world}")
        cases, single = [], {}
        for name, arch, knobs, mesh, prompt_len in _cases(world):
            jmodel = jbuild_model(dataclasses.replace(
                jget_config(arch, smoke=True), **knobs))
            jparams = jmodel.init_params(jax.random.PRNGKey(0))
            cfg = dataclasses.replace(get_config(arch, smoke=True), **knobs)
            params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
            prompts = np.random.default_rng(world).integers(
                0, cfg.vocab, (B, prompt_len)).astype(np.int32)
            jax_tokens = np.asarray(JEngine(jmodel, jparams, JServeConfig(
                max_new_tokens=NEW, cache_len=CACHE)).generate(prompts))
            model = build_model(cfg)
            tokens = Engine(model, params, ServeConfig(
                max_new_tokens=NEW, cache_len=CACHE)).generate(prompts)
            with torch.inference_mode():
                logits = model.prefill(params, {"tokens": torch.from_numpy(
                    prompts).long()}, max_len=CACHE)[0]
            single[name] = dict(cfg=cfg, jax_tokens=jax_tokens,
                                tokens=tokens, logits=logits)
            cases.append(dict(name=name, arch=arch, knobs=knobs,
                              mesh=mesh or (1, world), params=params,
                              prompts=prompts, new=NEW, cache=CACHE))
        torch.save(cases, root / "cases.pt")
        proc = subprocess.run(
            [sys.executable, str(ROOT / "tests" / "torch_dist_ranks.py"),
             str(root), str(world)], capture_output=True, text=True,
            timeout=600)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        ranks = torch.load(root / "results.pt", weights_only=False)
        for i, (name, *_rest) in enumerate(_cases(world)):
            out[world, name] = dict(single[name],
                                    ranks=[r[i] for r in ranks])
    return out


SERVED = [(w, c[0]) for w in WORLDS for c in _cases(w)]
IDS = [f"tp{w}-{n}" for w, n in SERVED]


@pytest.mark.parametrize("world,name", SERVED, ids=IDS)
def test_sharded_greedy_tokens_equal_single_rank_and_jax(served, world,
                                                         name):
    run = served[world, name]
    assert np.array_equal(run["tokens"], run["jax_tokens"])
    for r in run["ranks"]:
        assert r["name"] == name
        assert np.array_equal(r["tokens"], run["tokens"]), r["coords"]


@pytest.mark.parametrize("world,name", SERVED, ids=IDS)
def test_sharded_fp32_logits_within_tolerance(served, world, name):
    run = served[world, name]
    for r in run["ranks"]:
        np.testing.assert_allclose(r["logits"].numpy(),
                                   run["logits"].numpy(), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)


@pytest.mark.parametrize("world,name", SERVED, ids=IDS)
def test_sharded_all_reduce_counts_and_zero_solves(served, world, name):
    """One all_reduce after each layer's attention and MLP (or MoE), one
    after a split embedding and one for split logits, per forward pass;
    one token check per generated token; no solver call after the
    prewarm."""
    run = served[world, name]
    cfg = run["cfg"]
    model_axis = (dict((c[0], c[3]) for c in CASES)[name] or (1, world))[1]
    vocab = 2 * (cfg.padded_vocab % model_axis == 0)
    per_pass = 2 * cfg.layers + vocab
    for r in run["ranks"]:
        assert r["generate_all_reduces"] == NEW * per_pass
        assert r["prefill_all_reduces"] == per_pass
        assert r["token_checks"] == NEW
        assert r["solver_calls"] == 0


def test_ranks_that_sample_different_tokens_raise_together(tmp_path):
    """With a stop token, rank 0's rows finish at its first token and the
    other ranks' never: every rank raises at the first stop check, none
    leaves the loop alone to leave the others waiting in a collective."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_dist_ranks.py"),
         str(tmp_path), "2", "disagree"], capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    errors = torch.load(tmp_path / "results.pt", weights_only=False)
    assert errors == ["the tensor-parallel ranks sampled different "
                      "tokens"] * 2


# ------------------------------------------------------------ refusals
@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo process group for this test."""
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/init", world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_host_mesh_refusals(one_rank):
    if torch.cuda.device_count() < 1:
        with pytest.raises(ValueError, match="nccl needs one card per rank"):
            make_host_mesh(backend="nccl")
    with pytest.raises(ValueError, match="cannot tile"):
        make_host_mesh(model=2)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_host_mesh(data=2, model=1)
    with pytest.raises(ValueError, match="backend"):
        make_host_mesh(backend="mpi")
    mesh = make_host_mesh(backend="gloo")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.coords == {"data": 0, "model": 0}


def test_make_host_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_host_mesh(model=1)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_shard_engine_takes_every_family(one_rank, arch):
    """Every config, sharded on a one-rank mesh, keeps its whole
    parameters and serves its single-device tokens."""
    from repro_torch.dist.serve import shard_engine
    from repro_torch.sharding.rules import flatten_with_paths
    model = build_model(get_config(arch, smoke=True))
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    prompts = np.zeros((1, 4), np.int32)
    extra = None
    if model.cfg.frontend:
        key = "patches" if model.cfg.family == "vlm" else "frames"
        extra = {key: np.zeros((1, model.cfg.frontend_len,
                                model.cfg.d_model), np.float32)}
    scfg = ServeConfig(max_new_tokens=3, cache_len=16)
    want = Engine(model, params, scfg).generate(prompts, extra_batch=extra)
    eng = Engine(model, params, scfg)
    mesh = shard_engine(eng, model_axis=1)
    assert eng.mesh is mesh and model.tp is None
    assert all(a.shape == b.shape for (_, a), (_, b) in zip(
        flatten_with_paths(eng.params), flatten_with_paths(params)))
    assert np.array_equal(eng.generate(prompts, extra_batch=extra), want)


def _serve_smoke(*args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.dist.serve_smoke", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)


def test_serve_smoke_on_cpu_when_asked_and_refused_without_a_card():
    """The twin of scripts/dist_serve_smoke.py at TP = 2 on the CPU:
    TOKENS_OK, PREWARM_OK, SCHED_OK; without a card and without --device
    cpu it exits non-zero."""
    res = _serve_smoke("--world", "2", "--device", "cpu")
    assert res.returncode == 0, res.stdout + res.stderr
    for marker in ("TOKENS_OK", "PREWARM_OK", "SCHED_OK", "ALL_OK"):
        assert marker in res.stdout, res.stdout
    res = _serve_smoke("--world", "2")
    assert res.returncode != 0 and "--device cpu" in res.stderr
