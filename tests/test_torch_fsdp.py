"""FSDP over the data axis (``repro_torch.dist.fsdp``) against the rules,
replicated data parallelism, one rank and the JAX engine, on the CPU.

- The layout: every leaf of every ``ARCHS`` config, full (meta tensors)
  and smoke, is split over the data axis on the dim that
  ``param_shardings(mode="fsdp")`` names (the first free dim that
  divides), on the meshes (2, 1), (4, 1), (2, 2) and (4, 2);
  ``sharding.rules.assemble`` inverts ``local_slice``.
- Gloo ranks (``tests/torch_train_ranks.py``, worlds 2 and 4 at once):
  the gather of a stacked leaf split on its layer axis (2 ranks) and on a
  feature axis (4 ranks) gives the whole layers, and its backward gives
  each rank the mean of the ranks' gradients over its block; FSDP at
  (2, 1) and (4, 1) trains 3 AdamW steps as replicated data parallelism
  does (losses and gathered parameters within 1e-6 of scale; not
  bitwise: the clip's global norm sums each leaf's slices in another
  order) and as one rank on the whole batch does; ``shard_engine(mode=
  "fsdp")`` at (2, 1) and (2, 2) gives one rank's greedy tokens and the
  JAX engine's, on every smoke config.
- ROADMAP C20: replicated data parallelism through
  ``jit_train_step(group=)`` on the MoE smoke configs (deepseek-moe-16b,
  granite-moe-1b-a400m) at world 2 and 4, by the exact mean and the
  int8 error-feedback all-reduce, takes the load-balancing loss's token
  statistics over the global batch: the losses and the exactly reduced
  first gradients are within 1e-6 of one rank's on the whole batch, the
  compressed ones within half a quantization step of them.
"""
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
from repro_torch.configs import ARCHS, get_config
from repro_torch.dist.fsdp import FullyShardedData
from repro_torch.launch.mesh import HostMesh
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.parallel import TensorParallel
from repro_torch.serving import Engine, ServeConfig
from repro_torch.sharding.rules import (P, assemble, flatten_with_paths,
                                        local_slice, param_spec)
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import make_train_step
from torch_train_ranks import job_batches, run_worlds

ARCH_NAMES = sorted(ARCHS)
MESHES = [(2, 1), (4, 1), (2, 2), (4, 2)]
SEQ, BATCH, STEPS, LR = 8, 4, 3, 3e-3
# the sharded run against replicated data parallelism at the same world
DP_TOL = 1e-6
# against one rank on the whole batch (the batch mean summed in another
# order)
ONE_TOL = 1e-5
# llama3-8b's smoke config widened so that FSDP splits leaves: the MLP's
# (2, 64, 1024) on the layer axis over 2 ranks and on d_model over 4, the
# embedding and head over a vocabulary of 1024 on d_model
WIDE = {"d_ff": 1024, "vocab": 1024}
CONFIGS = {"llama3-8b-wide": WIDE, "llama3-8b": {}}
NEW, CACHE, PROMPT = 5, 32, 12
# C20: replicated data parallelism on the MoE smoke configs, each reduction
MOE_REPLICAS = [(a, c) for a in ("deepseek-moe-16b", "granite-moe-1b-a400m")
                for c in (False, True)]
# its losses and exactly reduced gradients against one rank's
MOE_TOL = 1e-6


def _mesh(data: int, model: int, rank: int = 0) -> HostMesh:
    return HostMesh(shape={"data": data, "model": model},
                    axis_names=("data", "model"), rank=rank,
                    coords={"data": rank // model, "model": rank % model})


def _fsdp(cfg, data: int, model: int, rank: int = 0):
    m = build_model(cfg)
    sharded = dataclasses.replace(m, tp=TensorParallel(m, _mesh(data, model,
                                                                rank)))
    sharded.fsdp = FullyShardedData(sharded)
    return sharded


LAYOUTS = [(a, s) for a in ARCH_NAMES for s in (False, True)]


@pytest.mark.parametrize("arch,smoke", LAYOUTS,
                         ids=[f"{a}-{'smoke' if s else 'full'}"
                              for a, s in LAYOUTS])
def test_fsdp_splits_the_dim_the_rule_names(arch, smoke):
    cfg = get_config(arch, smoke=smoke)
    whole = dict(flatten_with_paths(build_model(cfg).init_params(
        torch.Generator(), "meta")))
    for data, model in MESHES:
        layout = _fsdp(cfg, data, model)
        tp_local = dict(flatten_with_paths(dataclasses.replace(
            layout, fsdp=None).init_params(torch.Generator(), "meta")))
        for path, t in whole.items():
            spec = param_spec(path, tuple(t.shape), _mesh(data, model),
                              mode="fsdp", strict=True)
            dims = [i for i, e in enumerate(spec) if e == "data"]
            assert layout.fsdp.dims[path] == (dims[0] if dims else None), \
                (path, spec)
            placed = layout.fsdp.place(path, tp_local[path])
            shape = list(tp_local[path].shape)
            if dims:
                shape[dims[0]] //= data
            assert list(placed.shape) == shape, path


@pytest.mark.parametrize("data,model", MESHES + [(1, 2), (2, 4)])
def test_assemble_inverts_local_slice(data, model):
    t = torch.arange(8 * 16 * 16, dtype=torch.float32).reshape(8, 16, 16)
    for spec in (P("data", "model"), P(None, ("data", "model")),
                 P("model", None, "data"), P(None), P()):
        blocks = {}
        for rank in range(data * model):
            mesh = _mesh(data, model, rank)
            blocks[tuple(mesh.coords.values())] = local_slice(t, spec, mesh)
        assert torch.equal(assemble(blocks, spec, _mesh(data, model)), t)


# --------------------------------------------------------------- ranks
def _inputs(cfg, seed: int):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    extra = None
    if cfg.family in ("vlm", "encdec"):
        key = "patches" if cfg.family == "vlm" else "frames"
        extra = {key: (0.02 * rng.standard_normal(
            (2, cfg.frontend_len, cfg.d_model))).astype(np.float32)}
    return prompts, extra


# every smoke config, and the widened one, whose MLP, embedding and head
# the serving passes gather
SERVED = ARCH_NAMES + ["llama3-8b-wide"]


def _served_cfg(name: str, get):
    if name == "llama3-8b-wide":
        return dataclasses.replace(get("llama3-8b", smoke=True), **WIDE)
    return get(name, smoke=True)


@pytest.fixture(scope="module")
def served():
    """Per config: the port's parameters (the JAX engine's, moved over),
    prompts, the JAX engine's and one rank's greedy tokens."""
    out = {}
    for i, arch in enumerate(SERVED):
        jmodel = jbuild_model(_served_cfg(arch, jget_config))
        jparams = jmodel.init_params(jax.random.PRNGKey(0))
        cfg = _served_cfg(arch, get_config)
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 device="cpu")
        prompts, extra = _inputs(cfg, i)
        jax_tokens = np.asarray(JEngine(jmodel, jparams, JServeConfig(
            max_new_tokens=NEW, cache_len=CACHE)).generate(
            prompts, extra_batch=None if extra is None else
            {k: jnp.asarray(v) for k, v in extra.items()}))
        tokens = Engine(build_model(cfg), params, ServeConfig(
            max_new_tokens=NEW, cache_len=CACHE)).generate(
            prompts, extra_batch=extra)
        out[arch] = dict(params=params, prompts=prompts, extra=extra,
                         jax_tokens=jax_tokens, tokens=tokens)
    return out


def _job(kind: str, name: str, mesh, **kw) -> dict:
    return dict(kind=kind, arch="llama3-8b", overrides=CONFIGS.get(name, {}),
                mesh=mesh, mode="fsdp", seq=SEQ, batch=BATCH, lr=LR,
                steps=STEPS, **kw)


@pytest.fixture(scope="module")
def worlds(served, tmp_path_factory):
    """Per world (2: mesh (2, 1); 4: (4, 1) and (2, 2)): the gather probe,
    FSDP and replicated training of each of CONFIGS, and shard_engine's
    tokens on every smoke config, and the MoE replicas of C20; job by
    job, each the ranks' results."""
    roots = {}
    for world in (2, 4):
        jobs = [_job("gather", "llama3-8b-wide", (world, 1))]
        for name in CONFIGS:
            jobs += [_job("train", name, (world, 1)),
                     _job("replicas", name, (world, 1))]
        serve_mesh = (2, 1) if world == 2 else (2, 2)
        jobs += [dict(kind="serve", arch=a.replace("-wide", ""),
                      overrides=WIDE if a.endswith("-wide") else {},
                      mesh=serve_mesh, params=served[a]["params"],
                      prompts=served[a]["prompts"],
                      extra=served[a]["extra"], new=NEW, cache=CACHE)
                 for a in SERVED]
        jobs += [dict(kind="replica_grads", arch=arch, compress=compress,
                      seq=SEQ, batch=BATCH, lr=LR, steps=1)
                 for arch, compress in MOE_REPLICAS]
        roots[world] = tmp_path_factory.mktemp(f"fsdp{world}")
        torch.save(jobs, roots[world] / "jobs.pt")
    return {world: [list(r) for r in zip(*ranks)]
            for world, ranks in run_worlds(roots).items()}


@pytest.mark.parametrize("world", [2, 4])
def test_gather_and_its_reduce_scatter(worlds, world):
    """Over 2 ranks the MLP's stacked (2, 64, 1024) is split on its layer
    axis, over 4 on d_model; either way every rank gathers each whole
    layer, and its gradient is the mean of the ranks' probes over its
    block."""
    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True), **WIDE)
    whole = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                         "cpu", masters=True)
    w = whole["layers"]["mlp"]["wg"]["w"]
    ranks = worlds[world][0]
    probes = [[torch.randn(w.shape[1:], generator=torch.Generator()
                           .manual_seed(100 * r + i)) for i in range(2)]
              for r in range(world)]
    mean = torch.stack([torch.stack(p) for p in probes]).mean(0)
    for rank, got in enumerate(ranks):
        assert got["dim"] == (0 if world == 2 else 1)
        for i in range(2):
            assert torch.equal(got["wholes"][i], w[i])
        layout = _fsdp(cfg, world, 1, rank).fsdp
        assert torch.equal(got["local"],
                           layout.place("layers/mlp/wg/w", w))
        want = layout.place("layers/mlp/wg/w", mean)
        torch.testing.assert_close(got["grad"], want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def one_rank():
    out = {}
    for name, over in CONFIGS.items():
        cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                                  **over)
        step = make_train_step(build_model(cfg), opt.AdamWConfig(
            lr=LR, warmup_steps=2, total_steps=20))
        params = build_model(cfg).init_params(
            torch.Generator().manual_seed(0), "cpu", masters=True)
        state = opt.init_state(params)
        losses = []
        for b in job_batches(cfg, {"seq": SEQ, "batch": BATCH,
                                   "steps": STEPS}, 0, 1):
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
        out[name] = losses, dict(flatten_with_paths(params))
    return out


def _gap(a, b) -> float:
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


TRAINED = [(w, n) for w in (2, 4) for n in CONFIGS]


def _fsdp_and_replicas(worlds, world, name):
    i = 1 + 2 * list(CONFIGS).index(name)
    return worlds[world][i], worlds[world][i + 1]


@pytest.mark.parametrize("world,name", TRAINED,
                         ids=[f"{w}x1-{n}" for w, n in TRAINED])
def test_fsdp_trains_as_replicated_data_parallelism(worlds, world, name):
    fsdp, replicas = _fsdp_and_replicas(worlds, world, name)
    split = [p for p, d in fsdp[0]["dims"].items() if d is not None]
    assert bool(split) == (name == "llama3-8b-wide"), split
    if split:
        comm = fsdp[0]["comm"]
        # a gather a split leaf in the forward and again in the recompute
        # of a layer; a reduce-scatter each in the backward
        assert comm["fsdp_gather"]["calls"] >= comm["reduce_scatter"][
            "calls"] >= len(split)
    scale = max(1.0, max(map(abs, replicas[0]["losses"])))
    for got in fsdp:
        assert got["losses"] == fsdp[0]["losses"]
        assert max(abs(a - b) for a, b in zip(
            got["losses"], replicas[0]["losses"])) <= DP_TOL * scale
        for path, want in replicas[0]["whole"].items():
            assert _gap(got["whole"][path], want) <= DP_TOL, path


@pytest.mark.parametrize("world,name", TRAINED,
                         ids=[f"{w}x1-{n}" for w, n in TRAINED])
def test_fsdp_trains_as_one_rank(worlds, one_rank, world, name):
    """Losses within 1e-5 of scale of one rank's; parameters within 1e-5
    of scale, or, on the widened config, no further from one rank's than
    replicated data parallelism's are (its own 1.37e-5 on the MLP's wd
    over 2 ranks: AdamW turns roundoff-level gradients' reassociation
    into a share of the lr)."""
    losses, params = one_rank[name]
    fsdp, replicas = _fsdp_and_replicas(worlds, world, name)
    scale = max(1.0, max(map(abs, losses)))
    got = fsdp[0]
    assert max(abs(a - b) for a, b in zip(got["losses"], losses)) \
        <= ONE_TOL * scale
    for path, want in params.items():
        gap = _gap(got["whole"][path], want)
        assert gap <= max(ONE_TOL, _gap(replicas[0]["whole"][path], want)
                          + DP_TOL), (path, gap)


@pytest.mark.parametrize("world,arch", [(w, a) for w in (2, 4)
                                        for a in SERVED],
                         ids=[f"{'2x1' if w == 2 else '2x2'}-{a}"
                              for w in (2, 4) for a in SERVED])
def test_shard_engine_fsdp_tokens(worlds, served, world, arch):
    """shard_engine(mode="fsdp"): every rank's greedy tokens equal one
    rank's and the JAX engine's; the passes gather where FSDP splits a
    leaf (the widened config's MLP, embedding and head; the MoE banks,
    rwkv6-7b's channel mix, zamba2-2.7b's in_proj)."""
    run = served[arch]
    assert np.array_equal(run["tokens"], run["jax_tokens"])
    layout = _fsdp(_served_cfg(arch, get_config), 2, world // 2).fsdp
    split = any(d is not None for d in layout.dims.values())
    assert split or arch not in ("llama3-8b-wide", "rwkv6-7b")
    for got in worlds[world][1 + 2 * len(CONFIGS) + SERVED.index(arch)]:
        assert np.array_equal(got["tokens"], run["tokens"])
        assert (got["gathers"] > 0) == split, got["gathers"]


@pytest.fixture(scope="module")
def moe_one_rank():
    """Per MoE smoke config: one rank's loss and gradients on the whole
    batch of the replicas' first step."""
    from repro_torch.training.train_step import _grads_of
    out = {}
    for arch in {a for a, _ in MOE_REPLICAS}:
        cfg = get_config(arch, smoke=True)
        model = build_model(cfg)
        params = model.init_params(torch.Generator().manual_seed(0), "cpu",
                                   masters=True)
        batch, = job_batches(cfg, {"seq": SEQ, "batch": BATCH, "steps": 1},
                             0, 1)
        loss, grads = _grads_of(model, params, batch, microbatches=1,
                                remat=True)
        out[arch] = float(loss), dict(flatten_with_paths(grads))
    return out


MOE_CASES = [(w, a, c) for w in (2, 4) for a, c in MOE_REPLICAS]


@pytest.mark.parametrize("world,arch,compress", MOE_CASES,
                         ids=[f"{w}-{a}-{'compressed' if c else 'exact'}"
                              for w, a, c in MOE_CASES])
def test_replicated_moe_aux_loss_is_over_the_global_batch(
        worlds, moe_one_rank, world, arch, compress):
    """ROADMAP C20: each rank's loss (the load-balancing term's token
    statistics averaged over the group) is one rank's on the whole
    batch within 1e-6 of max(1, |loss|); the exactly reduced first
    gradients are one rank's within 1e-6 of max(1, max|g|), and the
    compressed ones within half the int8 step (the largest local
    gradient over 127) of them."""
    loss, want = moe_one_rank[arch]
    i = (1 + 2 * len(CONFIGS) + len(SERVED)
         + MOE_REPLICAS.index((arch, compress)))
    ranks = worlds[world][i]
    for got in ranks:
        assert abs(got["losses"][0] - loss) <= MOE_TOL * max(1.0, abs(loss))
        for path, g in want.items():
            tol = MOE_TOL * max(1.0, float(g.abs().max()))
            if compress:
                tol += max(float(r["local"][path].abs().max())
                           for r in ranks) / 127 / 2
            gap = float((got["reduced"][path] - g).abs().max())
            assert gap <= tol, (path, gap, tol)
