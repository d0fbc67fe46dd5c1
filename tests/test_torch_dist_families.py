"""Tensor-parallel serving of the families beyond dense and MoE (RWKV-6,
the Mamba2 hybrid, the encoder-decoder, the VLM), and of the smoke
configs the dense and MoE cases of ``test_torch_dist.py`` leave out, on
the CPU.

- One subprocess per world size (2 and 4) spawns gloo ranks
  (``tests/torch_dist_ranks.py``) and serves each smoke config sharded
  over every rank: greedy tokens equal the single-rank port's and the
  JAX engine's, fp32 prefill logits are within 1e-5 of the single-rank
  port's, the ``all_reduce`` counts are exact (read off the layout's own
  split flags), and there are no solver calls after rank 0's prewarm.
- The execution layout's packed Mamba2 columns: each rank's
  [z_r, x_r, B, C, dt_r] of ``ssm/in_proj`` and [x_r, B, C] of
  ``ssm/conv_w`` compose back to the whole tensor (ROADMAP C14).
- The ``all_reduce`` counts a pass at full width, from the layouts of the
  published configs on meta tensors (``TensorParallel.per_pass``).
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
from repro_torch.configs import get_config
from repro_torch.launch.mesh import HostMesh
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.parallel import TensorParallel, ssm_columns
from repro_torch.models.ssm import ssm_dims
from repro_torch.serving import Engine, ServeConfig
from torch_dist_ranks import run_worlds

B, NEW, CACHE, PROMPT = 2, 5, 32, 12
LOGIT_TOL = 1e-5
WORLDS = (2, 4)
# (name, arch, config knobs): the scan kernels' and the fused MLP's
# plain versions on and off (the CPU runs the plain versions either way)
CASES = [("rwkv6-7b-scan", "rwkv6-7b", {"use_pallas_scan": True}),
         ("rwkv6-7b", "rwkv6-7b", {}),
         ("zamba2-2.7b-fused", "zamba2-2.7b",
          {"use_pallas_scan": True, "fused_mlp": True}),
         ("zamba2-2.7b", "zamba2-2.7b", {}),
         ("seamless-m4t-medium", "seamless-m4t-medium", {}),
         ("llava-next-34b", "llava-next-34b", {}),
         ("yi-34b", "yi-34b", {}),
         ("granite-moe-1b-a400m", "granite-moe-1b-a400m", {})]


def _mesh(model: int, rank: int = 0) -> HostMesh:
    return HostMesh(shape={"data": 1, "model": model},
                    axis_names=("data", "model"), rank=rank,
                    coords={"data": 0, "model": rank})


def _inputs(cfg, seed: int):
    """Prompts, and the frontend's frames or patches (std 0.02, as the
    embedding's), from a seed."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    extra = None
    if cfg.family in ("vlm", "encdec"):
        key = "patches" if cfg.family == "vlm" else "frames"
        extra = {key: (0.02 * rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model))).astype(np.float32)}
    return prompts, extra


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Per case: the JAX engine's tokens, the single-rank port's tokens
    and fp32 prefill logits; per world and case, what every rank saw."""
    single, cases = {}, []
    for i, (name, arch, knobs) in enumerate(CASES):
        jmodel = jbuild_model(dataclasses.replace(
            jget_config(arch, smoke=True), **knobs))
        jparams = jmodel.init_params(jax.random.PRNGKey(0))
        cfg = dataclasses.replace(get_config(arch, smoke=True), **knobs)
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 device="cpu")
        prompts, extra = _inputs(cfg, i)
        jax_tokens = np.asarray(JEngine(jmodel, jparams, JServeConfig(
            max_new_tokens=NEW, cache_len=CACHE)).generate(
            prompts, extra_batch=None if extra is None else
            {k: jnp.asarray(v) for k, v in extra.items()}))
        model = build_model(cfg)
        tokens = Engine(model, params, ServeConfig(
            max_new_tokens=NEW, cache_len=CACHE)).generate(
            prompts, extra_batch=extra)
        batch = {"tokens": torch.from_numpy(prompts).long()}
        for key, value in (extra or {}).items():
            batch[key] = torch.from_numpy(value)
        with torch.inference_mode():
            logits = model.prefill(params, batch, max_len=CACHE)[0]
        single[name] = dict(cfg=cfg, jax_tokens=jax_tokens, tokens=tokens,
                            logits=logits)
        cases.append(dict(name=name, arch=arch, knobs=knobs, mesh=None,
                          params=params, prompts=prompts, extra=extra,
                          new=NEW, cache=CACHE))
    roots = {}
    for world in WORLDS:
        roots[world] = tmp_path_factory.mktemp(f"world{world}")
        torch.save([dict(c, mesh=(1, world)) for c in cases],
                   roots[world] / "cases.pt")
    out = {}
    for world, ranks in run_worlds(roots).items():
        for i, (name, *_rest) in enumerate(CASES):
            out[world, name] = dict(single[name],
                                    ranks=[r[i] for r in ranks])
    return out


SERVED = [(w, c[0]) for w in WORLDS for c in CASES]
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
    """The prefill's all_reduces and NEW - 1 decode passes' in generate,
    the prefill's alone after it; one token check a generated token; no
    solver call after the prewarm."""
    run = served[world, name]
    cfg = run["cfg"]
    for rank, r in enumerate(run["ranks"]):
        layout = TensorParallel(build_model(cfg), _mesh(world, rank))
        prefill = layout.per_pass(prefill=True)
        decode = layout.per_pass(prefill=False)
        assert r["generate_all_reduces"] == prefill + (NEW - 1) * decode
        assert r["prefill_all_reduces"] == prefill
        assert r["token_checks"] == NEW
        assert r["solver_calls"] == 0
        assert (r["replicated"], r["relaid"]) == (layout.replicated,
                                                  layout.relaid)


# the all_reduces a pass of the published configs (decode; seamless's
# prefill adds its encoder's 12 x 2): seamless's vocabulary of 256206
# splits over 2 ranks but not over 4
FULL_PER_PASS = {("rwkv6-7b", 2): 66, ("rwkv6-7b", 4): 66,
                 ("zamba2-2.7b", 2): 74, ("zamba2-2.7b", 4): 74,
                 ("seamless-m4t-medium", 2): 38,
                 ("seamless-m4t-medium", 4): 36,
                 ("llava-next-34b", 2): 122, ("llava-next-34b", 4): 122}


@pytest.mark.parametrize("arch,world", sorted(FULL_PER_PASS))
def test_full_width_all_reduces_a_pass(arch, world):
    cfg = get_config(arch)
    layout = TensorParallel(build_model(cfg), _mesh(world))
    assert layout.per_pass(prefill=False) == FULL_PER_PASS[arch,
                                                                 world]
    extra = 24 if cfg.family == "encdec" else 0
    assert layout.per_pass(prefill=True) == \
        FULL_PER_PASS[arch, world] + extra


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("world", WORLDS)
def test_ssm_relayout_composes_back_to_the_whole_tensor(world, smoke):
    """zamba2-2.7b's packed in_proj and conv_w columns: each rank's
    slice, as ``TensorParallel.place`` cuts it, holds its heads' z, x and
    dt and the whole B and C; the ranks' slices put back in order give
    the whole tensor."""
    cfg = get_config("zamba2-2.7b", smoke=smoke)
    d_inner, nh, _, ns = ssm_dims(cfg)
    di, h = d_inner // world, nh // world
    gen = torch.Generator().manual_seed(0)
    whole = {"in_proj": torch.randn((2, 3, 2 * d_inner + 2 * ns + nh),
                                    generator=gen),
             "conv_w": torch.randn((2, 3, d_inner + 2 * ns), generator=gen)}
    model = build_model(cfg)
    parts = {"in_proj": [], "conv_w": []}
    for rank in range(world):
        layout = TensorParallel(model, _mesh(world, rank))
        cols = ssm_columns(cfg, rank, world)
        for key, path in (("in_proj", "layers/ssm/in_proj/w"),
                          ("conv_w", "layers/ssm/conv_w")):
            local = layout.place(path, whole[key])
            assert torch.equal(local, whole[key][..., cols[key]])
            parts[key].append(local)
    z, x, bc, dt = zip(*(torch.split(p, [di, di, 2 * ns, h], -1)
                         for p in parts["in_proj"]))
    assert all(torch.equal(b, bc[0]) for b in bc)
    assert torch.equal(torch.cat([*z, *x, bc[0], *dt], -1),
                       whole["in_proj"])
    cx, cbc = zip(*(torch.split(p, [di, 2 * ns], -1)
                    for p in parts["conv_w"]))
    assert all(torch.equal(b, cbc[0]) for b in cbc)
    assert torch.equal(torch.cat([*cx, cbc[0]], -1), whole["conv_w"])
