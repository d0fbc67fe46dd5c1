"""Sharded training of the port on gloo ranks on the CPU: differentiable
tensor parallelism, FSDP + TP on a (data, model) mesh, checkpoints that
reshard on load, the training smoke and the launcher.

- The TP collectives' gradients: at TP 2 and 4, every leaf's gradient on
  every rank (after the model-axis sums of the leaves a rank reads only
  in part) equals the slice of one rank's gradient that the execution
  layout gives it, within 1e-5 of max(1, max|g|), on every smoke config
  of ``ARCHS``.  Before the repair the backward passed the sum's
  gradient through as the identity and never summed a replicated
  input's gradient over the ranks.
- (2, 2) FSDP + TP on all 10 smoke configs: the first batch's reduced
  gradients are one rank's slices as above; 3 AdamW steps' losses
  within 1e-5 of scale of one rank's on the whole batch, the gathered
  parameters within 1e-5 by the norm of each leaf's difference
  (``PARAM_TOL``); ranks that hold the same slice hold it bitwise equal; every
  rank's slice is the gathered tree's block under
  ``param_shardings(mode="fsdp")`` (the execution layout's own blocks
  where it differs from the rule: ROADMAP C13, C14).
- Checkpoints: a (2, 2) checkpoint is read by the reference's
  ``CheckpointManager``; a reference checkpoint restores onto (2, 2) and
  (1, 4); (2, 2) restores onto (4, 1) and (1, 4) bitwise, zamba2-2.7b's
  relaid Mamba2 columns included.
- ``python -m repro_torch.dist.train_smoke --world 8 --device cpu``
  prints ALL_OK; ``launch.train --data 2 --model 2`` descends and
  resumes from one checkpoint directory, and ``--sharding tp --data 2``
  still runs replicated data parallelism.

One subprocess per world (2 and 4; ``tests/torch_train_ranks.py``), both
at once, a thread a rank.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch.configs import ARCHS, get_config
from repro_torch.dist.fsdp import FullyShardedData
from repro_torch.launch.mesh import HostMesh
from repro_torch.models import build_model
from repro_torch.models.parallel import TensorParallel
from repro_torch.sharding.rules import (flatten_with_paths, leaf_at,
                                        local_slice, param_spec)
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import _grads_of, make_train_step
from torch_train_ranks import job_batches, run_worlds

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH_NAMES = sorted(ARCHS)
SEQ, BATCH, STEPS, LR = 8, 4, 3, 3e-3
TOL = 1e-5
# the parameters after 3 AdamW steps, leaf by leaf, by the norm of the
# difference over max(1, the leaf's norm): a gradient that agrees within
# TOL of its leaf's scale can be off by a large share where it is itself
# at roundoff level (zamba2-2.7b's in_proj under TP 2: 43% at |g| = 8.9e-8,
# max|g| 2.13), and AdamW's g / (|g| + eps) turns that into a share of the
# lr on that element (up to 1.5e-4 after 3 steps on the CPU), so the
# largest element's gap measures AdamW's conditioning, not the sharding
PARAM_TOL = 1e-5
# llama3-8b's smoke config widened so that FSDP splits leaves (the rule
# keeps leaves under 2**16 elements whole): the MLP's (2, 64, 1024) and
# the embedding and head over a vocabulary of 1024
WIDE = {"d_ff": 1024, "vocab": 1024}
CKPT = {"llama3-8b-wide": ("llama3-8b", WIDE), "zamba2-2.7b": ("zamba2-2.7b",
                                                               {})}
RESTORE_MESHES = [(4, 1), (1, 4)]
# the gates' readings of the widened llama3-8b at (2, 2), sound and with
# a planted fault (``torch_train_ranks.planted``)
PLANTS = (None, "summed_reduce_scatter")


def _mesh(data: int, model: int, rank: int) -> HostMesh:
    return HostMesh(shape={"data": data, "model": model},
                    axis_names=("data", "model"), rank=rank,
                    coords={"data": rank // model, "model": rank % model})


def _layout(cfg, data: int, model: int, rank: int, mode: str = "fsdp"):
    """A rank's TP and FSDP layouts on a mesh description."""
    m = build_model(cfg)
    sharded = dataclasses.replace(m, tp=TensorParallel(m, _mesh(data, model,
                                                                rank)))
    if mode == "fsdp":
        sharded.fsdp = FullyShardedData(sharded)
    return sharded


def _place(sharded, path, whole):
    local = sharded.tp.place(path, whole)
    return local if sharded.fsdp is None else sharded.fsdp.place(path, local)


def _cfg(arch: str, overrides: dict | None = None):
    return dataclasses.replace(get_config(arch, smoke=True),
                               **(overrides or {}))


def _masters(cfg) -> dict:
    return build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        "cpu", masters=True)


def _job(kind: str, arch: str, mesh, **kw) -> dict:
    return dict(kind=kind, arch=arch, mesh=mesh, seq=SEQ, batch=BATCH,
                lr=LR, **kw)


def _norm_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b)) / max(
        1.0, float(torch.linalg.vector_norm(b)))


@pytest.fixture(scope="module")
def reference_ckpt(tmp_path_factory):
    """A checkpoint the reference wrote: llama3-8b smoke's JAX masters."""
    d = tmp_path_factory.mktemp("ref_ckpt")
    jparams = jbuild_model(jget_config("llama3-8b", smoke=True)).init_params(
        jax.random.PRNGKey(3))
    JCheckpointManager(d, async_save=False).save(7, jparams)
    return d, {p: np.asarray(v) for p, v in flatten_with_paths(
        jax.tree.map(np.asarray, jparams))}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, reference_ckpt):
    """Every job's per-rank results: world 2 (TP 2 gradients) and world 4
    (TP 4 gradients, (2, 2) training, checkpoints across meshes)."""
    ckpt = {name: str(tmp_path_factory.mktemp(f"ckpt_{name}"))
            for name in CKPT}
    two = [_job("grads", a, (1, 2)) for a in ARCH_NAMES]
    four = [_job("grads", a, (1, 4)) for a in ARCH_NAMES]
    four += [_job("train", a, (2, 2), mode="fsdp", steps=STEPS)
             for a in ARCH_NAMES]
    for name, (arch, over) in CKPT.items():
        four.append(_job("save", arch, (2, 2), mode="fsdp", steps=1,
                         overrides=over, dir=ckpt[name]))
        four += [_job("restore", arch, mesh, mode="fsdp", overrides=over,
                      dir=ckpt[name]) for mesh in RESTORE_MESHES]
    four += [_job("restore_params", "llama3-8b", mesh, mode="fsdp",
                  dir=str(reference_ckpt[0])) for mesh in ((2, 2), (1, 4))]
    four += [_job("grads", a, (2, 2), mode="fsdp") for a in ARCH_NAMES]
    four += [_job(kind, "llama3-8b", (2, 2), mode="fsdp", overrides=WIDE,
                  steps=STEPS, plant=plant)
             for plant in PLANTS for kind in ("grads", "train")]
    roots = {}
    for world, jobs in ((2, two), (4, four)):
        roots[world] = tmp_path_factory.mktemp(f"sharded{world}")
        torch.save(jobs, roots[world] / "jobs.pt")
    out = run_worlds(roots)
    # job by job, each a list of the ranks' results
    return {world: [list(r) for r in zip(*ranks)]
            for world, ranks in out.items()}, ckpt


def _results(worlds, world: int, index: int) -> list:
    return worlds[0][world][index]


# the world of 4's jobs after the checkpoints' and the reference
# checkpoint's restores: the (2, 2) gradients, then PLANTS' jobs
FSDP_GRADS = 2 * len(ARCH_NAMES) + len(CKPT) * (1 + len(RESTORE_MESHES)) + 2
PLANTED = FSDP_GRADS + len(ARCH_NAMES)


def _one_rank_grads(cfg) -> tuple:
    """(loss, path -> gradient): one rank on the whole first batch."""
    batch = job_batches(cfg, {"seq": SEQ, "batch": BATCH}, 0, 1)[0]
    loss, grads = _grads_of(build_model(cfg), _masters(cfg), batch,
                            microbatches=1, remat=True)
    return float(loss), dict(flatten_with_paths(grads))


def _one_rank_steps(cfg) -> tuple:
    """(losses, path -> parameter): STEPS AdamW steps on one rank, the
    whole batch."""
    step = make_train_step(build_model(cfg), opt.AdamWConfig(
        lr=LR, warmup_steps=2, total_steps=20))
    params = _masters(cfg)
    state = opt.init_state(params)
    losses = []
    for b in job_batches(cfg, {"seq": SEQ, "batch": BATCH, "steps": STEPS},
                         0, 1):
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    return losses, dict(flatten_with_paths(params))


def _grad_gap(got: dict, want: dict, sharded) -> float:
    """The largest gap of a rank's gradients from its slices of one
    rank's (``want``, placed by the rank's layouts), each leaf's over
    max(1, max|g|) of its whole gradient."""
    return max(float((got[path] - _place(sharded, path, g)).abs().max())
               / max(1.0, float(g.abs().max())) for path, g in want.items())


# ------------------------------------------------ the TP gradients (0)
GRADS = [(w, a) for w in (2, 4) for a in ARCH_NAMES]


@pytest.mark.parametrize("world,arch", GRADS,
                         ids=[f"tp{w}-{a}" for w, a in GRADS])
def test_tp_gradients_are_one_ranks_slices(worlds, world, arch):
    cfg = _cfg(arch)
    params = _masters(cfg)
    batch = job_batches(cfg, {"seq": SEQ, "batch": BATCH}, 0, 1)[0]
    loss, grads = _grads_of(build_model(cfg), params, batch,
                            microbatches=1, remat=True)
    want = dict(flatten_with_paths(grads))
    ranks = _results(worlds, world, ARCH_NAMES.index(arch))
    for rank, got in enumerate(ranks):
        assert abs(got["loss"] - float(loss)) <= TOL * max(1, abs(loss))
        layout = _layout(cfg, 1, world, rank, mode="tp")
        for path, g in want.items():
            local = layout.tp.place(path, g)
            err = float((got["grads"][path] - local).abs().max())
            assert err <= TOL * max(1.0, float(g.abs().max())), (rank, path,
                                                                 err)


def test_tp_gradient_sums_are_the_c13_and_c14_leaves(worlds):
    """The model-axis sums after the backward touch exactly the leaves
    each rank reads in part: llama3-8b smoke's one KV head (C13) and
    zamba2-2.7b's relaid B and C columns (C14), with one collective a
    leaf; the other families sum none."""
    for world in (2, 4):
        for arch in ARCH_NAMES:
            layout = _layout(_cfg(arch), 1, world, 0, mode="tp").tp
            calls = _results(worlds, world, ARCH_NAMES.index(arch))[0][
                "comm"].get("tp_grad_sum", {}).get("calls", 0)
            assert calls == len(layout.grad_sums), (arch, world)
    assert set(_layout(_cfg("llama3-8b"), 1, 2, 0, "tp").tp.grad_sums) == {
        "layers/attn/wk/w", "layers/attn/wv/w"}
    assert set(_layout(_cfg("zamba2-2.7b"), 1, 2, 0, "tp").tp.grad_sums) \
        == {"layers/ssm/in_proj/w", "layers/ssm/conv_w"}


# ------------------------------------------------ (2, 2) FSDP + TP
@pytest.fixture(scope="module")
def one_rank():
    """Each smoke config's 3 AdamW steps on one rank, the whole batch."""
    return {arch: _one_rank_steps(_cfg(arch)) for arch in ARCH_NAMES}


def _train(worlds, arch):
    return _results(worlds, 4, len(ARCH_NAMES) + ARCH_NAMES.index(arch))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_fsdp_tp_training_equals_one_rank(worlds, one_rank, arch):
    losses, params = one_rank[arch]
    scale = max(1.0, max(map(abs, losses)))
    for got in _train(worlds, arch):
        assert max(abs(a - b) for a, b in zip(got["losses"], losses)) \
            <= TOL * scale, (got["losses"], losses)
        for path, want in params.items():
            assert _norm_gap(got["whole"][path], want) <= PARAM_TOL, path


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_fsdp_tp_gradients_are_one_ranks_slices(worlds, arch):
    """At (2, 2) every rank's reduced gradient of the first batch (the
    FSDP gather's reduce-scatter, the exact mean over the data axis of
    the leaves it keeps whole, the model-axis sums) is its slice of one
    rank's gradient on the whole batch, within TOL of max(1, max|g|)."""
    cfg = _cfg(arch)
    loss, want = _one_rank_grads(cfg)
    for rank, got in enumerate(_results(worlds, 4, FSDP_GRADS
                                        + ARCH_NAMES.index(arch))):
        assert abs(got["loss"] - loss) <= TOL * max(1, abs(loss))
        assert _grad_gap(got["grads"], want, _layout(cfg, 2, 2, rank)) \
            <= TOL, rank


def test_a_summed_reduce_scatter_fails_the_gradient_gate(worlds):
    """What the gates read of a planted fault: the FSDP gather's backward
    summing the data ranks' gradients where their mean belongs.  On the
    widened llama3-8b at (2, 2) the sound run passes both gates; the
    planted one fails the gradient gate on every rank by far, while its
    parameters after STEPS AdamW steps may pass the parameter gate:
    AdamW's g / (|g| + eps) is nearly blind to a constant factor on a
    leaf's gradient.  So the gradients, not the parameters, prove the
    reductions.  Prints each gate's reading."""
    cfg = _cfg("llama3-8b", WIDE)
    _, want = _one_rank_grads(cfg)
    losses, params = _one_rank_steps(cfg)
    readings = {}
    for i, plant in enumerate(PLANTS):
        grads = _results(worlds, 4, PLANTED + 2 * i)
        train = _results(worlds, 4, PLANTED + 2 * i + 1)
        readings[plant] = {
            "gradients": max(_grad_gap(r["grads"], want,
                                       _layout(cfg, 2, 2, rank))
                             for rank, r in enumerate(grads)),
            "parameters": max(_norm_gap(r["whole"][p], w)
                              for r in train for p, w in params.items()),
            "losses": max(abs(a - b) for r in train
                          for a, b in zip(r["losses"], losses))}
    print(f"gate readings, llama3-8b widened, (2, 2): {readings}")
    sound, fault = readings[None], readings["summed_reduce_scatter"]
    assert sound["gradients"] <= TOL and sound["parameters"] <= PARAM_TOL
    assert fault["gradients"] > 1e4 * TOL


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_ranks_holding_one_slice_hold_it_bitwise(worlds, arch):
    """Ranks whose layouts place the same block of a leaf (an index probe
    placed by each rank's layout) hold bitwise equal slices, and every
    rank reports the same losses."""
    cfg = _cfg(arch)
    ranks = _train(worlds, arch)
    layouts = [_layout(cfg, 2, 2, r) for r in range(4)]
    for path, whole in ranks[0]["whole"].items():
        probe = torch.arange(whole.numel(), dtype=torch.float64).reshape(
            whole.shape)
        blocks = [_place(lay, path, probe) for lay in layouts]
        for r in range(1, 4):
            assert ranks[r]["losses"] == ranks[0]["losses"]
            for q in range(r):
                if blocks[r].shape == blocks[q].shape and \
                        torch.equal(blocks[r], blocks[q]):
                    assert torch.equal(ranks[r]["local"][path],
                                       ranks[q]["local"][path]), (path, r, q)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rank_slices_are_the_fsdp_rules_blocks(worlds, arch):
    """Every rank's slice of every leaf is ``local_slice`` of the gathered
    tree under ``param_shardings(mode="fsdp")``, or where the execution
    layout differs from the rule (C13's replicated, C14's relaid leaves)
    the layout's own block."""
    cfg = _cfg(arch)
    ranks = _train(worlds, arch)
    whole = ranks[0]["whole"]
    for rank, got in enumerate(ranks):
        lay = _layout(cfg, 2, 2, rank)
        differs = set(lay.tp.replicated) | set(lay.tp.relaid)
        for path, w in whole.items():
            spec = param_spec(path, tuple(w.shape), _mesh(2, 2, rank),
                              mode="fsdp", strict=True)
            want = (_place(lay, path, w) if path in differs
                    else local_slice(w, spec, _mesh(2, 2, rank)))
            assert torch.equal(got["local"][path], want), (rank, path)


# -------------------------------------------------------- checkpoints
def _ckpt_index(name: str) -> int:
    """The index of CKPT[name]'s save job; its restores follow it."""
    return 2 * len(ARCH_NAMES) + list(CKPT).index(name) * (
        1 + len(RESTORE_MESHES))


def _to_numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("name", list(CKPT))
def test_sharded_checkpoint_is_read_by_the_reference(worlds, name):
    """The (2, 2) checkpoint, one for all ranks, restored by the
    reference's CheckpointManager on one device: the gathered parameters
    and moments."""
    saved = _results(worlds, 4, _ckpt_index(name))[0]
    arch, over = CKPT[name]
    jmodel = jbuild_model(dataclasses.replace(jget_config(arch, smoke=True),
                                              **over))
    jparams = _to_numpy_tree(jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0))))
    like = (jparams, {"mu": jparams, "nu": jparams, "step": np.int32(0)})
    (params, state), step = JCheckpointManager(
        worlds[1][name]).restore(like)
    assert step == 1
    for path, want in saved["whole"].items():
        np.testing.assert_array_equal(np.asarray(leaf_at(params, path)),
                                      want.numpy())
        np.testing.assert_array_equal(np.asarray(leaf_at(state["mu"], path)),
                                      saved["mu"][path].numpy())
    assert int(state["step"]) == 1


@pytest.mark.parametrize("index,mesh", enumerate([(2, 2), (1, 4)]),
                         ids=["2x2", "1x4"])
def test_reference_checkpoint_restores_onto_a_mesh(worlds, reference_ckpt,
                                                   index, mesh):
    """The reference's checkpoint of llama3-8b smoke restored onto the
    mesh: every rank's slices put together give the reference's leaves."""
    got = _results(worlds, 4, 2 * len(ARCH_NAMES) + len(CKPT) * (
        1 + len(RESTORE_MESHES)) + index)
    for rank in got:
        for path, want in reference_ckpt[1].items():
            np.testing.assert_array_equal(rank["whole"][path].numpy(), want)


RESHARDS = [(n, i) for n in CKPT for i in range(len(RESTORE_MESHES))]


@pytest.mark.parametrize("name,index", RESHARDS,
                         ids=[f"{n}-{RESTORE_MESHES[i][0]}x"
                              f"{RESTORE_MESHES[i][1]}" for n, i in RESHARDS])
def test_checkpoint_reshards_bitwise(worlds, name, index):
    """Saved on (2, 2), restored onto (4, 1) or (1, 4): every leaf of the
    parameters and moments bitwise equal, each rank's slice its new
    layout's block."""
    base = _ckpt_index(name)
    saved = _results(worlds, 4, base)[0]
    for rank in _results(worlds, 4, base + 1 + index):
        assert rank["step"] == 1 and rank["placed"]
        for path, want in saved["whole"].items():
            assert torch.equal(rank["whole"][path], want), path
            assert torch.equal(rank["mu"][path], saved["mu"][path]), path


def test_zamba2_relaid_leaves_round_trip(worlds):
    """zamba2-2.7b's Mamba2 in_proj and conv_w, relaid per TP rank as
    [z_r, x_r, B, C, dt_r] and [x_r, B, C] (C14): the (2, 2) checkpoint
    holds them in the reference's layout, and each rank of (1, 4) gets
    its relaid columns back."""
    base = _ckpt_index("zamba2-2.7b")
    saved = _results(worlds, 4, base)[0]["whole"]
    cfg = _cfg("zamba2-2.7b")
    relaid = [p for p in _layout(cfg, 1, 4, 0).tp.relaid
              if "ssm/" in p]
    assert relaid == ["layers/ssm/conv_w", "layers/ssm/in_proj/w"]
    ranks = _results(worlds, 4, base + 1 + RESTORE_MESHES.index((1, 4)))
    for rank, got in enumerate(ranks):
        lay = _layout(cfg, 1, 4, rank)
        for path in relaid:
            assert torch.equal(got["local"][path],
                               _place(lay, path, saved[path]))
            assert torch.equal(got["whole"][path], saved[path])


# ------------------------------------------- the smoke and the launcher
def _run(module: str, *args: str, cuda: bool = False):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"]}
    if not cuda:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_train_smoke_on_the_cpu_and_refused_without_a_card():
    res = _run("repro_torch.dist.train_smoke", "--world", "8", "--device",
               "cpu")
    assert res.returncode == 0, res.stdout + res.stderr
    for marker in ("LOSSES_OK", "RESHARD_OK", "GRADCOMP_OK", "ALL_OK"):
        assert marker in res.stdout, res.stdout
    res = _run("repro_torch.dist.train_smoke", "--world", "8")
    assert res.returncode != 0 and "--device cpu" in res.stderr


def test_launch_train_on_a_2x2_mesh_descends_and_resumes(tmp_path):
    """--data 2 --model 2 (FSDP + TP, the default sharding): 20 steps
    descend, the ranks agree, one checkpoint directory serves the four
    ranks, and a second run to step 22 restores from it."""
    args = ["--arch", "llama3-8b", "--smoke", "--seq", "16", "--batch", "4",
            "--lr", "3e-3", "--data", "2", "--model", "2", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    res = _run("repro_torch.launch.train", *args, "--steps", "20")
    assert res.returncode == 0, res.stdout + res.stderr
    assert "sharding: fsdp" in res.stdout
    assert "4 ranks: losses equal on every rank" in res.stdout
    line = next(l for l in res.stdout.splitlines()
                if l.startswith("finished at step 20"))
    first, last = (float(x) for x in
                   line.split("loss ")[1].split(";")[0].split(" -> "))
    assert last < first - 0.1, line
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000020"]
    res = _run("repro_torch.launch.train", *args, "--steps", "22")
    assert res.returncode == 0, res.stdout + res.stderr
    assert "[restore] resumed from step 20" in res.stdout
    assert "finished at step 22" in res.stdout


def test_launch_train_sharding_tp_model_1_is_replicated_dp(tmp_path):
    """--sharding tp --data 2 is replicated data parallelism: replicas, each
    with its own checkpoint directory."""
    res = _run("repro_torch.launch.train", "--arch", "llama3-8b", "--smoke",
               "--steps", "3", "--seq", "16", "--batch", "4", "--data", "2",
               "--sharding", "tp", "--device", "cpu", "--ckpt-dir",
               str(tmp_path))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "2 ranks: losses equal on every rank" in res.stdout
    assert "sharding:" not in res.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == ["rank0", "rank1"]
