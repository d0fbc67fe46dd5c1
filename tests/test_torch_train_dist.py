"""Data-parallel training over gloo ranks on the CPU, and the int8
error-feedback all-reduce, against the reference: ``compressed_psum`` is
bitwise the reference's (run on the stacked gradients under
``jax.vmap(..., axis_name="data")``) at world 1, 2 and 4; at world 2 and
4 (one subprocess each, ``tests/torch_train_ranks.py``) the ranks'
parameters are bitwise equal after every step, the exact mean trains as
one rank on the whole global batch does, and the error-feedback checks
of ``scripts/dist_smoke.py`` hold.  Also the training launcher
``launch.train`` on the CPU, and its refusal without a card."""
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training.grad_compression import compressed_psum as jpsum
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, RankRows, global_arrays
from repro_torch.models import build_model
from repro_torch.training import optimizer as opt
from repro_torch.training.grad_compression import (compressed_psum,
                                                   init_error_buffers,
                                                   make_compressed_allreduce)
from repro_torch.training.train_step import make_train_step

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLDS = (2, 4)
ARCH, SEQ, BATCH, STEPS, LR = "llama3-8b", 16, 8, 3, 3e-3
# exact data parallelism against one rank on the whole global batch: the
# same gradients summed in another order
DP_TOL = 1e-5


def _grads(world, seed=1):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((world, 64, 32)).astype(np.float32),
            "b": (rng.standard_normal((world, 7)) * 1e-3).astype(np.float32)}


def _ref_psum(stacked: dict, errs: dict | None = None):
    """The reference's compressed_psum on every leaf of the stacked
    gradients, one row a replica, under vmap over the data axis."""
    fn = jax.vmap(lambda g, e: jpsum(g, e, ("data",)), axis_name="data")
    out = {}
    for k, g in stacked.items():
        e = np.zeros_like(g) if errs is None else errs[k]
        out[k] = tuple(np.asarray(x) for x in fn(jnp.asarray(g),
                                                 jnp.asarray(e)))
    return out


@pytest.fixture(scope="module")
def case():
    cfg = get_config(ARCH, smoke=True)
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                          "cpu", masters=True)
    return {"arch": ARCH, "params": params, "seq": SEQ,
            "global_batch": BATCH, "steps": STEPS, "lr": LR,
            "grads": None, "ef": None}


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    """Every world's rank results, the worlds run at once."""
    procs = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"train_world{world}")
        torch.save({**case, "grads": _grads(world),
                    "ef": np.random.default_rng(7).standard_normal(
                        (world, 128, 128)).astype(np.float32)},
                   d / "case.pt")
        procs[world] = (d, subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_train_ranks.py"),
             str(d), str(world)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out = {}
    for world, (d, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-4000:]
        out[world] = torch.load(d / "results.pt", weights_only=False)
    return out


@pytest.fixture(scope="module")
def one_rank(case):
    """One rank on the whole global batch: make_train_step's losses and
    parameters after every step."""
    cfg = get_config(ARCH, smoke=True)
    step = make_train_step(build_model(cfg), opt.AdamWConfig(
        lr=LR, warmup_steps=2, total_steps=20))
    params = opt.tree_map(torch.clone, case["params"])
    state = opt.init_state(params)
    dc = DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    losses, snaps = [], []
    for i in range(STEPS):
        params, state, m = step(params, state,
                                global_arrays(dc, i, RankRows()))
        losses.append(float(m["loss"]))
        snaps.append(opt.tree_leaves(params))
    return losses, snaps


def test_compressed_psum_at_world_1_is_the_references_bitwise():
    stacked = _grads(1)
    want = _ref_psum(stacked)
    errs = init_error_buffers({k: torch.from_numpy(v[0])
                               for k, v in stacked.items()})
    out, new = make_compressed_allreduce()(
        {k: torch.from_numpy(v[0]) for k, v in stacked.items()}, errs)
    for k in stacked:
        np.testing.assert_array_equal(out[k].numpy(), want[k][0][0])
        np.testing.assert_array_equal(new[k].numpy(), want[k][1][0])
    # one replica: the mean is the gradient within one quantization step
    g = torch.from_numpy(stacked["w"][0])
    o, _ = compressed_psum(g, torch.zeros_like(g))
    assert float((o - g).abs().max()) <= float(g.abs().max()) / 127 * 1.01


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_psum_is_the_references_bitwise(ranks, world):
    """Every rank's reduced gradient and error buffer equal the
    reference's row for that replica, bit for bit, over two rounds (the
    second from the first's error buffers)."""
    stacked = _grads(world)
    first = _ref_psum(stacked)
    second = _ref_psum(stacked, {k: v[1] for k, v in first.items()})
    for rank, res in enumerate(ranks[world]):
        for k in stacked:
            for got, want in ((res["psum"]["first"][k], first[k][0]),
                              (res["psum"]["errs"][k], first[k][1]),
                              (res["psum"]["second"][k], second[k][0]),
                              (res["psum"]["errs2"][k], second[k][1])):
                np.testing.assert_array_equal(got.numpy(), want[rank])


@pytest.mark.parametrize("mode", ["exact", "compressed"])
@pytest.mark.parametrize("world", WORLDS)
def test_ranks_hold_bitwise_equal_parameters(ranks, world, mode):
    res = ranks[world]
    for r in res[1:]:
        assert r[mode]["losses"] == res[0][mode]["losses"]
        for a_step, b_step in zip(r[mode]["params"], res[0][mode]["params"]):
            assert all(torch.equal(a, b) for a, b in zip(a_step, b_step))


@pytest.mark.parametrize("world", WORLDS)
def test_exact_mean_trains_as_one_rank_on_the_global_batch(ranks, one_rank,
                                                           world):
    losses, snaps = one_rank
    got = ranks[world][0]["exact"]
    scale = max(1.0, max(map(abs, losses)))
    np.testing.assert_allclose(got["losses"], losses, rtol=0,
                               atol=DP_TOL * scale)
    for a_step, b_step in zip(got["params"], snaps):
        for a, b in zip(a_step, b_step):
            torch.testing.assert_close(
                a, b, rtol=0,
                atol=DP_TOL * max(1.0, float(b.abs().max())))


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_training_stays_near_the_exact_mean(ranks, world):
    """The compressed all-reduce trains on quantized gradients: its
    losses stay near the exact mean's (the first step's is equal: the
    same parameters see the same batch)."""
    exact = ranks[world][0]["exact"]["losses"]
    comp = ranks[world][0]["compressed"]["losses"]
    assert comp[0] == exact[0]
    assert max(abs(a - b) for a, b in zip(comp, exact)) < 0.05


@pytest.mark.parametrize("world", WORLDS)
def test_all_reduce_bytes_a_step(ranks, case, world):
    """Both modes move 4 bytes a parameter a step: fp32 sums, or the int8
    values summed as int32; the compressed mode adds one fp32 max a leaf.
    (The mean loss's scalar all_reduce, the same in both, is not
    counted.)"""
    leaves = opt.tree_leaves(case["params"])
    n = sum(t.numel() for t in leaves)
    for r in ranks[world]:
        for c in r["exact"]["comm"]:
            assert c == {"calls": len(leaves), "bytes": 4 * n}
        for c in r["compressed"]["comm"]:
            assert c == {"calls": 2 * len(leaves),
                         "bytes": 4 * n + 4 * len(leaves)}


@pytest.mark.parametrize("world", WORLDS)
def test_error_feedback_converges(ranks, world):
    """scripts/dist_smoke.py's checks: one compressed mean within
    world quantization steps of the exact mean, and the running mean of
    eight more within the first's error."""
    for r in ranks[world]:
        ef = r["ef"]
        assert ef["err0"] <= world * ef["scale"], ef
        assert ef["err_avg"] < ef["err0"] + 1e-7, ef


def _train(*args: str, cuda: bool = False) -> subprocess.CompletedProcess:
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    if not cuda:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=600)


def test_launch_train_descends_and_resumes_on_the_cpu(tmp_path):
    """--smoke --device cpu: 30 steps descend; with --ckpt-dir a second
    run to step 32 restores from step 30's checkpoint and trains 2 more;
    without --device cpu and without a card the launcher exits non-zero;
    the production mesh is refused."""
    args = ["--arch", "llama3-8b", "--smoke", "--seq", "16", "--lr", "3e-3",
            "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    res = _train(*args, "--steps", "30")
    assert res.returncode == 0, res.stderr
    line = next(l for l in res.stdout.splitlines()
                if l.startswith("finished at step 30"))
    first, last = (float(x) for x in
                   line.split("loss ")[1].split(";")[0].split(" -> "))
    assert last < first - 0.1, line
    res = _train(*args, "--steps", "32")
    assert res.returncode == 0, res.stderr
    assert "[restore] resumed from step 30" in res.stdout
    assert "finished at step 32" in res.stdout
    res = _train("--arch", "llama3-8b", "--smoke", "--steps", "2")
    assert res.returncode != 0 and "--device cpu" in res.stderr
    res = _train("--arch", "llama3-8b", "--smoke", "--production-mesh",
                 "--device", "cpu")
    assert res.returncode != 0 and "256 devices" in res.stderr


def test_launch_train_data_parallel_on_the_cpu():
    """--data 2: two gloo ranks on the CPU report the same losses, and
    the frontends' families train on the zero stub."""
    res = _train("--arch", "llama3-8b", "--smoke", "--steps", "3",
                 "--seq", "16", "--batch", "4", "--data", "2", "--device",
                 "cpu")
    assert res.returncode == 0, res.stderr
    assert "2 ranks: losses equal on every rank" in res.stdout
    for arch in ("seamless-m4t-medium", "llava-next-34b"):
        res = _train("--arch", arch, "--smoke", "--steps", "2", "--seq",
                     "8", "--batch", "2", "--device", "cpu")
        assert res.returncode == 0, res.stderr
        assert "frontend is stubbed" in res.stdout
