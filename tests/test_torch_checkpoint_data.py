"""The port's checkpointing (atomicity, keep-k, integrity, placement, and
the reference's on-disk format read both ways) and data pipeline
(determinism, skip-ahead, a rank's rows), twins of
``tests/test_checkpoint_data.py`` held against the reference."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.data import DataConfig as JDataConfig
from repro.data import host_batch as jhost_batch
from repro.models import build_model as jbuild_model
from repro.training import optimizer as jopt
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, RankRows, global_arrays, host_batch
from repro_torch.models.convert import params_from_jax
from repro_torch.training import optimizer as opt


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 4), generator=g),
            "b": {"c": torch.arange(6, dtype=torch.int32),
                  "d": torch.tensor(3.5)}}


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(opt.tree_leaves(a), opt.tree_leaves(b)))


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    tree = _tree()
    mgr.save(7, tree)
    restored, step = mgr.restore(tree)
    assert step == 7 and _equal(tree, restored)
    assert restored["b"]["c"].dtype == torch.int32


def test_async_save_and_keep_k(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=True)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    mgr.wait()
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(steps) == 2 and steps[-1].endswith(f"{4:010d}")
    assert mgr.latest_step() == 4
    assert not list(tmp_path.glob(".tmp_*"))   # atomic publish cleans up
    assert _equal(mgr.restore(_tree())[0], _tree(4))


def test_save_copies_the_leaves_at_the_call(tmp_path):
    """The host copy is taken at save: an in-place update after it (the
    donated train step's) does not reach the checkpoint."""
    mgr = CheckpointManager(tmp_path, async_save=True)
    tree = _tree()
    want = opt.tree_map(torch.clone, tree)
    mgr.save(1, tree)
    tree["a"].add_(1.0)
    mgr.wait()
    assert _equal(mgr.restore(tree)[0], want)


def test_corruption_detected(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, _tree())
    d = next(tmp_path.glob("step_*"))
    man = json.loads((d / "manifest.json").read_text())
    man["leaves"][0]["crc32"] ^= 0xFF
    (d / "manifest.json").write_text(json.dumps(man))
    with pytest.raises(IOError):
        mgr.restore(_tree())


def test_restore_places_leaves_on_a_device(tmp_path):
    """Restore onto an explicit device (the twin of reshard-on-load onto
    a one-device mesh), and by default onto each like-leaf's device."""
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(3, _tree())
    restored, _ = mgr.restore(_tree(), device="cpu")
    assert all(t.device.type == "cpu" for t in opt.tree_leaves(restored))
    like = {"a": torch.empty(0, device="meta"),
            "b": {"c": np.zeros(0), "d": None}}
    restored, _ = mgr.restore(like)
    assert restored["a"].device.type == "meta"
    assert restored["b"]["c"].device.type == "cpu"


def _training_state(arch="llama3-8b"):
    jcfg = jget_config(arch, smoke=True)
    jparams = jbuild_model(jcfg).init_params(jax.random.PRNGKey(0))
    jstate = jopt.init_state(jparams)
    jstate = {**jstate, "step": jnp.asarray(5, jnp.int32),
              "mu": jax.tree.map(lambda x: x + 0.25, jstate["mu"])}
    return jcfg, jparams, jstate


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A (params, opt_state) checkpoint the reference wrote restores into
    the port's tree with equal leaves, dtypes and the step; the manifest's
    paths are the reference's."""
    jcfg, jparams, jstate = _training_state()
    JCheckpointManager(tmp_path, async_save=False).save(5, (jparams, jstate))
    cfg = get_config("llama3-8b", smoke=True)
    from repro_torch.models import build_model
    like_p = build_model(cfg).init_params(torch.Generator().manual_seed(1),
                                          "cpu", masters=True)
    (params, state), step = CheckpointManager(tmp_path).restore(
        (like_p, opt.init_state(like_p)))
    assert step == 5 and int(state["step"]) == 5
    assert state["step"].dtype == torch.int32
    want = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu",
                           masters=True)
    assert _equal(params, want)
    for x, y in zip(jax.tree.leaves(jstate["mu"]),
                    opt.tree_leaves(state["mu"])):
        assert np.array_equal(y.numpy(), np.asarray(x))
    paths = [r["path"] for r in json.loads(next(tmp_path.glob(
        "step_*")).joinpath("manifest.json").read_text())["leaves"]]
    assert "0/layers/attn/wq/w" in paths and "1/step" in paths


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    jcfg, jparams, jstate = _training_state()
    cfg = get_config("llama3-8b", smoke=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu",
                             masters=True)
    state = {"mu": opt.tree_map(lambda t: t + 0.25, opt.init_state(params)
                                ["mu"]),
             "nu": opt.init_state(params)["nu"],
             "step": torch.tensor(5, dtype=torch.int32)}
    CheckpointManager(tmp_path, async_save=False).save(5, (params, state))
    (rp, rs), step = JCheckpointManager(tmp_path).restore(
        jax.eval_shape(lambda: (jparams, jstate)))
    assert step == 5 and int(rs["step"]) == 5
    for a, b in zip(jax.tree.leaves((rp, rs)),
                    jax.tree.leaves((jparams, jstate))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the manifests agree path for path, crc for crc
    (tmp_path / "ref").mkdir()
    JCheckpointManager(tmp_path / "ref", async_save=False).save(
        5, (jparams, jstate))
    man = lambda d: json.loads(next(d.glob("step_*")).joinpath(
        "manifest.json").read_text())["leaves"]
    assert [(r["path"], r["shape"], r["dtype"], r["crc32"])
            for r in man(tmp_path)] == \
        [(r["path"], r["shape"], r["dtype"], r["crc32"])
         for r in man(tmp_path / "ref")]


def test_data_determinism_and_skip_ahead():
    cfg = DataConfig(vocab=100, seq_len=32, global_batch=8, seed=1)
    b1 = host_batch(cfg, step=5)
    np.testing.assert_array_equal(b1["tokens"],
                                  host_batch(cfg, step=5)["tokens"])
    assert not np.array_equal(b1["tokens"], host_batch(cfg, 6)["tokens"])
    part = host_batch(cfg, step=5, row_start=2, rows=4)
    np.testing.assert_array_equal(part["tokens"], b1["tokens"][2:6])
    # the reference's generator, row for row
    ref = jhost_batch(JDataConfig(vocab=100, seq_len=32, global_batch=8,
                                  seed=1), 5)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(b1[k], ref[k])


def test_data_labels_shifted():
    cfg = DataConfig(vocab=50, seq_len=16, global_batch=2, seed=0)
    b = host_batch(cfg, 0)
    assert b["tokens"].shape == b["labels"].shape == (2, 16)
    assert (b["tokens"] < 50).all() and (b["labels"] < 50).all()
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("world", [1, 2, 4])
def test_global_arrays_gives_each_rank_its_rows(world):
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=8, seed=0)
    ref = jhost_batch(JDataConfig(vocab=100, seq_len=8, global_batch=8,
                                  seed=0), 3)
    rows = 8 // world
    for rank in range(world):
        got = global_arrays(cfg, 3, RankRows("cpu", rank, world))
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int64
            np.testing.assert_array_equal(
                got[k].numpy(), ref[k][rank * rows:(rank + 1) * rows])
    with pytest.raises(ValueError, match="does not split"):
        global_arrays(cfg, 0, RankRows("cpu", 0, 3))


def test_pipeline_functions_are_the_references_line_for_line():
    """DataConfig, _batch_rng and host_batch are copies of the
    reference's (the module imports jax, so it is a twin, not in
    COPIED)."""
    import inspect
    import repro.data.pipeline as ref
    import repro_torch.data.pipeline as port
    for name in ("DataConfig", "_batch_rng", "host_batch"):
        assert inspect.getsource(getattr(port, name)) == \
            inspect.getsource(getattr(ref, name)), name
