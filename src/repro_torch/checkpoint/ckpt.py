"""Checkpointing with fault-tolerance semantics (the counterpart of the
reference's ``checkpoint/ckpt.py``, in its on-disk format).

  * save: ``leaves.npz`` + ``manifest.json`` {step, leaves: name, path,
    shape, dtype, crc32}; written to a temp dir then atomically renamed —
    a crash mid-save never corrupts the latest checkpoint,
  * async: the host copy is taken at ``save``, the write runs on a
    background thread,
  * keep-k GC of old steps,
  * restore: rebuilds tensors on a given device (or each like-leaf's),
    and reshards on load: under a ``layout`` each rank takes its slices,
    whatever mesh saved the checkpoint,
  * sharded trees (``layout``: ``dist.fsdp.ShardedLayout``): one
    checkpoint of whole leaves for all ranks, written by rank 0 after the
    ranks have put every leaf together; every rank restores its slices,
  * integrity: per-leaf crc32 verified on load.

Leaf paths are the reference's ``_flat`` paths: dict keys in sorted
order and sequence indices joined by "/" ("0/layers/attn/wq/w",
"1/mu/...", "1/step" for a (params, opt_state) tuple), so a checkpoint
of either package restores into the other.  Training's leaves are fp32
masters and moments and the int32 step; numpy has no bfloat16.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
import zlib

import numpy as np
import torch


def _flat(tree, prefix: tuple = ()) -> list:
    """(path, leaf) pairs in ``jax.tree_util`` flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flat(tree[k], prefix + (str(k),))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _flat(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _rebuild(tree, make, prefix: tuple = ()):
    """``tree``'s structure with each leaf replaced by make(path, leaf)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, make, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, make, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return make("/".join(prefix), tree)


def _host(leaf) -> np.ndarray:
    """A copy of a leaf on the host, as a numpy array: a CPU tensor is
    copied too, so that an in-place update after ``save`` does not reach
    the checkpoint being written."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


class CheckpointManager:
    """``layout``: the sharded tree's layout when the ranks of a mesh share
    this directory (``dist.fsdp.ShardedLayout``: ``unshard``,
    ``placement``, ``rank``, ``barrier``); None for a tree that one
    process holds whole."""

    def __init__(self, directory: str | pathlib.Path, *, keep: int = 3,
                 async_save: bool = True, layout=None):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self.layout = layout
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ save
    def save(self, step: int, tree) -> None:
        """Copy every leaf to the host now (later in-place updates do not
        reach the checkpoint), then write, on a thread if async.  With a
        ``layout`` every rank takes part in putting each leaf together
        (collectives, in one order) and rank 0 alone writes."""
        self.wait()
        if self.layout is None:
            host = [(path, _host(leaf)) for path, leaf in _flat(tree)]
        else:
            host = [(path, self.layout.unshard(path, leaf))
                    for path, leaf in _flat(tree)]
            if self.layout.rank != 0:
                return
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def wait(self) -> None:
        """Until the last save is written; with a ``layout``, on every
        rank (a barrier after rank 0's write)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.layout is not None:
            self.layout.barrier()

    def _write(self, step: int, host_leaves) -> None:
        tmp = self.dir / f".tmp_step_{step}_{time.time_ns()}"
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": []}
        arrays = {}
        for i, (path, arr) in enumerate(host_leaves):
            name = f"leaf_{i}"
            arrays[name] = arr
            manifest["leaves"].append({
                "name": name, "path": path, "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            })
        np.savez(tmp / "leaves.npz", **arrays)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = self.dir / f"step_{step:010d}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)          # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.dir.glob("step_*"))
        for old in steps[:-self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # --------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        steps = sorted(self.dir.glob("step_*"))
        if not steps:
            return None
        return int(steps[-1].name.split("_")[1])

    def restore(self, tree_like, *, step: int | None = None, device=None,
                verify: bool = True):
        """(tree, step): the checkpoint at ``step`` (default the newest)
        in ``tree_like``'s structure, each leaf a tensor of the saved
        dtype on ``device``, or, when None, on the like-leaf's device (the
        CPU for a leaf that is not a tensor).

        Reshard-on-load: with a ``layout`` each leaf goes through its
        placement (``ShardedLayout.placement``: whole tensor -> this
        rank's slice, relaid where the execution relays it), whatever
        mesh saved the checkpoint.  Leaves are read, and placed on the
        host, one at a time."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        recs = {rec["path"]: rec for rec in manifest["leaves"]}
        if self.layout is not None:
            placements = {path: self.layout.placement(path)
                          for path, _ in _flat(tree_like)}
        else:
            placements = {}

        with np.load(d / "leaves.npz", allow_pickle=False) as z:
            def make(path, like):
                rec = recs[path]
                arr = z[rec["name"]]
                if verify:
                    crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
                    if crc != rec["crc32"]:
                        raise IOError(f"checksum mismatch for {path}")
                t = torch.from_numpy(arr)
                place = placements.get(path)
                if place is not None:
                    t = place(t)
                dev = device if device is not None else (
                    like.device if isinstance(like, torch.Tensor) else "cpu")
                return t.to(dev)
            tree = _rebuild(tree_like, make)
        return tree, manifest["step"]
