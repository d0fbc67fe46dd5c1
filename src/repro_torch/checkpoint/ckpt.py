"""Checkpointing with fault-tolerance semantics (the counterpart of the
reference's ``checkpoint/ckpt.py``, in its on-disk format).

  * save: ``leaves.npz`` + ``manifest.json`` {step, leaves: name, path,
    shape, dtype, crc32}; written to a temp dir then atomically renamed —
    a crash mid-save never corrupts the latest checkpoint,
  * async: the host copy is taken at ``save``, the write runs on a
    background thread,
  * keep-k GC of old steps,
  * restore: rebuilds tensors on a given device (or each like-leaf's),
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
    def __init__(self, directory: str | pathlib.Path, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ save
    def save(self, step: int, tree) -> None:
        """Copy every leaf to the host now (later in-place updates do not
        reach the checkpoint), then write, on a thread if async."""
        host = [(path, _host(leaf)) for path, leaf in _flat(tree)]
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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
        dtype and shape on ``device``, or, when None, on the like-leaf's
        device (the CPU for a leaf that is not a tensor)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "leaves.npz", allow_pickle=False) as z:
            by_path = {}
            for rec in manifest["leaves"]:
                arr = z[rec["name"]]
                if verify:
                    crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
                    if crc != rec["crc32"]:
                        raise IOError(
                            f"checksum mismatch for {rec['path']}")
                by_path[rec["path"]] = arr

        def make(path, like):
            dev = device if device is not None else (
                like.device if isinstance(like, torch.Tensor) else "cpu")
            return torch.from_numpy(by_path[path]).to(dev)
        return _rebuild(tree_like, make), manifest["step"]
