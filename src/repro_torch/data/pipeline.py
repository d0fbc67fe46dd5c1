"""Deterministic sharded synthetic-token pipeline (the counterpart of
the reference's ``data/pipeline.py``).

Every batch is a pure function of (seed, step), so a restarted job resumes
bit-identically at step N with no state files.  ``DataConfig``,
``_batch_rng`` and ``host_batch`` are the reference's, line for line: the
same numpy generators give the same tokens.  ``global_arrays`` gives a
data-parallel rank its rows of the global batch as tensors on its device
(``RankRows``); the reference assembles a sharded jax.Array from the same
rows.

The generator is a structured Markov-ish stream (not uniform noise) so
tiny-model training loss has signal to descend.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _batch_rng(cfg: DataConfig, step: int, row: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, row]))


def host_batch(cfg: DataConfig, step: int, *, row_start: int = 0,
               rows: int | None = None) -> dict[str, np.ndarray]:
    """Rows [row_start, row_start+rows) of the global batch at `step`."""
    rows = cfg.global_batch if rows is None else rows
    toks = np.empty((rows, cfg.seq_len + 1), np.int32)
    for i in range(rows):
        rng = _batch_rng(cfg, step, row_start + i)
        # structured stream: random walk over the vocab with repeats
        base = rng.integers(0, cfg.vocab, size=cfg.seq_len // 8 + 2)
        seq = np.repeat(base, 8)[: cfg.seq_len + 1]
        noise = rng.integers(0, cfg.vocab, size=cfg.seq_len + 1)
        mask = rng.random(cfg.seq_len + 1) < 0.15
        toks[i] = np.where(mask, noise, seq)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass(frozen=True)
class RankRows:
    """Where a data-parallel rank's rows go: rank ``rank`` of ``world``
    takes rows [rank * B / world, (rank + 1) * B / world) of the global
    batch of B rows, on ``device``."""
    device: str | torch.device = "cpu"
    rank: int = 0
    world: int = 1


def global_arrays(cfg: DataConfig, step: int, shard: RankRows) -> dict:
    """This rank's rows of the global batch at ``step``: ``tokens`` and
    ``labels`` as int64 tensors (torch's index type; the values are
    ``host_batch``'s) on the rank's device.  The rank materializes its
    rows only."""
    if cfg.global_batch % shard.world:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"over {shard.world} data-parallel ranks")
    rows = cfg.global_batch // shard.world
    batch = host_batch(cfg, step, row_start=shard.rank * rows, rows=rows)
    return {k: torch.from_numpy(v.astype(np.int64)).to(shard.device)
            for k, v in batch.items()}
