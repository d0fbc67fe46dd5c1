"""Host-side training loop with fault-tolerance machinery (the
counterpart of the reference's ``training/loop.py``).

  * auto-restore from the newest checkpoint (exact resume: the data
    pipeline is a pure function of step),
  * periodic + final checkpoints (async, atomic, keep-k),
  * straggler watchdog: per-step wall-time EWMA; steps slower than
    ``straggler_factor`` x EWMA are logged (and counted),
  * NaN/divergence guard: aborts with a checkpoint so the restart path is
    exercised rather than wedged.

A step's wall time ends when its loss is read back to the host, which
waits for the step's device work.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

from ..checkpoint.ckpt import CheckpointManager
from ..data.pipeline import DataConfig, RankRows, global_arrays


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1


@dataclasses.dataclass
class LoopState:
    step: int = 0
    straggler_steps: int = 0
    losses: list = dataclasses.field(default_factory=list)
    # each step's wall seconds, batch assembly excluded (the reference
    # times the same span and keeps only the EWMA)
    step_seconds: list = dataclasses.field(default_factory=list)


def run_training(train_step: Callable, params, opt_state,
                 data_cfg: DataConfig, data_shardings: RankRows | None,
                 loop_cfg: LoopConfig, ckpt: CheckpointManager | None,
                 *, log: Callable[[str], None] = print) -> tuple:
    """Returns (params, opt_state, LoopState).  ``data_shardings``: this
    rank's rows and device (``RankRows``; one CPU rank when None)."""
    shard = data_shardings if data_shardings is not None else RankRows()
    state = LoopState()
    if ckpt is not None and ckpt.latest_step() is not None:
        (params, opt_state), step0 = ckpt.restore((params, opt_state))
        state.step = step0
        log(f"[restore] resumed from step {step0}")

    ewma = None
    while state.step < loop_cfg.total_steps:
        batch = global_arrays(data_cfg, state.step, shard)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        state.step_seconds.append(dt)
        if ewma is None:
            ewma = dt
        elif dt > loop_cfg.straggler_factor * ewma:
            state.straggler_steps += 1
            log(f"[straggler] step {state.step}: {dt:.2f}s vs "
                f"EWMA {ewma:.2f}s")
        ewma = ((1 - loop_cfg.ewma_alpha) * ewma
                + loop_cfg.ewma_alpha * dt)
        state.step += 1
        state.losses.append(loss)
        if not math.isfinite(loss):
            if ckpt is not None:
                ckpt.save(state.step, (params, opt_state))
                ckpt.wait()
            raise FloatingPointError(
                f"non-finite loss at step {state.step}")
        if state.step % loop_cfg.log_every == 0:
            log(f"[train] step {state.step} loss {loss:.4f} "
                f"({dt * 1e3:.0f} ms)")
        if ckpt is not None and state.step % loop_cfg.ckpt_every == 0:
            ckpt.save(state.step, (params, opt_state))
    if ckpt is not None:
        ckpt.save(state.step, (params, opt_state))
        ckpt.wait()
    return params, opt_state, state
