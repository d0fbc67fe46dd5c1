"""Training cells: the port's ``jit_train_step`` run back to back.

Set-up makes the fp32 master weights on the device from the seed, builds
one step object with its model and optimizer state, and drives it
through its first three steps with the window's own feed: each step's
rows are a pure function of (seed, step).  Those steps are recorded for
``correct`` (each loss; every leaf's first gradient as the optimizer got
it, worked out from its first moment after one step; every leaf after
the third step, copied to the host before the fourth updates it in
place).  The window then runs the same object on the following rows.
A traced run profiles one more step after the window, and one more
with the host's operators recorded.

``correct``: once the window has closed, the peak memory read and the
port's state freed, the plain reference draws the same weights again and
takes the same three steps in fp32.  Three numbers are compared: the
largest relative gap of a step's loss; over the leaves, the largest gap
between the two first gradients' norms; and over the leaves the
reference's first gradient moves (at least a thousandth of the median
leaf's), the largest gap between the norms of the change after three
steps.  A leaf's gap is measured against the reference's norm of that
leaf or of the median leaf, whichever is larger.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from ..reference import dense as R
from . import devtrace
from . import traffic as T
from . import weights as W
from .run_record import Run, arch_config, log

CHECKED_STEPS = 3


def adamw_config(job: dict):
    from repro_torch.training.optimizer import AdamWConfig
    keys = ("lr", "beta1", "beta2", "eps", "weight_decay", "grad_clip",
            "warmup_steps", "total_steps", "min_lr_frac")
    return AdamWConfig(**{k: job[k] for k in keys})


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's |prog - ref| over max(ref's leaf, ref's median leaf),
    over the leaves in ``keep`` (all by default)."""
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, keep).values())


def compare(prog: dict, ref: dict) -> dict:
    """The three numbers compared, from the port's and the reference's
    records ({"losses", "grad_norms", "change"})."""
    loss = max(abs(a - b) / abs(b)
               for a, b in zip(prog["losses"], ref["losses"]))
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    moved = {k for k, v in g.items() if v >= 1e-3 * med}
    return {"loss": loss, "grad": leaf_gap(prog["grad_norms"], g),
            "change": leaf_gap(prog["change"], ref["change"], moved)}


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, store_dir=None, control: bool = False) -> dict:
    from repro_torch.models import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import jit_train_step
    cfg, job = cell.config, cell.traffic
    cuda = device != "cpu"
    B, S, V = job["batch"], job["seq"], cfg["vocab_size"]

    def feed(i: int) -> dict:
        return {k: torch.as_tensor(v, device=device)
                for k, v in T.train_rows(seed, i, B, S, V).items()}

    t = time.perf_counter()
    params = W.make(cfg, seed, device, masters=True)
    state = opt.init_state(params)
    log(f"set-up: torch and the port imported at {t - t_start:.2f} s; "
        f"weights and moments {time.perf_counter() - t:.2f} s")
    step = jit_train_step(build_model(arch_config(cfg)), adamw_config(job),
                          remat=job["remat"])
    prog = {"losses": []}
    for i in range(CHECKED_STEPS):
        params, state, m = step(params, state, feed(i))
        prog["losses"].append(float(m["loss"]))
        if i == 0:
            prog["grad_norms"] = {
                k: float(mu.norm()) / (1 - job["beta1"])
                for k, mu in W.leaves(state["mu"])}
    after = {k: p.detach().to("cpu", copy=True)
             for k, p in W.leaves(params)}
    log(f"set-up: {CHECKED_STEPS} steps, losses {prog['losses']}, done at "
        f"{time.perf_counter() - t_start:.2f} s")

    t0 = time.perf_counter()
    t1 = t0 + seconds
    ends, losses = [], []
    i = CHECKED_STEPS
    while time.perf_counter() < t1:
        params, state, m = step(params, state, feed(i))
        losses.append(float(m["loss"]))
        ends.append(time.perf_counter())
        i += 1
    record = Run(cfg=cfg, traffic=job, window=(t0, t1),
                 setup_s=t0 - t_start,
                 steps=[(t, B * S) for t in ends])
    if trace and cuda:
        nxt = feed(i)
        record.profile = devtrace.profile(
            lambda: step(params, state, nxt))
        record.host_profile = devtrace.profile(
            lambda: step(params, state, nxt), host=True)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    done = [x for t, x in zip(ends, losses) if t <= t1]
    failed = sum(not math.isfinite(x) for x in done)
    del params, state, step, m
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    log(f"window: {len(done)} steps ending at "
        f"{[round(t - t0, 3) for t in ends]} s, losses {losses}, peak "
        f"{peak / 2**30:.2f} GiB")
    R.exact()
    t = time.perf_counter()
    params0 = W.make(cfg, seed, device, masters=True)
    prog["change"] = {k: float((after[k].to(device) - p).norm())
                      for k, p in W.leaves(params0)}
    del after
    batches = [feed(i) for i in range(CHECKED_STEPS)]
    spec = R.Spec.of(cfg)
    ref = R.train(params0, batches, spec, job)
    log(f"reference: {CHECKED_STEPS} steps in {time.perf_counter() - t:.2f}"
        f" s, losses {ref['losses']}")
    nums = compare(prog, ref)
    for what in ("grad_norms", "change"):
        worst = sorted(leaf_gaps(prog[what], ref[what]).items(),
                       key=lambda kv: -kv[1])[:3]
        log(f"worst leaves by {what}: {worst}")
    lim = cell.limits
    checks = {k: {"value": v, "limit": lim[k]} for k, v in nums.items()}
    out = {"run": record, "attempted": len(done), "failed": failed,
           "memory_peak_bytes": peak,
           "correct": failed == 0 and all(v <= lim[k]
                                          for k, v in nums.items()),
           "checks": checks,
           "compared": {"steps": CHECKED_STEPS,
                        "losses": prog["losses"],
                        "reference_losses": ref["losses"]}}
    if control:
        low = R.train(params0, batches, spec, job, fp8=True)
        half = R.train(params0, [{k: v[:B // 2] for k, v in b.items()}
                                 for b in batches], spec, job)
        out["control"] = {"fp8": compare(low, ref),
                          "half_batch": compare(half, ref)}
    return out
