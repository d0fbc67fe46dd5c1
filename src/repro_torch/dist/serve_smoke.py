"""Sharded-serving smoke (the counterpart of the reference's
``scripts/dist_serve_smoke.py``).

    PYTHONPATH=src python -m repro_torch.dist.serve_smoke --world 4 \
        [--device cpu]

Spawns ``--world`` ranks joined over gloo (a ``file://`` rendezvous in a
temporary directory) and covers the dist subsystem end to end:
llama3-8b's smoke config TP-sharded over every rank, greedy tokens
identical to the single-rank port's, with zero solver calls after rank
0's prewarm of the plan store (TOKENS_OK); a sharded-plan prewarm into a
store whose second pass is all hits and zero solves (PREWARM_OK); and
the scheduler's ``mesh_chips`` deployment filling the store's sharded
section at construction (SCHED_OK).

The ranks run on the card unless ``--device cpu`` is given; without a
card and without that flag it exits with an error.  On one card the
ranks share it, and gloo stages their all-reduces through the host.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

ARCH = "llama3-8b"
SERVE = dict(max_new_tokens=12, temperature=0.0, cache_len=64)
BATCH, PROMPT_LEN = 4, 10


def _engine(device: str, store_dir: str | None = None):
    """The smoke config's engine on ``device``, weights from seed 0
    (made on the CPU, so every device and rank holds the same ones)."""
    from ..configs import get_config
    from ..models import build_model
    from ..models.model import tree_to
    from ..planner.store import PlanStore
    from ..serving import Engine, ServeConfig
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg)
    params = tree_to(model.init_params(torch.Generator().manual_seed(0),
                                       "cpu"), device)
    store = PlanStore(store_dir) if store_dir is not None else None
    return Engine(model, params, ServeConfig(**SERVE), plan_store=store)


def _tokens_rank(rank: int, world: int, device: str, store_dir: str,
                 prompts: np.ndarray) -> dict:
    """One rank of TOKENS_OK: the engine sharded over every rank,
    prewarmed (rank 0 first), then one greedy generate."""
    from ..core.solver import solver_stats
    from ..models import build_model
    from ..obs.registry import get_registry
    from ..sharding.rules import flatten_with_paths
    from .serve import shard_engine
    torch.set_num_threads(1)
    eng = _engine(device, store_dir)
    mesh = shard_engine(eng, model_axis=world)
    whole = build_model(eng.model.cfg).init_params(torch.Generator(),
                                                   "meta")
    placed = sum(1 for (_, a), (_, b) in zip(flatten_with_paths(eng.params),
                                             flatten_with_paths(whole))
                 if a.shape != b.shape)
    eng.prewarm_plans(ARCH, BATCH, PROMPT_LEN)
    calls0 = solver_stats()["calls"]
    tokens = eng.generate(prompts)
    return {"tokens": tokens,
            "solver_calls": solver_stats()["calls"] - calls0,
            "mesh": dict(zip(mesh.axis_names, mesh.devices.shape)),
            "placed": placed, "all_reduces": eng.model.tp.all_reduces,
            "sharded": get_registry().get("dist.engines_sharded")}


def _check(ok: bool, what=None) -> None:
    if not ok:
        raise AssertionError(what)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4,
                    help="ranks to spawn, all on the model axis")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every rank (default cuda)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is available; pass --device cpu to run "
                 "the ranks on the CPU")
    from ..configs import get_config
    from ..core.solver import solver_stats
    from ..launch.mesh import run_ranks
    from ..obs.registry import get_registry
    from ..serving.sched import ContinuousScheduler, SchedConfig
    cfg = get_config(ARCH, smoke=True)
    world = args.world
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, size=(BATCH, PROMPT_LEN)).astype(
        np.int32)

    # ---- TP-sharded greedy serving == single-rank oracle ---------------
    want = _engine(args.device).generate(prompts)
    with tempfile.TemporaryDirectory() as d:
        ranks = run_ranks(_tokens_rank, world, world, args.device, d,
                          prompts)
    for r, got in enumerate(ranks):
        _check(got["mesh"] == {"data": 1, "model": world}, got["mesh"])
        _check(got["placed"] > 3, got["placed"])   # params really split
        _check(got["solver_calls"] == 0, (r, got["solver_calls"]))
        _check(got["sharded"] >= 1)
        _check(np.array_equal(want, got["tokens"]),
               (r, want, got["tokens"]))
    print("TOKENS_OK", ranks[0]["tokens"].shape,
          "all_reduces", ranks[0]["all_reduces"])

    # ---- sharded prewarm: second pass is all store hits, zero solves ---
    shapes = [(BATCH, cfg.vocab, cfg.d_model), (BATCH, cfg.d_ff, cfg.d_model)]
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(args.device, d)
        planned = eng.prewarm_sharded_shapes(shapes, n_chips=world)
        _check(planned > 0, planned)
        _check(eng.plan_store.num_sharded() > 0)
        calls0 = solver_stats()["calls"]
        hits0 = get_registry().get("dist.store_hits")
        eng.prewarm_sharded_shapes(shapes, n_chips=world)
        _check(solver_stats()["calls"] == calls0)
        _check(get_registry().get("dist.store_hits") > hits0)
        print("PREWARM_OK", planned, eng.plan_store.num_sharded())

    # ---- scheduler mesh_chips deployment populates sharded section -----
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(args.device, d)
        sc = SchedConfig(slots=2, chunk_widths=(4, 16), mesh_chips=world)
        sched = ContinuousScheduler(eng, sc)
        _check(sched.prewarmed_sharded > 0, sched.prewarmed_sharded)
        _check(eng.plan_store.num_sharded() > 0)
        # a second deployment against the same store resolves every
        # partition and tiling from it: zero solver invocations
        calls0 = solver_stats()["calls"]
        sched2 = ContinuousScheduler(eng, sc)
        _check(sched2.prewarmed_sharded == sched.prewarmed_sharded)
        _check(solver_stats()["calls"] == calls0)
        print("SCHED_OK", sched.prewarmed_sharded)

    print("ALL_OK")


if __name__ == "__main__":
    main()
