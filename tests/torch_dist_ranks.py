"""Rank program of ``tests/test_torch_dist*.py``: serve each case of
``DIR/cases.pt`` on ``WORLD`` gloo ranks on the CPU and write what every
rank saw to ``DIR/results.pt``.

    python tests/torch_dist_ranks.py DIR WORLD
    python tests/torch_dist_ranks.py DIR WORLD sched
    python tests/torch_dist_ranks.py DIR WORLD disagree

A case holds an arch's smoke config knobs, its (data, model) mesh, the
port's parameters (whole, on the CPU), prompts (and the frontends'
frames or patches), new tokens and a cache length.  Each rank shards the
engine over the mesh (``shard_engine``), prewarms a plan store of the
case (rank 0 first, capture source), runs one greedy ``generate`` and
one fp32 prefill, counting solver calls and all-reduces.  With
``sched`` a case is a trace instead, which each rank replays through a
continuous scheduler on its sharded engine (or a ``TPReplicaRouter`` of
``replicas``), in trace time from a ``RankClock``; a case may give rank
1 a clock that runs ``skew_s`` ahead and ticks that sleep
``slow_tick_s`` longer, or install the same seeded ``faults`` on every
rank.  With ``disagree`` each rank instead samples its
own token (rank 0 the stop token on every row, the others another) and
writes the error its ``generate`` raised.  Imports nothing of JAX.
"""
import dataclasses
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))


def serve_cases(rank: int, cases: list, root: str) -> list:
    from repro_torch.configs import get_config
    from repro_torch.core.solver import solver_stats
    from repro_torch.dist.serve import shard_engine
    from repro_torch.models import build_model
    from repro_torch.planner.store import PlanStore
    from repro_torch.serving import Engine, ServeConfig
    torch.set_num_threads(1)
    out = []
    for case in cases:
        cfg = dataclasses.replace(get_config(case["arch"], smoke=True),
                                  **case["knobs"])
        eng = Engine(build_model(cfg), case["params"],
                     ServeConfig(max_new_tokens=case["new"],
                                 cache_len=case["cache"]),
                     plan_store=PlanStore(f"{root}/{case['name']}"))
        data, model = case["mesh"]
        mesh = shard_engine(eng, model_axis=model, data_axis=data)
        tp = eng.model.tp
        B, S = case["prompts"].shape
        extra = case.get("extra")
        eng.prewarm_plans(None, B, S)
        calls0 = solver_stats()["calls"]
        tokens = eng.generate(case["prompts"], extra_batch=extra)
        calls = solver_stats()["calls"] - calls0
        generate_reduces = tp.all_reduces
        batch = {"tokens": torch.from_numpy(case["prompts"]).long()}
        for key, value in (extra or {}).items():
            batch[key] = torch.from_numpy(value)
        with torch.inference_mode():
            logits = eng.model.prefill(eng.params, batch,
                                       max_len=case["cache"])[0]
        out.append({"name": case["name"], "tokens": tokens,
                    "logits": logits, "solver_calls": calls,
                    "generate_all_reduces": generate_reduces,
                    "prefill_all_reduces": tp.all_reduces - generate_reduces,
                    "token_checks": tp.token_checks,
                    "coords": dict(mesh.coords),
                    "replicated": tp.replicated, "relaid": tp.relaid})
    return out


def sched_cases(rank: int, cases: list, root: str) -> list:
    """Each case's trace through a continuous scheduler (or a router of
    ``replicas``) on this rank's shard: the streams, the solver calls of
    the prewarm and of the replay, the collectives, and the clock
    readings rank 1's own clock gave at each tick's start against the
    ones the ticks took (rank 0's)."""
    import time

    from repro_torch.configs import get_config
    from repro_torch.core.solver import solver_stats
    from repro_torch.dist.serve import shard_engine
    from repro_torch.faults import FaultInjector, FaultSpec, set_injector
    from repro_torch.models import build_model
    from repro_torch.planner.store import PlanStore
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.router import RouterConfig
    from repro_torch.serving.router.tp import TPReplicaRouter
    from repro_torch.serving.sched import (ContinuousScheduler,
                                           SchedConfig, replay)
    from repro_torch.serving.sched.tp import RankClock
    torch.set_num_threads(1)
    out = []
    for case in cases:
        cfg = dataclasses.replace(get_config(case["arch"], smoke=True),
                                  **case["knobs"])
        eng = Engine(build_model(cfg), case["params"],
                     ServeConfig(max_new_tokens=case["new"],
                                 cache_len=case["cache"]),
                     plan_store=PlanStore(f"{root}/{case['name']}"))
        shard_engine(eng, model_axis=torch.distributed.get_world_size())
        tp = eng.model.tp
        scfg = SchedConfig(**case["sched"])
        skewed = rank == 1 and case.get("skew_s")
        calls0 = solver_stats()["calls"]
        if case.get("replicas"):
            router = TPReplicaRouter(eng, RouterConfig(
                replicas=case["replicas"], sched=scfg))
            scheds = router.scheds
        else:
            clock = RankClock(tp)
            scheds = [ContinuousScheduler(eng, scfg, clock=clock.now)]
        prewarm_calls = solver_stats()["calls"] - calls0
        own = []
        for sched in scheds:
            if skewed:
                ahead = sched.clock
                sched.clock = lambda f=ahead: f() + case["skew_s"]
                step = sched._step_inner

                def slow(tick_sp, step=step, sched=sched):
                    own.append(sched.clock())
                    time.sleep(case["slow_tick_s"])
                    step(tick_sp)

                sched._step_inner = slow
        calls0 = solver_stats()["calls"]
        set_injector(FaultInjector([FaultSpec(site, at=at) for site, at
                                    in case.get("faults", ())], seed=0))
        try:
            if case.get("replicas"):
                results = router.route_trace(case["trace"])
            else:
                results = replay(scheds[0], case["trace"], clock)
        finally:
            set_injector(None)
        out.append({
            "name": case["name"],
            "streams": {r.req_id: (r.tokens, r.finish_reason)
                        for r in results},
            "prewarm_solver_calls": prewarm_calls,
            "solver_calls": solver_stats()["calls"] - calls0,
            "ticks": sum(s.metrics.steps for s in scheds),
            "broadcasts": tp.broadcasts, "token_checks": tp.token_checks,
            "own_clock": own,
            "per_replica": [len(s.results) for s in scheds]})
    return out


def disagree_at_stop(rank: int, stop: int) -> str:
    """llama3-8b smoke with a stop token, where rank 0 samples the stop
    token on every row and the other ranks do not: rank 0's rows are
    done at once, the others' never.  Returns the error ``generate``
    raised on this rank ("" if none)."""
    from repro_torch.configs import get_config
    from repro_torch.dist.serve import shard_engine
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, ServeConfig
    torch.set_num_threads(1)
    model = build_model(get_config("llama3-8b", smoke=True))
    eng = Engine(model, model.init_params(torch.Generator().manual_seed(0),
                                          "cpu"),
                 ServeConfig(max_new_tokens=12, cache_len=32,
                             stop_token=stop))
    shard_engine(eng, model_axis=torch.distributed.get_world_size())
    token = stop if rank == 0 else stop + 1
    eng.sample = lambda logits, rng: torch.full(
        logits.shape[:1], token, dtype=torch.int32)
    try:
        eng.generate(torch.zeros((2, 4), dtype=torch.int32).numpy())
    except RuntimeError as e:
        return str(e)
    return ""


def run_worlds(roots: dict, *mode: str) -> dict:
    """This program on each world's ``DIR/cases.pt`` at once (``roots``:
    world -> DIR; one subprocess a world, all started together, with the
    ``mode`` arguments); each world's results."""
    import subprocess
    procs = {world: subprocess.Popen(
        [sys.executable, __file__, str(root), str(world), *mode],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for world, root in roots.items()}
    for proc in procs.values():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(log)
    return {world: torch.load(f"{root}/results.pt", weights_only=False)
            for world, root in roots.items()}


def main() -> None:
    from repro_torch.launch.mesh import run_ranks
    root, world = sys.argv[1], int(sys.argv[2])
    if sys.argv[3:] == ["disagree"]:
        torch.save(run_ranks(disagree_at_stop, world, 7, timeout_s=60),
                   f"{root}/results.pt")
        return
    cases = torch.load(f"{root}/cases.pt", weights_only=False)
    fn = sched_cases if sys.argv[3:] == ["sched"] else serve_cases
    torch.save(run_ranks(fn, world, cases, root, timeout_s=300),
               f"{root}/results.pt")


if __name__ == "__main__":
    main()
