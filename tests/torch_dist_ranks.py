"""Rank program of ``tests/test_torch_dist.py``: serve each case of
``DIR/cases.pt`` on ``WORLD`` gloo ranks on the CPU and write what every
rank saw to ``DIR/results.pt``.

    python tests/torch_dist_ranks.py DIR WORLD
    python tests/torch_dist_ranks.py DIR WORLD disagree

A case holds an arch's smoke config knobs, its (data, model) mesh, the
port's parameters (whole, on the CPU), prompts, new tokens and a cache
length.  Each rank shards the engine over the mesh (``shard_engine``),
prewarms a plan store of the case (rank 0 first, capture source), runs
one greedy ``generate`` and one fp32 prefill, counting solver calls and
all-reduces.  With ``disagree`` each rank instead samples its own token
(rank 0 the stop token on every row, the others another) and writes the
error its ``generate`` raised.  Imports nothing of JAX.
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
        eng.prewarm_plans(None, B, S)
        calls0 = solver_stats()["calls"]
        tokens = eng.generate(case["prompts"])
        calls = solver_stats()["calls"] - calls0
        generate_reduces = tp.all_reduces
        with torch.inference_mode():
            logits = eng.model.prefill(
                eng.params, {"tokens": torch.from_numpy(
                    case["prompts"]).long()}, max_len=case["cache"])[0]
        out.append({"name": case["name"], "tokens": tokens,
                    "logits": logits, "solver_calls": calls,
                    "generate_all_reduces": generate_reduces,
                    "prefill_all_reduces": tp.all_reduces - generate_reduces,
                    "token_checks": tp.token_checks,
                    "coords": dict(mesh.coords),
                    "replicated": tp.replicated})
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


def main() -> None:
    from repro_torch.launch.mesh import run_ranks
    root, world = sys.argv[1], int(sys.argv[2])
    if sys.argv[3:] == ["disagree"]:
        torch.save(run_ranks(disagree_at_stop, world, 7, timeout_s=60),
                   f"{root}/results.pt")
        return
    cases = torch.load(f"{root}/cases.pt", weights_only=False)
    torch.save(run_ranks(serve_cases, world, cases, root, timeout_s=300),
               f"{root}/results.pt")


if __name__ == "__main__":
    main()
