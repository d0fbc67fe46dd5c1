"""Rank program of ``tests/test_torch_train_dist.py``: train the case of
``DIR/case.pt`` on ``WORLD`` data-parallel gloo ranks on the CPU and
write what every rank saw to ``DIR/results.pt``.

    python tests/torch_train_ranks.py DIR WORLD

The case holds an arch's smoke config name, the port's fp32 master
parameters (on the CPU), the data stream (vocab, sequence, global batch),
the steps and the learning rate, and stacked per-rank gradients for the
all-reduce checks.  Each rank trains with ``jit_train_step`` twice, by
the exact mean and by the int8 error-feedback all-reduce, each on its
rows of the global batch, recording every step's loss, parameters and
all_reduce counters; then runs ``compressed_psum`` on its row of the
stacked gradients (twice, the second time from the first's error
buffers), and the error-feedback convergence check of
``scripts/dist_smoke.py``.  Imports nothing of JAX.
"""
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))


def train_rank(rank: int, case: dict, world: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, RankRows, global_arrays
    from repro_torch.models import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.grad_compression import (
        compressed_psum, init_error_buffers, make_compressed_allreduce)
    from repro_torch.training.train_step import jit_train_step
    torch.set_num_threads(1)
    cfg = get_config(case["arch"], smoke=True)
    model = build_model(cfg)
    dc = DataConfig(vocab=cfg.vocab, seq_len=case["seq"],
                    global_batch=case["global_batch"])
    ocfg = opt.AdamWConfig(lr=case["lr"], warmup_steps=2, total_steps=20)
    out = {}
    for mode in ("exact", "compressed"):
        params = opt.tree_map(torch.clone, case["params"])
        state = opt.init_state(params)
        step = jit_train_step(model, ocfg, compress=mode == "compressed")
        losses, snaps, comm = [], [], []
        for i in range(case["steps"]):
            batch = global_arrays(dc, i, RankRows("cpu", rank, world))
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            snaps.append([t.clone() for t in opt.tree_leaves(params)])
            comm.append({k: v for k, v in step.comm.items()
                         if k != "seconds"})
        out[mode] = {"losses": losses, "params": snaps, "comm": comm}
    # compressed_psum on this rank's row of the stacked gradients
    grads = {k: torch.from_numpy(v[rank]) for k, v in case["grads"].items()}
    reduce = make_compressed_allreduce()
    errs = init_error_buffers(grads)
    first, errs = reduce(grads, errs)
    second, errs2 = reduce(grads, errs)
    out["psum"] = {"first": first, "errs": errs, "second": second,
                   "errs2": errs2}
    # error feedback: the running mean of repeated reductions of the same
    # gradients approaches the exact mean
    g = torch.from_numpy(case["ef"][rank])
    exact = torch.from_numpy(case["ef"]).mean(0)
    e = torch.zeros_like(g)
    o, e = compressed_psum(g, e)
    err0 = float((o - exact).abs().max())
    acc = torch.zeros_like(g)
    for _ in range(8):
        o, e = compressed_psum(g, e)
        acc += o
    out["ef"] = {"err0": err0,
                 "err_avg": float((acc / 8 - exact).abs().max()),
                 "scale": float(torch.from_numpy(case["ef"]).abs().max())
                 / 127.0}
    return out


if __name__ == "__main__":
    from repro_torch.launch.mesh import run_ranks
    root, world = pathlib.Path(sys.argv[1]), int(sys.argv[2])
    case = torch.load(root / "case.pt", weights_only=False)
    torch.save(run_ranks(train_rank, world, case, world),
               root / "results.pt")
