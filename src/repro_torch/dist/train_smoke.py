"""Sharded-training smoke (the counterpart of the reference's
``scripts/dist_smoke.py``).

    PYTHONPATH=src python -m repro_torch.dist.train_smoke --world 8 \
        [--device cpu]

Spawns ``--world`` ranks joined over gloo and covers sharded training end
to end on llama3-8b's smoke config: the parameters and moments sharded
FSDP + TP on a (world/2, 2) mesh, ten AdamW steps whose losses descend,
the same on every rank (LOSSES_OK); a checkpoint saved on that mesh and
restored onto a (world/4, 4) mesh, every leaf bitwise equal to the
saved one (RESHARD_OK); and the int8 error-feedback all-reduce over the
data axis's world/2 shards (GRADCOMP_OK).

The ranks run on the card unless ``--device cpu`` is given; without a
card and without that flag it exits with an error.  On one card the
ranks share it, and gloo stages their collectives through the host.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

ARCH = "llama3-8b"
STEPS, SEQ, BATCH = 10, 16, 8


def _check(ok: bool, what=None) -> None:
    if not ok:
        raise AssertionError(what)


def _rank(rank: int, world: int, device: str, root: str) -> dict:
    from ..checkpoint import CheckpointManager
    from ..configs import get_config
    from ..data import DataConfig, RankRows, global_arrays
    from ..launch.mesh import make_host_mesh
    from ..models import build_model
    from ..sharding.rules import flatten_with_paths
    from ..training import optimizer as opt
    from ..training.grad_compression import (init_error_buffers,
                                             make_compressed_allreduce)
    from ..training.train_step import jit_train_step
    from .fsdp import ShardedLayout
    from .serve import shard_model
    if device == "cpu":
        torch.set_num_threads(1)
    cfg = get_config(ARCH, smoke=True)
    mesh = make_host_mesh(data=world // 2, model=2)
    model = shard_model(build_model(cfg), mesh, mode="fsdp")
    params = model.init_params(torch.Generator(device=device).manual_seed(0),
                               device, masters=True)
    state = opt.init_state(params)
    step = jit_train_step(model, opt.AdamWConfig(lr=3e-3, warmup_steps=2,
                                                 total_steps=50),
                          mesh=mesh)
    layout = step.layout
    sharded = sum(model.tp.split(p) or model.fsdp.split(p)
                  for p, _ in flatten_with_paths(params))
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    rows = RankRows(device, mesh.coords["data"], mesh.shape["data"])
    losses = []
    for i in range(STEPS):
        params, state, m = step(params, state, global_arrays(data_cfg, i,
                                                             rows))
        losses.append(float(m["loss"]))

    # ---- save on this mesh, restore onto (world/4, 4) ------------------
    CheckpointManager(root, async_save=False, layout=layout).save(
        STEPS, (params, state))
    saved = [layout.whole(p, t) for p, t in flatten_with_paths(params)]
    mesh2 = make_host_mesh(data=world // 4, model=4)
    model2 = shard_model(build_model(cfg), mesh2, mode="fsdp")
    layout2 = ShardedLayout(model2)
    like = model2.init_params(torch.Generator(device=device), device,
                              masters=True)
    (restored, state2), step0 = CheckpointManager(
        root, layout=layout2).restore((like, opt.init_state(like)))
    placed = [torch.equal(t, layout2.place(p, w)) for (p, t), w in zip(
        flatten_with_paths(restored), saved)]
    equal = [torch.equal(layout2.whole(p, t), w) for (p, t), w in zip(
        flatten_with_paths(restored), saved)]

    # ---- int8 error feedback over the data axis's shards ---------------
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (mesh.shape["data"], 128, 128)).astype(np.float32))
    exact = g.mean(0)
    mine = {"w": g[mesh.coords["data"]].to(device)}
    reduce = make_compressed_allreduce(mesh.data_group)
    errs = init_error_buffers(mine)
    out, errs = reduce(mine, errs)
    err0 = float((out["w"].cpu() - exact).abs().max())
    acc = torch.zeros_like(exact)
    for _ in range(8):
        out, errs = reduce(mine, errs)
        acc += out["w"].cpu()
    return {"losses": losses, "sharded": sharded, "step0": step0,
            "placed": all(placed), "equal": all(equal),
            "leaves": len(saved), "err0": err0,
            "err_avg": float((acc / 8 - exact).abs().max()),
            "scale": float(g.abs().max()) / 127.0}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every rank (default cuda)")
    args = ap.parse_args(argv)
    if args.world % 4:
        ap.error(f"--world {args.world}: the meshes (world/2, 2) and "
                 f"(world/4, 4) need a multiple of 4 ranks")
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        ap.error("no CUDA device is available; pass --device cpu to run the "
                 "ranks on the CPU")
    from ..launch.mesh import run_ranks
    with tempfile.TemporaryDirectory() as d:
        ranks = run_ranks(_rank, args.world, args.world, args.device, d)
    losses = ranks[0]["losses"]
    _check(all(r["losses"] == losses for r in ranks), "ranks disagree")
    _check(all(np.isfinite(losses)), losses)
    _check(np.mean(losses[-3:]) < np.mean(losses[:3]), losses)
    # the leaves split over an axis: wq, wo and the MLP's three (the
    # reference's check counts 6 or more; C13 keeps the one KV head's wk
    # and wv whole on every rank)
    _check(ranks[0]["sharded"] >= 5, ranks[0]["sharded"])
    print("LOSSES_OK", losses[0], losses[-1])
    for r in ranks:
        _check(r["step0"] == STEPS and r["placed"] and r["equal"], r)
    print("RESHARD_OK", ranks[0]["leaves"], "leaves")
    for r in ranks:
        _check(r["err0"] <= (args.world // 2) * r["scale"], r)
        _check(r["err_avg"] < r["err0"] + 1e-7, r)
    print("GRADCOMP_OK", ranks[0]["err0"], ranks[0]["err_avg"])
    print("ALL_OK")


if __name__ == "__main__":
    main()
