"""Training launcher: --arch <id> on the card, or on the CPU when asked (the
counterpart of the reference's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --smoke --steps 30 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --steps 20 --seq 512 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --smoke --steps 30 --data 2 --model 2 --device cpu

fp32 master weights from a seeded generator (``init_params(masters=
True)``), AdamW with a warmup of 10 steps and a cosine decay over
``--steps``, every layer rematerialized, the reference's synthetic token
stream.  ``--data D --model M`` trains on the (D, M) mesh of
``make_host_mesh`` over D x M gloo ranks (on one card the ranks share
it): each data coordinate takes its rows of the global batch, and the
parameters and moments are sharded as ``--sharding`` says, after the
modes of ``param_shardings``: "fsdp" (the default, as the reference's
launcher shards) splits the large leaves over the data axis too, "tp"
keeps each TP-local leaf whole on every data rank.  ``--sharding tp
--model 1`` is plain data parallelism: replicas averaged exactly before
every update.  With ``--ckpt-dir`` the run restores from the newest
checkpoint there and saves every 50 steps and at the end: a sharded run
keeps one checkpoint of whole leaves for all its ranks, replicas one each
in ``rank<r>``.  Runs on the CUDA card unless ``--device cpu`` is given;
without a card and without that flag it exits with an error instead of
falling back.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import statistics

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import ARCHS, get_config
from ..data import DataConfig, RankRows
from ..dist.serve import shard_model
from ..models import build_model
from ..training import LoopConfig, optimizer as opt, run_training
from ..training.train_step import jit_train_step
from .mesh import make_host_mesh, run_ranks


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch (rows), split over --data ranks")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 production mesh (needs 256 devices; "
                         "refused here)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    ap.add_argument("--data", type=int, default=1,
                    help="the mesh's data axis: gloo ranks (default 1)")
    ap.add_argument("--model", type=int, default=1,
                    help="the mesh's model (tensor-parallel) axis "
                         "(default 1)")
    ap.add_argument("--sharding", choices=("fsdp", "tp"), default="fsdp",
                    help="param_shardings' mode: fsdp (default) or tp")
    return ap


def _replicas(args) -> bool:
    """Whether the ranks are plain data-parallel replicas
    (``jit_train_step(group=)``) rather than a sharded mesh."""
    return args.sharding == "tp" and args.model == 1


def train(args: argparse.Namespace, rank: int = 0, world: int = 1,
          log=print) -> dict:
    """One rank's run; returns its losses and step seconds."""
    device = torch.device(args.device)
    if device.type == "cpu" and world > 1:
        # ranks that share a small CPU stall each other's gloo calls
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    cfg = get_config(args.arch, smoke=args.smoke)
    say = log if rank == 0 else (lambda s: None)
    if cfg.family in ("encdec", "vlm"):
        say(f"note: {cfg.family} frontend is stubbed; training uses zero "
            f"prefix embeddings")
    model = build_model(cfg)
    rows, layout = RankRows(device=device, rank=rank, world=world), None
    if world > 1 and not _replicas(args):
        mesh = make_host_mesh(data=args.data, model=args.model)
        model = shard_model(model, mesh, mode=args.sharding)
        rows = RankRows(device=device, rank=mesh.coords["data"],
                        world=args.data)
        say(f"mesh: {mesh.shape}  sharding: {args.sharding}")
    say(f"data ranks: {rows.world}  arch: {cfg.name}  device: {device}")
    params = model.init_params(
        torch.Generator(device=device).manual_seed(0), device, masters=True)
    n = sum(p.numel() for p in opt.tree_leaves(params))
    say(f"params: {n / 1e6:.2f}M"
        + (" on this rank" if model.tp is not None else ""))
    opt_state = opt.init_state(params)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch, seed=0)
    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=10,
                           total_steps=args.steps)
    step = jit_train_step(model, ocfg, microbatches=args.microbatches)
    if model.tp is not None:
        layout = step.layout

    run_step = step
    if cfg.family in ("encdec", "vlm"):
        # the stub frontend's embeddings, zeros, added to every batch
        key_name = "frames" if cfg.family == "encdec" else "patches"
        stub = torch.zeros((args.batch // rows.world, cfg.frontend_len,
                            cfg.d_model), device=device)

        def run_step(p, s, batch):
            return step(p, s, {**batch, key_name: stub})

    ckpt = None
    if args.ckpt_dir:
        d = pathlib.Path(args.ckpt_dir)
        replica = world > 1 and layout is None
        ckpt = CheckpointManager(d / f"rank{rank}" if replica else d,
                                 layout=layout)
    params, opt_state, state = run_training(
        run_step, params, opt_state, data_cfg, rows,
        LoopConfig(total_steps=args.steps, ckpt_every=50, log_every=10),
        ckpt, log=say)
    if state.losses:
        med = statistics.median(state.step_seconds)
        say(f"finished at step {state.step}; loss {state.losses[0]:.4f} "
            f"-> {state.losses[-1]:.4f}; median step {med * 1e3:.1f} ms, "
            f"{args.batch * args.seq / med:.1f} tokens/s")
    else:
        say(f"finished at step {state.step}; nothing left to train")
    return {"losses": state.losses, "step_seconds": state.step_seconds}


def _rank(rank: int, argv: list[str], world: int) -> dict:
    return train(_parser().parse_args(argv), rank, world)


def main(argv: list[str] | None = None) -> None:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.production_mesh:
        ap.error("--production-mesh needs the 16x16 production mesh's 256 "
                 "devices; this launcher trains on one card (--data N gloo "
                 "ranks share it)")
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        ap.error("no CUDA device is available; pass --device cpu to train "
                 "on the CPU")
    if args.data < 1 or args.model < 1 or args.batch % args.data:
        ap.error(f"--batch {args.batch} must split over --data "
                 f"{args.data} ranks")
    world = args.data * args.model
    if world == 1:
        train(args)
        return
    argv = list(argv) if argv is not None else __import__("sys").argv[1:]
    out = run_ranks(_rank, world, argv, world)
    if any(o["losses"] != out[0]["losses"] for o in out):
        raise SystemExit("the ranks report different losses")
    print(f"{world} ranks: losses equal on every rank "
          f"({np.round(out[0]['losses'], 4).tolist()})")


if __name__ == "__main__":
    main()
