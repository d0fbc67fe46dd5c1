"""Meta-device dry-run of one rank per (arch x shape x mesh) cell (the
counterpart of the reference's ``launch/dryrun.py``, which compiles
every cell ahead of time on 512 fake XLA devices).

The port runs SPMD by hand: every rank runs the same program on its
slices (``models.parallel.TensorParallel`` over the mesh's "model" axis,
``dist.fsdp.FullyShardedData`` over its data axes).  So a cell's program
is one rank's, and rank 0's stands for all.  For every cell this module:

  1. builds the model with rank 0's execution layout on
     ``launch.mesh.make_production_mesh`` (16 x 16, or 2 x 16 x 16), as
     ``dist.serve.shard_model`` installs it (``--sharding fsdp``: TP and
     FSDP; ``tp``: TP with the data axes replicated), and makes the
     rank's parameters on the meta device (nothing is allocated);
  2. takes the cell's entry on the rank's rows of the shape's global
     batch (``Model.input_specs``): the train step (``jit_train_step``:
     forward, remat recompute, backward, the gradient reductions and
     AdamW on fp32 masters), the prefill, or one decode step against a
     ``seq_len`` cache, through ``launch.hlo_analysis.analyze_program``;
  3. records ``n_params`` (the whole model's), memory, the analysis, the
     collectives the rank makes (counted on meta tensors without running,
     ``launch.roofline.collective_stats``) and the Hopper roofline, with
     ``chips`` the mesh's size, to ``--out``/<cell>.json.

A shape the config skips is recorded ``skipped`` with the reference's
reason; a cell the port's layout cannot run is recorded ``error`` with
its exception, and the command then exits 1, as the reference's does.
Nothing is written under ``benchmarks/``: the records go to ``--out``
(default ``dryrun_out/`` at the repository's root, which git ignores).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape decode_32k --mesh pod256 --out DIR
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, get_config
from ..dist.serve import shard_model
from ..launch.hlo_analysis import analyze_program
from ..launch.mesh import make_production_mesh
from ..launch.roofline import Roofline, collective_stats, model_flops_estimate
from ..models import build_model
from ..training import optimizer as opt
from ..training.train_step import jit_train_step

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "dryrun_out"
# the group each kind of collective runs over
_DATA_KINDS = ("fsdp_gather", "reduce_scatter", "data_mean", "data_stats")


def rank_zero_mesh(multi_pod: bool):
    """The production mesh with rank 0's coordinates."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    return dataclasses.replace(mesh, rank=0,
                               coords={a: 0 for a in mesh.axis_names})


def local_shape(shape, mesh):
    """The shape of one rank's rows: the global batch split over the data
    axes where it divides them, else whole on every rank (the rules'
    ``sanitize_spec``)."""
    dp = mesh.data_ranks
    B = shape.global_batch
    return dataclasses.replace(shape, global_batch=B // dp if B % dp == 0
                               else B)


def cell_program(model, cfg, shape):
    """(fn, example args, comm) of a cell's entry on one rank of
    ``model``'s mesh, at ``shape`` (the rank's rows): the arguments are
    meta tensors (``Model.input_specs``), and ``comm()`` gives the
    collectives the last call of ``fn`` counted by kind."""
    params = model.init_params(torch.Generator(), "meta",
                               masters=shape.kind == "train")
    specs = model.input_specs(shape)
    if shape.kind == "train":
        step = jit_train_step(model, opt.AdamWConfig(), remat=True)
        return (step, (params, opt.init_state(params), specs),
                lambda: step.comm)
    comm = model.tp.comm if model.tp is not None else {}
    comm.clear()
    if shape.kind == "prefill":
        # VLM prefill caches hold the patch prefix + the token context
        extra = cfg.frontend_len if cfg.family == "vlm" else 0

        def prefill(params, batch):
            with torch.no_grad():
                logits, _ = model.prefill(params, batch,
                                          max_len=shape.seq_len + extra)
            return logits   # cache layout checked by the decode cell
        return prefill, (params, specs), lambda: comm

    # decode: one new token against a seq_len cache, at its last position
    def decode(params, cache, tokens):
        with torch.no_grad():
            logits, _ = model.decode_step(params, cache, tokens,
                                          shape.seq_len - 1)
        return logits
    return (decode, (params, specs["cache"], specs["tokens"]),
            lambda: comm)


def group_sizes(comm: dict, mesh) -> dict:
    """kind -> the chips its collectives run over: the data kinds over the
    data axes, the gradient norm over the world, the tensor-parallel
    kinds over "model"."""
    world = math.prod(mesh.shape.values())
    return {k: (mesh.data_ranks if k in _DATA_KINDS else
                world if k == "grad_norm" else mesh.shape.get("model", 1))
            for k in comm}


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             sharding_mode: str = "fsdp", out_dir: pathlib.Path = RESULTS_DIR,
             overrides: dict | None = None, tag: str = "") -> dict:
    mesh_name = "pod512" if multi_pod else "pod256"
    cell = f"{arch}_{shape_name}_{mesh_name}_{sharding_mode}"
    if tag:
        cell += f"_{tag}"
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{cell}.json"

    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    skip = dict(cfg.skipped_shapes()).get(shape_name)
    if skip is not None:
        rec = {"cell": cell, "status": "skipped", "reason": skip}
        out_path.write_text(json.dumps(rec, indent=1))
        return rec

    t0 = time.time()
    mesh = rank_zero_mesh(multi_pod)
    try:
        whole = build_model(cfg)
        n_params = sum(math.prod(t.shape) for t in _leaves(
            whole.init_params(torch.Generator(), "meta")))
        model = shard_model(whole, mesh, mode=sharding_mode)
        rank_shape = local_shape(shape, mesh)
        fn, args, comm = cell_program(model, cfg, rank_shape)
        t_lower = time.time() - t0
        ana = analyze_program(fn, *args)
        t_compile = time.time() - t0 - t_lower
        chips = math.prod(mesh.shape.values())
        coll = collective_stats(comm(), group_sizes(comm(), mesh))
        rl = Roofline(flops=ana["flops"], hbm_bytes=ana["bytes"],
                      link_bytes=coll.link_bytes, chips=chips,
                      model_flops=model_flops_estimate(cfg, shape, n_params),
                      flops_by_dtype=ana["flops_by_dtype"])
        rec = {
            "cell": cell, "status": "ok", "arch": arch,
            "shape": shape_name, "mesh": mesh_name,
            "sharding": sharding_mode, "chips": chips,
            "n_params": n_params, "rank_batch": rank_shape.global_batch,
            "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
            "memory": {"generated_code_size_in_bytes": None,
                       **ana["memory"]},
            "cost": {"flops": ana["flops"], "bytes accessed": ana["bytes"]},
            "hlo_analysis": {k: ana[k] for k in (
                "flops", "bytes", "flops_by_dtype", "other_ops", "kernels",
                "ops", "trace_s")},
            "collectives": coll.as_dict(),
            "roofline": rl.as_dict(),
        }
    except Exception as e:   # a cell the layout cannot run is recorded
        rec = {"cell": cell, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-4000:]}
    out_path.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["pod256", "pod512", "both"],
                    default="both")
    ap.add_argument("--sharding", choices=["fsdp", "tp"], default="fsdp")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value")
    ap.add_argument("--tag", type=str, default="",
                    help="cell-name suffix for variants")
    ap.add_argument("--out", type=str, default=str(RESULTS_DIR),
                    help="directory for the cells' records")
    args = ap.parse_args(argv)
    if not (args.arch or args.all):
        ap.error("name an --arch or ask for --all")
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            v = {"true": True, "false": False}.get(v.lower(), v)
        overrides[k] = v

    archs = [args.arch] if args.arch else list(ARCHS)
    ok = err = skipped = 0
    for arch in archs:
        cfg = get_config(arch)
        shape_names = ([args.shape] if args.shape
                       else [s.name for s in cfg.shapes()]
                       + [n for n, _ in cfg.skipped_shapes()])
        for shape_name in shape_names:
            pods = {"pod256": [False], "pod512": [True],
                    "both": [False, True]}[args.mesh]
            for mp in pods:
                rec = run_cell(arch, shape_name, mp,
                               sharding_mode=args.sharding,
                               out_dir=pathlib.Path(args.out),
                               overrides=overrides or None, tag=args.tag)
                st = rec["status"]
                ok += st == "ok"
                err += st == "error"
                skipped += st == "skipped"
                line = f"[{st:7s}] {rec['cell']}"
                if st == "ok":
                    r = rec["roofline"]
                    line += (f" trace={rec['compile_s']}s "
                             f"bottleneck={r['bottleneck']} "
                             f"frac={r['roofline_fraction']:.3f}")
                elif st == "error":
                    line += " " + rec["error"][:120]
                print(line, flush=True)
    print(f"dry-run: {ok} ok, {skipped} skipped, {err} errors")
    if err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
