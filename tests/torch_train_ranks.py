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

    python tests/torch_train_ranks.py DIR WORLD sharded

runs instead each job of ``DIR/jobs.pt`` on a mesh of the ``WORLD``
ranks (``sharded_job``): a sharded model's gradients, sharded training,
checkpoints saved and restored across meshes, and ``shard_engine``'s
greedy tokens; ``run_worlds`` starts one such world per size at once.
A job with ``plant="summed_reduce_scatter"`` runs with a planted fault
(``planted``), so that the tests can read what their gates see of it.
"""
import contextlib
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


def _sharded_model(job: dict):
    """The job's config (its smoke config with ``overrides``) sharded on a
    mesh of the world's ranks (``job["mesh"]``, ``job["mode"]``): (cfg,
    mesh, model)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.dist.serve import shard_model
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(job["arch"], smoke=True),
                              **job.get("overrides", {}))
    data, model = job["mesh"]
    mesh = make_host_mesh(data=data, model=model)
    return cfg, mesh, shard_model(build_model(cfg), mesh,
                                  mode=job.get("mode", "tp"))


def job_batches(cfg, job: dict, rank: int, world: int) -> list:
    """The job's batches (``host_batch``'s stream at ``seq`` x ``batch``,
    the frontends' zero stub), a data rank's rows of each."""
    from repro_torch.data import DataConfig, RankRows, global_arrays
    dc = DataConfig(vocab=cfg.vocab, seq_len=job["seq"],
                    global_batch=job["batch"])
    out = []
    for i in range(job.get("steps", 1)):
        b = global_arrays(dc, i, RankRows("cpu", rank, world))
        if cfg.family in ("encdec", "vlm"):
            key = "frames" if cfg.family == "encdec" else "patches"
            b[key] = torch.zeros((job["batch"] // world, cfg.frontend_len,
                                  cfg.d_model))
        out.append(b)
    return out


def _whole_tree(layout, tree) -> dict:
    """path -> the whole leaf, for a tree of this rank's slices (every
    rank, in one order)."""
    from repro_torch.sharding.rules import flatten_with_paths
    return {p: layout.whole(p, t) for p, t in flatten_with_paths(tree)}


def sharded_job(rank: int, job: dict) -> dict:
    import dataclasses
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.model import tree_to
    from repro_torch.sharding.rules import flatten_with_paths
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import _grads_of, jit_train_step
    kind = job["kind"]
    ocfg = opt.AdamWConfig(lr=job.get("lr", 3e-3), warmup_steps=2,
                           total_steps=20)
    if kind == "replicas":
        # replicated data parallelism: every rank holds the whole tree
        from repro_torch.configs import get_config
        from repro_torch.models import build_model
        cfg = dataclasses.replace(get_config(job["arch"], smoke=True),
                                  **job.get("overrides", {}))
        model = build_model(cfg)
        params = model.init_params(torch.Generator().manual_seed(0), "cpu",
                                   masters=True)
        state = opt.init_state(params)
        step = jit_train_step(model, ocfg)
        world = torch.distributed.get_world_size()
        losses = []
        for b in job_batches(cfg, job, rank, world):
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
        return {"losses": losses, "whole": dict(flatten_with_paths(params))}
    if kind == "program":
        return program_run(job)
    if kind == "replica_grads":
        return replica_grads(rank, job, ocfg)
    if kind == "serve":
        from repro_torch.configs import get_config
        from repro_torch.dist.serve import shard_engine
        from repro_torch.models import build_model
        from repro_torch.serving import Engine, ServeConfig
        cfg = dataclasses.replace(get_config(job["arch"], smoke=True),
                                  **job.get("overrides", {}))
        eng = Engine(build_model(cfg), job["params"],
                     ServeConfig(max_new_tokens=job["new"],
                                 cache_len=job["cache"]))
        data, model = job["mesh"]
        shard_engine(eng, model_axis=model, data_axis=data, mode="fsdp")
        return {"tokens": eng.generate(job["prompts"],
                                       extra_batch=job.get("extra")),
                "gathers": eng.model.tp.comm.get("fsdp_gather",
                                                 {}).get("calls", 0)}
    cfg, mesh, model = _sharded_model(job)
    data_rank, data = mesh.coords["data"], mesh.shape["data"]
    dev = job.get("device", "cpu")
    # made on the CPU from the seed, so that every device holds the same
    params = tree_to(model.init_params(torch.Generator().manual_seed(0),
                                       "cpu", masters=True), dev)
    if kind == "gather":
        return gather_probe(model, params, rank, dev)
    step = jit_train_step(model, ocfg, mesh=mesh)
    layout = step.layout
    if kind == "grads":
        batch = tree_to(job_batches(cfg, job, data_rank, data)[0], dev)
        loss, grads = _grads_of(model, params, batch, microbatches=1,
                                remat=True)
        grads = layout.reduce_grads(grads)
        return {"loss": float(layout.mean_over_data(loss)),
                "grads": tree_to(dict(flatten_with_paths(grads)), "cpu"),
                "comm": dict(layout.comm)}
    state = opt.init_state(params)
    if kind == "restore":
        (params, state), step0 = CheckpointManager(
            job["dir"], layout=layout).restore((params, state))
        whole = _whole_tree(layout, params)
        return {"step": step0, "whole": whole,
                "local": dict(flatten_with_paths(params)),
                "placed": all(torch.equal(t, layout.place(p, whole[p]))
                              for p, t in flatten_with_paths(params)),
                "mu": _whole_tree(layout, state["mu"])}
    if kind == "restore_params":
        params, _ = CheckpointManager(job["dir"], layout=layout).restore(
            params)
        return {"whole": _whole_tree(layout, params)}
    # "train", and "save" (train, then a checkpoint on this mesh)
    losses = []
    for b in job_batches(cfg, job, data_rank, data):
        params, state, m = step(params, state, tree_to(b, dev))
        losses.append(float(m["loss"]))
    if kind == "save":
        CheckpointManager(job["dir"], async_save=True,
                          layout=layout).save(job["steps"], (params, state))
    return {"losses": losses,
            "whole": tree_to(_whole_tree(layout, params), "cpu"),
            "mu": tree_to(_whole_tree(layout, state["mu"]), "cpu"),
            "local": tree_to(dict(flatten_with_paths(params)), "cpu"),
            "coords": dict(mesh.coords), "comm": step.comm,
            "dims": {} if model.fsdp is None else model.fsdp.dims}


def program_run(job: dict) -> dict:
    """The dry-run's program of a cell (``launch.dryrun.cell_program``)
    run for real on this rank of the job's mesh, on zeros of its
    arguments' shapes and dtypes: the collectives it made by kind (calls
    and bytes) and its argument bytes."""
    import torch.utils._pytree as pytree
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.dryrun import cell_program
    cfg, mesh, model = _sharded_model(job)
    shape = ShapeSpec(job["shape"], job["seq"], job["batch"], job["shape"])
    fn, args, comm = cell_program(model, cfg, shape)
    real = pytree.tree_map(
        lambda t: torch.zeros(t.shape, dtype=t.dtype)
        if isinstance(t, torch.Tensor) else t, args)
    fn(*real)
    leaves = {id(t): t for t in pytree.tree_leaves(real)
              if isinstance(t, torch.Tensor)}
    return {"comm": {k: {"calls": v["calls"], "bytes": v["bytes"]}
                     for k, v in comm().items() if v["calls"]},
            "argument_bytes": sum(t.numel() * t.element_size()
                                  for t in leaves.values())}


def replica_grads(rank: int, job: dict, ocfg) -> dict:
    """Replicated data parallelism through ``jit_train_step(group=)``, by
    the exact mean or (``job["compress"]``) the int8 error-feedback
    all-reduce: each step's loss, and the first step's local gradients
    (``_grads_of``, before the reduction) and reduced gradients (what
    the update takes)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import flatten_with_paths
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts
    cfg = dataclasses.replace(get_config(job["arch"], smoke=True),
                              **job.get("overrides", {}))
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu",
                               masters=True)
    state = opt.init_state(params)
    step = ts.jit_train_step(model, ocfg, group=torch.distributed.group.WORLD,
                             compress=job["compress"])
    seen = {}
    grads_of, apply = ts._grads_of, opt.apply_updates

    def snap(key, grads):
        if key not in seen:
            seen[key] = {p: g.detach().clone()
                         for p, g in flatten_with_paths(grads)}

    def local(*args, **kw):
        loss, grads = grads_of(*args, **kw)
        snap("local", grads)
        return loss, grads

    def reduced(params, grads, *args, **kw):
        snap("reduced", grads)
        return apply(params, grads, *args, **kw)
    ts._grads_of, opt.apply_updates = local, reduced
    try:
        losses = []
        world = torch.distributed.get_world_size()
        for b in job_batches(cfg, job, rank, world):
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
    finally:
        ts._grads_of, opt.apply_updates = grads_of, apply
    return {"losses": losses, **seen}


def gather_probe(model, params, rank: int, device) -> dict:
    """FSDP's gather of every layer of ``layers/mlp/wg/w`` and its
    backward: each rank weights layer i's whole tensor by probe (rank,
    i), normals from a seed; returns the gathered layers and this rank's
    gradient of its slice (the mean of the ranks' probes over its
    block)."""
    fsdp = model.fsdp
    leaf = params["layers"]["mlp"]["wg"]["w"].detach().requires_grad_()
    parts = fsdp.layer_parts("layers", {"mlp": {"wg": {"w": leaf}}})
    wholes, loss = [], 0
    for i, part in enumerate(parts):
        w = fsdp.gather_layer("layers", part, i)["mlp"]["wg"]["w"]
        probe = torch.randn(w.shape, generator=torch.Generator().manual_seed(
            100 * rank + i)).to(device)
        loss = loss + (w * probe).sum()
        wholes.append(w.detach().cpu())
    grad, = torch.autograd.grad(loss, leaf)
    return {"wholes": wholes, "grad": grad.cpu(),
            "dim": fsdp.dims["layers/mlp/wg/w"],
            "local": leaf.detach().cpu()}


@contextlib.contextmanager
def planted(fault: str | None):
    """Run with a planted fault: ``"summed_reduce_scatter"`` leaves out
    the FSDP gather's division by the data ranks, so that every leaf
    split over the data axis takes the sum of the ranks' gradients where
    the mean belongs; None plants nothing."""
    from repro_torch.dist.fsdp import FullyShardedData
    sound = FullyShardedData.reduce_scatter

    def summed(self, g, dim, owned, dtype):
        out = sound(self, g, dim, owned, dtype)
        return None if out is None else out * self.size
    if fault == "summed_reduce_scatter":
        FullyShardedData.reduce_scatter = summed
    elif fault is not None:
        raise ValueError(f"no planted fault {fault!r}")
    try:
        yield
    finally:
        FullyShardedData.reduce_scatter = sound


def sharded_jobs(rank: int, jobs: list) -> list:
    torch.set_num_threads(1)
    out = []
    for job in jobs:
        with planted(job.get("plant")):
            out.append(sharded_job(rank, job))
    return out


def run_worlds(roots: dict) -> dict:
    """This program's ``sharded`` mode on each world's ``DIR/jobs.pt`` at
    once (``roots``: world -> DIR; one subprocess a world); each world's
    results, rank by rank and job by job."""
    import subprocess
    procs = {world: subprocess.Popen(
        [sys.executable, __file__, str(root), str(world), "sharded"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for world, root in roots.items()}
    for proc in procs.values():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(log[-6000:])
    return {world: torch.load(pathlib.Path(root) / "results.pt",
                              weights_only=False)
            for world, root in roots.items()}


if __name__ == "__main__":
    from repro_torch.launch.mesh import run_ranks
    root, world = pathlib.Path(sys.argv[1]), int(sys.argv[2])
    if sys.argv[3:] == ["sharded"]:
        jobs = torch.load(root / "jobs.pt", weights_only=False)
        torch.save(run_ranks(sharded_jobs, world, jobs, timeout_s=300),
                   root / "results.pt")
    else:
        case = torch.load(root / "case.pt", weights_only=False)
        torch.save(run_ranks(train_rank, world, case, world),
                   root / "results.pt")
