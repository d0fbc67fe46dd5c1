"""``python -m repro_torch.plan`` — prebuild / inspect / verify plan
databases (the counterpart of the reference's ``python -m repro.plan``).
The store format is the reference's, so either CLI reads what the other
wrote.

    # cold build: solve every GEMM of a prefill sweep + decode scenario
    PYTHONPATH=src python -m repro_torch.plan build --model llama-3.2-1b \
        --hw eyeriss-like --seqs 1024,8192 --decode-batches 8 \
        --store /tmp/plans --manifest /tmp/llama1b.manifest.json

    # warm run: same command again -> 100% hit rate, 0 solves

    PYTHONPATH=src python -m repro_torch.plan inspect --store /tmp/plans
    PYTHONPATH=src python -m repro_torch.plan verify --store /tmp/plans

    # certified (energy, delay) Pareto frontiers
    PYTHONPATH=src python -m repro_torch.plan pareto build \
        --hw eyeriss-like --shapes 64x96x128,256x256x512 \
        --spatial-mode le --store /tmp/plans

Serving deployments prewarm their own H100 plans into a store through
``serving.Engine`` and ``launch/serve --plan-db``; ``--hw`` here keeps the
reference's template choices.

Not ported yet: ``capture``, ``trace`` and ``build --chains`` (program
capture, ROADMAP A10), ``fidelity`` and ``calibrate`` (ROADMAP A9).  They
raise NotImplementedError naming their item.
"""
from __future__ import annotations

import argparse
import sys

from ..core.certificate import verify as verify_certificate
from ..core.fusion import verify_chain
from ..core.pareto import select_frontier_point, verify_pareto
from ..dist.mesh_solve import verify_sharded
from ..core.hardware import TEMPLATES
from ..core.workloads import (CENTER_MODELS, EDGE_MODELS,
                              arch_decode_gemms, arch_gemms)
from .batch import BatchPlanner
from .manifest import ModelMappingManifest
from .store import PLAN_DB_ENV, PlanStore

MODELS = {m.name: m for m in EDGE_MODELS + CENTER_MODELS}


def _ints(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x.strip()]


def _add_store_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--store", default=None,
                    help=f"plan DB root (default: ${PLAN_DB_ENV})")


def _open_store(args) -> PlanStore:
    import os
    root = args.store or os.environ.get(PLAN_DB_ENV, "").strip()
    if not root:
        sys.exit(f"error: pass --store or set ${PLAN_DB_ENV}")
    return PlanStore(root)


def cmd_build(args) -> int:
    if args.chains:
        raise NotImplementedError(
            "plan build --chains is not ported yet: ROADMAP A10 (its "
            "chain rows come from the PlanProgram of program capture)")
    store = _open_store(args)
    hw = TEMPLATES[args.hw]
    planner = BatchPlanner(store, jobs=args.jobs,
                           warm_start=not args.no_warm_start)
    seqs = _ints(args.seqs)
    decode = _ints(args.decode_batches) if args.decode_batches else []
    if args.model:
        spec = MODELS[args.model]
        manifest = planner.plan_model(
            spec, hw, prefill_seqs=seqs, decode_batches=decode,
            cache_len=args.cache_len, objective=args.objective)
    else:
        gemms = []
        for seq in seqs:
            gemms.extend(arch_gemms(args.arch, seq=seq))
        for b in decode:
            gemms.extend(arch_decode_gemms(args.arch, batch=b,
                                           cache_len=args.cache_len))
        entries = planner.plan_gemms(gemms, hw, objective=args.objective)
        from ..core.solver import SOLVER_VERSION
        manifest = ModelMappingManifest(
            model=args.arch, hw_name=hw.name, objective=args.objective,
            prefill_seqs=tuple(seqs), decode_batches=tuple(decode),
            cache_len=args.cache_len, entries=entries,
            solver_version=SOLVER_VERSION)
    rep = planner.last_report
    print(manifest.summary())
    print(f"[batch] gemms={rep.total_gemms} unique={rep.unique_gemms} "
          f"hits={rep.hits} solved={rep.solved} "
          f"warm_started={rep.warm_started} "
          f"wall={rep.wall_time_s:.2f}s solve_cpu={rep.solve_time_s:.2f}s")
    print(f"[store] {store.stats()}")
    if args.manifest:
        path = manifest.save(args.manifest)
        print(f"[manifest] written to {path}")
    return 0


def cmd_capture(args) -> int:
    """Trace a program, lower it through the plan pass, report."""
    raise NotImplementedError(
        "plan capture is not ported yet: ROADMAP A10 (program capture)")


def cmd_inspect(args) -> int:
    store = _open_store(args)
    entries = list(store.entries())
    fused = list(store.fused_entries())
    sharded = list(store.sharded_entries())
    n_pareto = store.num_pareto()
    print(f"[store] {store.root}: {len(entries)} plans, "
          f"{len(fused)} fused chain plans, "
          f"{len(sharded)} sharded mesh plans, "
          f"{n_pareto} pareto frontiers")
    by_hw: dict[str, int] = {}
    for e in entries:
        by_hw[e.hw_name] = by_hw.get(e.hw_name, 0) + 1
    for hw_name, n in sorted(by_hw.items()):
        print(f"  {hw_name}: {n}")
    if args.verbose:
        for e in sorted(entries, key=lambda e: e.gemm_dims):
            c = e.certificate
            print(f"  {e.digest[:12]} {e.hw_name:16s} "
                  f"{str(e.gemm_dims):>24s} {e.objective_kind:6s} "
                  f"obj={c.objective:.6g} t={c.solve_time_s:.3f}s "
                  f"{'warm' if c.warm_started else 'cold'}")
        for e in sorted(fused, key=lambda e: e.producer_dims):
            c = e.certificate
            tag = f"fused(bm={c.bm})" if c.fused else "unfused"
            print(f"  {e.digest[:12]} {c.hw_name:16s} "
                  f"{e.producer_count}x{e.producer_dims}->"
                  f"{e.consumer_dims} [{e.elementwise}] {tag} "
                  f"obj={c.objective:.6g}pJ "
                  f"savings={100 * c.savings:.2f}%")
        for e in sorted(sharded, key=lambda e: e.gemm_dims):
            c = e.certificate
            mesh = (f"x{c.counts[0]}y{c.counts[1]}z{c.counts[2]}"
                    if c.counts else "infeasible")
            print(f"  {e.digest[:12]} {e.hw_name:16s} "
                  f"{str(e.gemm_dims):>24s} chips={e.n_chips} {mesh} "
                  f"[{c.collectives}] obj={c.objective:.6g}pJ/chip "
                  f"(chip {c.chip_pj:.4g} + ici {c.collective_pj:.4g}) "
                  f"saves={100 * c.savings:.2f}% "
                  f"specs={e.partition_specs}")
    return 0


def cmd_verify(args) -> int:
    store = _open_store(args)
    bad = total = 0
    for e in store.entries():
        total += 1
        if not verify_certificate(e.certificate, e.hw):
            bad += 1
            print(f"FAIL {e.digest[:12]} {e.hw_name} {e.gemm_dims}")
    fused_bad = fused_total = 0
    for e in store.fused_entries():
        fused_total += 1
        if not verify_chain(e.certificate, e.hw, e.producer_mapping,
                            e.consumer_mapping):
            fused_bad += 1
            print(f"FAIL fused {e.digest[:12]} {e.hw.name} "
                  f"{e.producer_dims}->{e.consumer_dims}")
    sharded_bad = sharded_total = 0
    for e in store.sharded_entries():
        sharded_total += 1
        if not verify_sharded(e.certificate, e.hw, e.mapping):
            sharded_bad += 1
            print(f"FAIL sharded {e.digest[:12]} {e.hw.name} "
                  f"{e.gemm_dims} chips={e.n_chips}")
    pareto_bad = pareto_total = 0
    for e in store.pareto_entries():
        pareto_total += 1
        if not verify_pareto(e.certificate, e.hw):
            pareto_bad += 1
            print(f"FAIL pareto {e.digest[:12]} {e.hw.name} "
                  f"{e.gemm_dims}")
    print(f"[verify] {total - bad}/{total} certificates verified"
          + (f", {bad} FAILED" if bad else ""))
    print(f"[verify] {fused_total - fused_bad}/{fused_total} chain "
          f"certificates verified"
          + (f", {fused_bad} FAILED" if fused_bad else ""))
    print(f"[verify] {sharded_total - sharded_bad}/{sharded_total} "
          f"sharded joint certificates verified"
          + (f", {sharded_bad} FAILED" if sharded_bad else ""))
    print(f"[verify] {pareto_total - pareto_bad}/{pareto_total} "
          f"pareto frontiers verified"
          + (f", {pareto_bad} FAILED" if pareto_bad else ""))
    return 1 if bad or fused_bad or sharded_bad or pareto_bad else 0


def cmd_fsck(args) -> int:
    """Integrity scan: parse + checksum + digest check on every object."""
    import json
    store = _open_store(args)
    report = store.fsck()
    print(f"[fsck] {store.root}: checked={report['checked']} "
          f"ok={report['ok']} legacy={report['legacy']} "
          f"corrupt={len(report['corrupt'])} "
          f"quarantined={report['quarantined']}")
    for item in report["corrupt"]:
        print(f"  CORRUPT {item['path']}: {item['reason']}")
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    return 1 if report["corrupt"] else 0


def cmd_repair(args) -> int:
    """Quarantine corrupt objects, checksum legacy entries."""
    store = _open_store(args)
    report = store.repair()
    print(f"[repair] {store.root}: checked={report['checked']} "
          f"quarantined_now={len(report['corrupt'])} "
          f"rewritten={report['rewritten']} "
          f"quarantined_total={report['quarantined']}")
    for item in report["corrupt"]:
        print(f"  QUARANTINED {item['path']}: {item['reason']}")
    after = store.fsck()
    print(f"[repair] post-check: ok={after['ok']}/{after['checked']} "
          f"corrupt={len(after['corrupt'])}")
    return 1 if after["corrupt"] else 0


def cmd_upgrade(args) -> int:
    """Re-solve bounded (anytime) entries to zero-gap certificates."""
    from .batch import upgrade_bounded
    store = _open_store(args)
    bounded = sum(1 for e in store.entries() if e.certificate.bounded)
    n = upgrade_bounded(store)
    print(f"[upgrade] {store.root}: {bounded} bounded entries, "
          f"{n} upgraded to zero-gap")
    return 0


def cmd_stats(args) -> int:
    """Observability snapshot: process registry + store + fidelity."""
    import json
    import os

    from ..obs.registry import get_registry

    snap = get_registry().snapshot(args.prefix or "")
    print(f"[registry] {len(snap)} metrics"
          + (f" under {args.prefix!r}" if args.prefix else ""))
    for name, value in snap.items():
        print(f"  {name} = {value}")
    root = args.store or os.environ.get(PLAN_DB_ENV, "").strip()
    if root:
        store = PlanStore(root)
        print(f"[store] {json.dumps(store.stats())}")
        fid_dir = store.root / "fidelity"
        if fid_dir.is_dir():
            # reading the rows waits for the fidelity port (ROADMAP A9)
            for path in sorted(fid_dir.glob("*.jsonl")):
                print(f"[fidelity] {path.name}: not read (ROADMAP A9)")
    return 0


def cmd_trace(args) -> int:
    """Run one traced capture->plan pass and summarize/export spans."""
    raise NotImplementedError(
        "plan trace is not ported yet: ROADMAP A10 (program capture)")


def cmd_fidelity(args) -> int:
    """Replay a manifest through the GEMM kernel; gate on rank corr."""
    raise NotImplementedError(
        "plan fidelity is not ported yet: ROADMAP A9 (fidelity replay)")


def _shapes(s: str) -> list[tuple[int, int, int]]:
    """Parse '64x96x128,256x256x512' into dim triples."""
    out = []
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        dims = tuple(int(x) for x in part.split("x"))
        if len(dims) != 3:
            raise ValueError(f"bad shape {part!r} (want MxNxK)")
        out.append(dims)
    return out


def cmd_pareto(args) -> int:
    """Certified (energy, delay) frontiers: build / inspect / verify."""
    from ..core.geometry import Gemm
    from .batch import cached_solve_pareto

    store = _open_store(args)
    if args.action == "build":
        hw = TEMPLATES[args.hw]
        shapes = _shapes(args.shapes) if args.shapes else []
        if args.model:
            from ..core.workloads import prefill_gemms
            for seq in _ints(args.seqs):
                for _, g, _ in prefill_gemms(MODELS[args.model], seq):
                    if g.dims not in shapes:
                        shapes.append(g.dims)
        if not shapes:
            sys.exit("error: pass --shapes and/or --model")
        for dims in shapes:
            res = cached_solve_pareto(
                Gemm(*dims), hw, spatial_mode=args.spatial_mode,
                max_points=args.max_points, store=store)
            pc = res.certificate
            pts = pc.points
            if not pts:
                print(f"  {str(dims):>22s}: INFEASIBLE")
                continue
            line = (f"  {str(dims):>22s}: {len(pts)} points "
                    f"E=[{pts[0].energy_pj:.4g}..{pts[-1].energy_pj:.4g}]pJ "
                    f"T=[{pts[-1].delay_ns:.4g}..{pts[0].delay_ns:.4g}]ns "
                    f"(solves={res.n_solves}, levels "
                    f"{pc.levels_swept}/{pc.levels_total})")
            if args.slo_ns is not None:
                p = select_frontier_point(pts, args.slo_ns)
                line += (f" slo->pe={p.num_pe_used} "
                         f"T={p.delay_ns:.4g}ns" if p else " slo->none")
            print(line)
        print(f"[store] {store.stats()}")
        return 0
    if args.action == "inspect":
        n = 0
        for e in store.pareto_entries():
            n += 1
            pc = e.certificate
            pts = pc.points
            rng = (f"E=[{pts[0].energy_pj:.4g}..{pts[-1].energy_pj:.4g}]pJ "
                   f"T=[{pts[-1].delay_ns:.4g}..{pts[0].delay_ns:.4g}]ns"
                   if pts else "infeasible")
            print(f"  {e.digest[:12]} {e.hw_name:16s} "
                  f"{str(e.gemm_dims):>22s} {pc.spatial_mode:8s} "
                  f"bw={e.bandwidth} {len(pts)} points {rng}")
        print(f"[pareto] {n} frontiers in {store.root}")
        return 0
    # verify
    bad = total = 0
    for e in store.pareto_entries():
        total += 1
        if not verify_pareto(e.certificate, e.hw):
            bad += 1
            print(f"FAIL pareto {e.digest[:12]} {e.hw.name} {e.gemm_dims}")
    print(f"[verify] {total - bad}/{total} pareto frontiers verified"
          + (f", {bad} FAILED" if bad else ""))
    return 1 if bad else 0


def cmd_calibrate(args) -> int:
    """Fit the latency model's bandwidth table against fidelity rows."""
    raise NotImplementedError(
        "plan calibrate is not ported yet: ROADMAP A9 (calibration)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.plan",
        description="GOMA mapping-plan database builder/inspector")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="populate a store from a scenario")
    grp = b.add_mutually_exclusive_group(required=True)
    grp.add_argument("--model", choices=sorted(MODELS),
                     help="paper LlmSpec model")
    grp.add_argument("--arch", help="repo architecture id (repro.configs)")
    b.add_argument("--hw", default="eyeriss-like", choices=sorted(TEMPLATES))
    b.add_argument("--seqs", default="1024",
                   help="comma-separated prefill sequence lengths")
    b.add_argument("--decode-batches", default="",
                   help="comma-separated decode batch sizes")
    b.add_argument("--cache-len", type=int, default=4096)
    b.add_argument("--objective", default="energy",
                   choices=("energy", "edp"))
    b.add_argument("--jobs", type=int, default=0,
                   help="parallel solver processes (0 = cpu count)")
    b.add_argument("--no-warm-start", action="store_true")
    b.add_argument("--chains", action="store_true",
                   help="also chain-solve the scenario's fused-MLP "
                        "chains into <store>/fused/ (not ported yet: "
                        "ROADMAP A10)")
    b.add_argument("--manifest", default=None,
                   help="write the ModelMappingManifest JSON here")
    _add_store_arg(b)
    b.set_defaults(fn=cmd_build)

    c = sub.add_parser(
        "capture", help="capture a program and plan it (not ported "
        "yet: ROADMAP A10)")
    grp = c.add_mutually_exclusive_group(required=True)
    grp.add_argument("--model", choices=sorted(MODELS),
                     help="paper LlmSpec (captures the reference program)")
    grp.add_argument("--arch", help="repo architecture id (captures the "
                                    "actual repro.models program)")
    c.add_argument("--phase", default="both",
                   choices=("prefill", "decode", "both"))
    c.add_argument("--seq", type=int, default=1024,
                   help="prefill sequence length")
    c.add_argument("--batch", type=int, default=1,
                   help="batch rows (decode batch / prefill batch)")
    c.add_argument("--cache-len", type=int, default=4096)
    c.add_argument("--smoke", action="store_true",
                   help="capture the reduced smoke config of --arch")
    c.add_argument("--hw", default="eyeriss-like", choices=sorted(TEMPLATES))
    c.add_argument("--objective", default="energy",
                   choices=("energy", "edp"))
    c.add_argument("--jobs", type=int, default=0)
    c.add_argument("--verbose", "-v", action="store_true")
    c.add_argument("--use-env-store", action="store_true",
                   help=f"use ${PLAN_DB_ENV} when --store is not given "
                        "(default: plan without persistence)")
    c.add_argument("--manifest", default=None)
    _add_store_arg(c)
    c.set_defaults(fn=cmd_capture)

    i = sub.add_parser("inspect", help="store stats / entry listing")
    i.add_argument("--verbose", "-v", action="store_true")
    _add_store_arg(i)
    i.set_defaults(fn=cmd_inspect)

    v = sub.add_parser("verify", help="re-verify every stored certificate"
                                      " (single-GEMM and fused chains)")
    _add_store_arg(v)
    v.set_defaults(fn=cmd_verify)

    s = sub.add_parser("stats", help="observability snapshot: registry "
                                     "counters, store traffic, fidelity "
                                     "reports")
    s.add_argument("--prefix", default="",
                   help="only registry metrics under this dotted prefix")
    _add_store_arg(s)
    s.set_defaults(fn=cmd_stats)

    t = sub.add_parser("trace", help="run one traced capture->plan pass "
                                     "and summarize / export its spans "
                                     "(not ported yet: ROADMAP A10)")
    t.add_argument("--model", required=True, choices=sorted(MODELS),
                   help="paper LlmSpec model (reference prefill program)")
    t.add_argument("--seq", type=int, default=256)
    t.add_argument("--hw", default="eyeriss-like", choices=sorted(TEMPLATES))
    t.add_argument("--out", default=None, help="span JSONL output path")
    _add_store_arg(t)
    t.set_defaults(fn=cmd_trace)

    f = sub.add_parser("fidelity", help="replay a manifest's plans "
                                        "through the GEMM kernel and gate "
                                        "on predicted-vs-measured rank "
                                        "correlation (not ported yet: "
                                        "ROADMAP A9)")
    f.add_argument("--manifest", required=True,
                   help="ModelMappingManifest JSON path")
    f.add_argument("--repeats", type=int, default=5)
    f.add_argument("--warmup", type=int, default=2)
    f.add_argument("--estimator", default="median",
                   choices=("median", "min"),
                   help="per-plan time estimator (min: stable for "
                        "tens-of-µs kernels under dispatch noise)")
    f.add_argument("--interpret", action="store_true",
                   help="force the Pallas interpreter path")
    f.add_argument("--max-entries", type=int, default=None)
    f.add_argument("--gate", type=float, default=0.9)
    f.add_argument("--name", default=None,
                   help="fidelity record name (default: manifest model)")
    f.add_argument("--out", default=None, help="full report JSON path")
    f.add_argument("--verbose", "-v", action="store_true")
    _add_store_arg(f)
    f.set_defaults(fn=cmd_fidelity)

    p = sub.add_parser("pareto", help="certified (energy, delay) "
                                      "frontiers: build a sweep into "
                                      "<store>/pareto/, list, or "
                                      "re-verify every point")
    p.add_argument("action", choices=("build", "inspect", "verify"))
    p.add_argument("--hw", default="eyeriss-like", choices=sorted(TEMPLATES))
    p.add_argument("--shapes", default="",
                   help="comma-separated MxNxK GEMM shapes")
    p.add_argument("--model", default=None, choices=sorted(MODELS),
                   help="also sweep this model's prefill GEMMs")
    p.add_argument("--seqs", default="1024",
                   help="prefill sequence lengths for --model")
    p.add_argument("--spatial-mode", default=None,
                   choices=("equality", "le"),
                   help="spatial mode for the sweep ('le' gives real "
                        "multi-point frontiers)")
    p.add_argument("--max-points", type=int, default=24,
                   help="epsilon-level thinning cap per frontier")
    p.add_argument("--slo-ns", type=float, default=None,
                   help="also report the frontier point a latency SLO "
                        "of this many ns would select")
    _add_store_arg(p)
    p.set_defaults(fn=cmd_pareto)

    cal = sub.add_parser("calibrate",
                         help="fit the latency model's bandwidth table "
                              "against recorded fidelity rows; exit 1 "
                              "when held-out error does not beat the "
                              "compute-only baseline (not ported "
                              "yet: ROADMAP A9)")
    cal.add_argument("--rows", default=None,
                     help="fidelity JSONL path (default: "
                          "<store>/fidelity/<name>.jsonl)")
    cal.add_argument("--name", default=None,
                     help="fidelity record name under the store")
    cal.add_argument("--holdout-every", type=int, default=3,
                     help="hold out every Nth row for the gate")
    cal.add_argument("--spec", default="tpuv5e-like",
                     help="spec name the calibration applies to")
    cal.add_argument("--save", action="store_true",
                     help="persist under <store>/calibration/")
    cal.add_argument("--calibration-name", default="calibration",
                     help="calibration file name (sans .json)")
    _add_store_arg(cal)
    cal.set_defaults(fn=cmd_calibrate)

    k = sub.add_parser("fsck", help="integrity-scan every store object "
                                    "(parse, checksum, digest); exit 1 "
                                    "if any is corrupt")
    k.add_argument("--json", action="store_true",
                   help="also dump the full report as JSON")
    _add_store_arg(k)
    k.set_defaults(fn=cmd_fsck)

    r = sub.add_parser("repair", help="quarantine corrupt objects and "
                                      "add checksums to legacy entries")
    _add_store_arg(r)
    r.set_defaults(fn=cmd_repair)

    u = sub.add_parser("upgrade", help="re-solve bounded (anytime) "
                                       "entries to zero-gap certificates")
    _add_store_arg(u)
    u.set_defaults(fn=cmd_upgrade)

    args = ap.parse_args(argv)
    return args.fn(args)
