"""Serving entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --fused-mlp [--smoke] [--device cpu] [--continuous] \
        [--plan-db DIR --prewarm-source enumerated]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --scan-kernel [--smoke] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --scan-kernel --fused-mlp [--smoke] [--device cpu]

Two modes:
  * static (default): one batch of identical-arrival prompts through
    ``Engine.generate``, run to completion.
  * ``--continuous``: the continuous-batching scheduler
    (``repro_torch.serving.sched``) replaying a synthetic Poisson trace —
    chunked prefill interleaved with in-flight decode, slot recycling,
    per-request streaming.  Dense archs only.

Runs on the CUDA card unless ``--device cpu`` is given; without a card
and without that flag it exits with an error instead of falling back.
Weights are random, made on the device from a seeded torch.Generator.

``--plan-db DIR`` (or ``$GOMA_PLAN_DB``) plans every kernel tiling of the
deployment through a GOMA plan store before the first request: static
serving prewarms through ``Engine.prewarm_plans``, ``--continuous``
hands the store to the scheduler's bucketed prewarm.  The port prewarms
from the hand extraction tables only (``--prewarm-source enumerated``);
the reference's default, program capture, is not ported yet (ROADMAP
A10) and is refused.  A second run on the same store prints ``puts: 0``
and makes no solver call.  The replica router, the prefix cache,
speculative decoding and fault injection from the command line come with
later slices of the port.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..core.solver import reset_solver_stats, solver_stats
from ..models import build_model
from ..obs.registry import get_registry
from ..serving import Engine, ServeConfig


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--fused-mlp", action="store_true",
                    help="route gated-MLP blocks through the GOMA-chain-"
                         "planned fused kernel (the B1 composition where "
                         "the chain does not fuse)")
    ap.add_argument("--scan-kernel", action="store_true",
                    help="run the prefill's RWKV-6 / Mamba2 chunked scans "
                         "through their kernels (B3, B4): the config's "
                         "use_pallas_scan knob")
    ap.add_argument("--plan-db", default=None,
                    help="GOMA plan database dir: prewarm kernel tilings "
                         "through the store (also: $GOMA_PLAN_DB)")
    ap.add_argument("--prewarm-source", default="capture",
                    choices=("capture", "enumerated"),
                    help="plan prewarm shape source: 'enumerated' uses "
                         "the hand extraction tables; 'capture' (traced "
                         "programs) is not ported yet (ROADMAP A10)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching scheduler over a Poisson "
                         "trace instead of one static batch")
    ap.add_argument("--requests", type=int, default=16,
                    help="--continuous: synthetic trace length")
    ap.add_argument("--arrival-rate", type=float, default=8.0,
                    help="--continuous: Poisson arrivals per second")
    ap.add_argument("--chunk-widths", default="8,32",
                    help="--continuous: comma-separated prefill chunk "
                         "widths")
    ap.add_argument("--min-prompt-len", type=int, default=None,
                    help="--continuous: shortest trace prompt (default "
                         "a quarter of --prompt-len); prompts are "
                         "uniform up to --prompt-len")
    ap.add_argument("--metrics-jsonl", default=None, metavar="PATH",
                    help="--continuous: stream one JSON line per "
                         "scheduler tick (registry counter snapshot + "
                         "live metrics) to PATH")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="--continuous: admission-queue bound; overflow "
                         "is shed with a terminal REJECTED result")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="--continuous: per-request deadline relative "
                         "to arrival; requests still queued past it are "
                         "EXPIRED instead of served late")
    ap.add_argument("--watchdog-tick-s", type=float, default=None,
                    help="--continuous: wall-clock budget per scheduler "
                         "tick; slower ticks count sched.watchdog_trips")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is available; pass --device cpu to serve "
                 "on the CPU")

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.fused_mlp:
        cfg = dataclasses.replace(cfg, fused_mlp=True)
    if args.scan_kernel:
        cfg = dataclasses.replace(cfg, use_pallas_scan=True)
    model = build_model(cfg)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(0), device)
    store = None
    if args.plan_db:
        from ..planner import PlanStore
        store = PlanStore(args.plan_db)
    reset_solver_stats()
    if args.continuous:
        _serve_continuous(args, cfg, model, params, device, store)
        return
    eng = Engine(model, params, ServeConfig(
        max_new_tokens=args.new_tokens, temperature=args.temperature,
        cache_len=args.prompt_len + args.new_tokens + 8), plan_store=store)
    if store is not None:
        t0 = time.perf_counter()
        n = eng.prewarm_plans(args.arch, args.batch, args.prompt_len,
                              source=args.prewarm_source)
        print(f"plan prewarm: {n} GEMM tilings in "
              f"{time.perf_counter() - t0:.2f}s  store={store.stats()}")

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab,
                           (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    out = eng.generate(prompts,
                       rng=torch.Generator(device=device).manual_seed(1)
                       if args.temperature > 0 else None)
    dt = time.perf_counter() - t0
    tok_s = args.batch * args.new_tokens / dt
    print(f"{cfg.name} on {device}: generated {out.shape} in {dt:.2f}s "
          f"({tok_s:.1f} tok/s)")
    print(out[:, :12])
    _print_planning(store)


def _print_planning(store) -> None:
    """The store's counters and the process's solver calls, after
    serving."""
    if store is not None:
        print(f"plan store: {store.stats()}")
    print(f"solver calls: {solver_stats()['calls']}")


def _serve_continuous(args, cfg, model, params, device, store) -> None:
    from ..serving.sched import (BucketSpec, ContinuousScheduler,
                                 SchedConfig, TraceClock, TrafficConfig,
                                 poisson_trace, replay)
    widths = tuple(int(w) for w in args.chunk_widths.split(","))
    lo = args.min_prompt_len or max(args.prompt_len // 4, 1)
    # every trace prompt is <= prompt_len; its bucket-padded prefill
    # fits in ceil(prompt_len / max_width) full-width chunks
    wmax = BucketSpec(widths).max_width
    padded_cap = -(-args.prompt_len // wmax) * wmax
    eng = Engine(model, params, ServeConfig(
        max_new_tokens=args.new_tokens, temperature=args.temperature,
        cache_len=padded_cap + args.new_tokens), plan_store=store)
    trace = poisson_trace(TrafficConfig(
        n_requests=args.requests, arrival_rate=args.arrival_rate,
        prompt_mix=((lo, args.prompt_len, 1.0),),
        max_new_tokens=args.new_tokens, vocab=cfg.vocab))
    clock = TraceClock()
    with contextlib.ExitStack() as stack:
        on_tick = None
        if args.metrics_jsonl:
            metrics_fh = stack.enter_context(open(args.metrics_jsonl, "w"))
            reg = get_registry()

            def on_tick(s) -> None:
                line = {"tick": s.metrics.steps, "t": clock.now(),
                        "busy_slots": s.slots.n_busy,
                        "queued": len(s.queue),
                        "counters": reg.snapshot()}
                metrics_fh.write(json.dumps(line, sort_keys=True) + "\n")

        t0 = time.perf_counter()
        sched = ContinuousScheduler(
            eng, SchedConfig(slots=args.batch, chunk_widths=widths,
                             temperature=args.temperature,
                             prewarm_source=args.prewarm_source,
                             max_queue=args.max_queue,
                             shed_on_full=args.max_queue is not None,
                             default_deadline_s=args.deadline_s,
                             watchdog_tick_s=args.watchdog_tick_s),
            arch_id=args.arch if store is not None else None,
            clock=clock.now, on_tick=on_tick)
        if store is not None:
            print(f"plan prewarm: {sched.prewarmed_plans} GEMM tilings, "
                  f"{sched.prewarmed_chains} fused chains in "
                  f"{time.perf_counter() - t0:.2f}s  store={store.stats()}")
        results = replay(sched, trace, clock)
    if args.metrics_jsonl:
        print(f"metrics stream: {args.metrics_jsonl}")
    summ = sched.metrics.summary()
    print(f"{cfg.name} continuous on {device}: {len(results)} requests, "
          f"{summ['total_generated_tokens']} tokens in "
          f"{summ['elapsed_s']:.2f}s trace-time "
          f"({summ['tokens_per_s']:.1f} tok/s)")
    print(f"  ttft p50/p95: {summ['ttft_p50_s']:.3f}/"
          f"{summ['ttft_p95_s']:.3f}s  tpot p50: {summ['tpot_p50_s']:.3f}s  "
          f"occupancy: {summ['mean_slot_occupancy']:.2f}  "
          f"chunks: {summ['prefill_chunks']}  ticks: {summ['steps']}")
    if summ["rejected"] or summ["expired"] or summ["errored"]:
        print(f"  degraded: rejected={summ['rejected']} "
              f"expired={summ['expired']} errored={summ['errored']} "
              f"(served {summ['served']}/{summ['requests']})")
    _print_planning(store)


if __name__ == "__main__":
    main()
