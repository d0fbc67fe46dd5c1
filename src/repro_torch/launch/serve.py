"""Serving entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --fused-mlp [--smoke] [--device cpu] [--continuous] \
        [--plan-db DIR [--prewarm-source enumerated]]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --scan-kernel [--smoke] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --scan-kernel --fused-mlp [--smoke] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-moe-16b [--smoke] [--continuous] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \
        --fused-mlp [--smoke] [--continuous] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llava-next-34b [--fused-mlp] [--smoke] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-medium [--smoke] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --fused-mlp --continuous --replicas 2 --prefix-cache 64 \
        --draft-model ngram --spec-width 4 [--smoke] [--device cpu]

Two modes:
  * static (default): one batch of identical-arrival prompts through
    ``Engine.generate``, run to completion.
  * ``--continuous``: the continuous-batching scheduler
    (``repro_torch.serving.sched``) replaying a synthetic Poisson trace —
    chunked prefill interleaved with in-flight decode, slot recycling,
    per-request streaming.  Dense (gemma2 included) and MoE archs, as in
    the reference; ``--replicas N`` routes
    the trace through the replica router (``serving.router``), and
    ``--prefix-cache`` and ``--draft-model`` add the KV prefix cache and
    speculative decoding.  A recurrent arch behind ``--replicas`` takes
    the router's static fallback.

Runs on the CUDA card unless ``--device cpu`` is given; without a card
and without that flag it exits with an error instead of falling back.
Weights are random, made on the device from a seeded torch.Generator.
The frontends are stubs, as in the reference: the VLM (llava-next-34b)
gets zero patch embeddings in front of its prompts, the encoder-decoder
(seamless-m4t-medium) zero frame embeddings; the VLM's cache also holds
its patch positions.

``--plan-db DIR`` (or ``$GOMA_PLAN_DB``) plans every kernel tiling of the
deployment through a GOMA plan store before the first request: static
serving prewarms through ``Engine.prewarm_plans``, ``--continuous``
hands the store to the scheduler's bucketed prewarm.  The shapes come
from the model's own traced programs (``--prewarm-source capture``, the
default, as in the reference) or from the hand extraction tables
(``--prewarm-source enumerated``).  A second run on the same store
prints ``puts: 0`` and makes no solver call.  ``--inject`` and
``--chaos-seed`` install a deterministic fault schedule
(``faults.parse_faults``).
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
                    help="plan prewarm shape source: 'capture' (default) "
                         "reads the model's traced programs; 'enumerated' "
                         "uses the hand extraction tables")
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
    ap.add_argument("--replicas", type=int, default=1,
                    help="--continuous: scheduler replica count; > 1 "
                         "routes the trace through the replica router "
                         "(one shared prewarm pass, least-loaded "
                         "admission, virtual per-replica clocks)")
    ap.add_argument("--prefix-cache", type=int, default=None,
                    metavar="MB",
                    help="--continuous: enable the KV prefix cache with "
                         "this byte budget in MiB — shared-prefix "
                         "admissions graft cached KV rows instead of "
                         "re-prefilling them")
    ap.add_argument("--draft-model", default=None, metavar="DRAFTER",
                    help="--continuous: speculative decoding drafter: "
                         "'ngram' (prompt-lookup, zero model calls) or "
                         "an arch name served as a draft model through "
                         "its own engine.  Greedy only")
    ap.add_argument("--spec-width", type=int, default=4,
                    help="--draft-model: verify window width (1 "
                         "committed + spec-width-1 draft tokens)")
    ap.add_argument("--ttft-slo-s", type=float, default=None,
                    help="--continuous: TTFT SLO for the attainment/"
                         "goodput summary fields")
    ap.add_argument("--tpot-slo-s", type=float, default=None,
                    help="--continuous: per-token latency SLO for the "
                         "attainment/goodput summary fields")
    ap.add_argument("--inject", default=None, metavar="SPECS",
                    help="chaos fault schedule, e.g. "
                         "'store.corrupt:0.01,kernel.nan_row@3' "
                         "(see repro_torch.faults.parse_faults)")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed of the fault-injection RNG streams")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is available; pass --device cpu to serve "
                 "on the CPU")
    if args.inject:
        from ..faults import FaultInjector, parse_faults, set_injector
        set_injector(FaultInjector(parse_faults(args.inject),
                                   seed=args.chaos_seed))

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
    # the frontends' stand-ins, zeros as the reference's serve supplies
    # them; the VLM's patches take cache positions before the prompt
    extra, prefix = None, 0
    if cfg.family in ("vlm", "encdec"):
        key = "patches" if cfg.family == "vlm" else "frames"
        extra = {key: torch.zeros((args.batch, cfg.frontend_len,
                                   cfg.d_model), device=device)}
        prefix = cfg.frontend_len if cfg.family == "vlm" else 0
    eng = Engine(model, params, ServeConfig(
        max_new_tokens=args.new_tokens, temperature=args.temperature,
        cache_len=prefix + args.prompt_len + args.new_tokens + 8),
        plan_store=store)
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
    out = eng.generate(prompts, extra_batch=extra,
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
    # scale-out options (repro_torch.serving.router)
    prefix_cache = drafter = spec_width = None
    if args.prefix_cache is not None:
        from ..serving.router import PrefixCache
        prefix_cache = PrefixCache(wmax, max_bytes=args.prefix_cache << 20)
    if args.draft_model is not None:
        spec_width = args.spec_width
        if args.draft_model == "ngram":
            from ..serving.router import NgramDrafter
            drafter = NgramDrafter()
        else:
            from ..serving.router import ModelDrafter
            dcfg = get_config(args.draft_model, smoke=args.smoke)
            dmodel = build_model(dcfg)
            dparams = dmodel.init_params(
                torch.Generator(device=device).manual_seed(7), device)
            drafter = ModelDrafter(Engine(
                dmodel, dparams, ServeConfig(cache_len=eng.cfg.cache_len),
                plan_store=store))
    sched_cfg = SchedConfig(slots=args.batch, chunk_widths=widths,
                            temperature=args.temperature,
                            prewarm_source=args.prewarm_source,
                            max_queue=args.max_queue,
                            shed_on_full=args.max_queue is not None,
                            default_deadline_s=args.deadline_s,
                            watchdog_tick_s=args.watchdog_tick_s,
                            spec_width=spec_width)
    arch_id = args.arch if store is not None else None
    if args.replicas > 1:
        _serve_router(args, cfg, eng, sched_cfg, trace, arch_id,
                      prefix_cache, drafter, device, store)
        return
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
            eng, sched_cfg, arch_id=arch_id, clock=clock.now,
            on_tick=on_tick, prefix_cache=prefix_cache, drafter=drafter)
        sched.metrics.ttft_slo_s = args.ttft_slo_s
        sched.metrics.tpot_slo_s = args.tpot_slo_s
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
    _print_serving(summ)
    _print_planning(store)


def _print_serving(summ: dict) -> None:
    """The summary's SLO and degradation lines, and the scale-out
    counters, where the run has them."""
    if "slo_attainment" in summ:
        print(f"  slo attainment: {summ['slo_attainment']:.2%}  "
              f"goodput: {summ['goodput_tokens_per_s']:.1f} tok/s")
    if summ["rejected"] or summ["expired"] or summ["errored"]:
        print(f"  degraded: rejected={summ['rejected']} "
              f"expired={summ['expired']} errored={summ['errored']} "
              f"(served {summ['served']}/{summ['requests']})")
    snap = get_registry().snapshot()
    scale = {k: v for k, v in snap.items()
             if k.startswith(("prefix.", "sched.spec.", "router."))
             or k == "sched.prefix_tokens_reused"}
    if scale:
        print(f"  scale-out: {scale}")


def _serve_router(args, cfg, eng, sched_cfg, trace, arch_id, prefix_cache,
                  drafter, device, store) -> None:
    """--replicas N: the trace through the replica router."""
    from ..serving.router import ReplicaRouter, RouterConfig
    t0 = time.perf_counter()
    router = ReplicaRouter(
        eng, RouterConfig(replicas=args.replicas, sched=sched_cfg,
                          ttft_slo_s=args.ttft_slo_s,
                          tpot_slo_s=args.tpot_slo_s),
        arch_id=arch_id, prefix_cache=prefix_cache, drafter=drafter)
    if store is not None:
        print(f"plan prewarm (fleet, one pass): {router.prewarmed_plans} "
              f"GEMM tilings in {time.perf_counter() - t0:.2f}s  "
              f"store={store.stats()}")
    results = router.route_trace(trace)
    summ = router.summary()
    print(f"{cfg.name} router x{args.replicas} on {device}: "
          f"{len(results)} requests, {summ['total_generated_tokens']} "
          f"tokens in {summ['makespan_s']:.2f}s makespan "
          f"({summ['tokens_per_s']:.1f} tok/s), alive {summ['alive']}")
    if "static_fallback" in summ:
        print(f"  static fallback: {summ['static_fallback']}")
    else:
        print(f"  ttft p50/p95: {summ['ttft_p50_s']:.3f}/"
              f"{summ['ttft_p95_s']:.3f}s  tpot p50: "
              f"{summ['tpot_p50_s']:.3f}s")
    _print_serving(summ)
    _print_planning(store)


if __name__ == "__main__":
    main()
