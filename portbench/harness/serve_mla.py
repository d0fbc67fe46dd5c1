"""Serving cells of a DeepSeek-V2 model (latent attention over a latent
slot cache, a dense first layer, dropless experts): the port's
``ContinuousScheduler`` behind a closed loop of clients, as ``serve.py``
runs a dense decoder, with this model's weights and reference.

Set-up makes the weights from the seed (``weights_mla.py``), builds the
engine (which replays its prefill chunks and decode steps as CUDA graphs
where the configuration's ``run`` block asks for ``step_graphs``:
``repro_torch.serving.graphs``) and the scheduler (whose constructor
prewarms the plans through the plan store, by capture), lets every
client send its first request,
and runs the loop for ``warm_ticks`` ticks.  The window runs the same
loop for ``--seconds``.  A traced run also switches on the port's
routed-row sums (``models.moe.ROUTE_LOAD``) over the window and reads
them once after it, then profiles ``trace_ticks`` more ticks, and as
many again with the host's operators recorded.

``correct``: once the window has closed, the peak memory read and the
scheduler's caches freed, a sample of the requests finished in the
window (``serve.sample``) goes through ``reference/deepseek_v2.py``: one
full causal forward over each prompt and its served tokens.  The number
compared is the widest gap by which a served token's logit lies below
the reference's best logit at its position (``serve.gaps``).
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..reference import deepseek_v2 as R
from . import devtrace
from . import traffic as T
from . import weights_mla as W
from .run_record import Run, log
from .serve import DONE, ClosedLoop, gaps, sample


def arch_config(cfg: dict):
    """The port's ``MLAConfig`` of a DeepSeek-V2 configuration file."""
    from repro_torch.configs.deepseek_v2_lite import MLAConfig
    run, rs = cfg["run"], cfg["rope_scaling"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    return MLAConfig(
        name=cfg["name"], family="moe", layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        kv_heads=cfg["num_key_value_heads"], head_dim=nope + rope,
        d_ff=cfg["moe_intermediate_size"], vocab=cfg["vocab_size"],
        n_experts=cfg["n_routed_experts"],
        top_k=cfg["num_experts_per_tok"],
        shared_experts=cfg["n_shared_experts"],
        rope_theta=float(cfg["rope_theta"]), norm=run["norm"],
        param_dtype=run["param_dtype"], compute_dtype=run["compute_dtype"],
        tie_embeddings=cfg["tie_word_embeddings"],
        fused_mlp=run["fused_mlp"], moe_dispatch=run["moe_dispatch"],
        kv_lora_rank=cfg["kv_lora_rank"], qk_nope_head_dim=nope,
        qk_rope_head_dim=rope, v_head_dim=cfg["v_head_dim"],
        rope_factor=float(rs["factor"]),
        rope_original_max=rs["original_max_position_embeddings"],
        rope_beta_fast=float(rs["beta_fast"]),
        rope_beta_slow=float(rs["beta_slow"]),
        rope_mscale=float(rs["mscale"]),
        rope_mscale_all_dim=float(rs["mscale_all_dim"]),
        first_dense_layers=cfg["first_k_dense_replace"],
        dense_d_ff=cfg["intermediate_size"],
        norm_topk_prob=cfg["norm_topk_prob"],
        routed_scale=float(cfg["routed_scaling_factor"]))


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, store_dir, control: bool = False) -> dict:
    from repro_torch.models import build_model
    from repro_torch.models.moe import ROUTE_LOAD
    from repro_torch.obs.tracing import Tracer, set_tracer
    from repro_torch.planner import PlanStore
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.sched import ContinuousScheduler, SchedConfig
    cfg, tr = cell.config, cell.traffic
    cuda = device != "cpu"
    t = time.perf_counter()
    params = W.make(cfg, seed, device)
    if cuda:
        torch.cuda.synchronize()
    log(f"set-up: torch and the port imported at "
        f"{t - t_start:.2f} s; weights {time.perf_counter() - t:.2f} s")
    engine = Engine(build_model(arch_config(cfg)), params,
                    ServeConfig(cache_len=tr["cache_len"],
                                step_graphs=cfg["run"]["step_graphs"]),
                    plan_store=PlanStore(str(store_dir)))
    loop = ClosedLoop(T.request_pool(tr, cfg["vocab_size"], seed),
                      tr["clients"])
    sc = tr["sched"]
    t = time.perf_counter()
    sched = ContinuousScheduler(
        engine, SchedConfig(slots=sc["slots"],
                            chunk_widths=tuple(sc["chunk_widths"]),
                            prefill_chunks_per_step=sc["prefill_chunks"],
                            prewarm_source=sc["prewarm_source"]),
        arch_id=cfg["run"]["arch_id"], on_token=loop.on_token,
        on_finish=loop.on_finish)
    prewarm_s = time.perf_counter() - t
    t = time.perf_counter()
    busy = []
    for _ in range(tr["warm_ticks"]):
        loop.tick(sched)
        busy.append(sched.slots.n_busy)
    if cuda:
        torch.cuda.synchronize()
    q = max(1, len(busy) // 6)
    sixths = [sum(busy[i:i + q]) / q for i in range(0, len(busy), q)]
    log(f"set-up: scheduler and prewarm {prewarm_s:.2f} s; warm-up "
        f"{time.perf_counter() - t:.2f} s over {len(busy)} ticks, busy "
        f"slots by sixths {sixths}")

    window_tracer = Tracer() if trace else None
    set_tracer(window_tracer)
    ROUTE_LOAD.reset()
    ROUTE_LOAD.on = trace
    t0 = time.perf_counter()
    t1 = t0 + seconds
    while time.perf_counter() < t1:
        loop.tick(sched)
    record = Run(cfg=cfg, traffic=tr, window=(t0, t1),
                 setup_s=t0 - t_start, prewarm_s=prewarm_s)
    ROUTE_LOAD.on = False
    record.route_load = ROUTE_LOAD.read() if trace else None
    log(f"window: {sched.metrics.steps} ticks so far, "
        f"{len(loop.tokens)} tokens so far")
    set_tracer(None)
    if trace:
        record.spans = window_tracer.spans
        stretch = Tracer()
        ticks = lambda: [loop.tick(sched) for _ in range(tr["trace_ticks"])]
        set_tracer(stretch)
        if cuda:
            record.profile = devtrace.profile(ticks)
        else:
            ticks()
        set_tracer(None)
        record.profile_spans = stretch.spans
        if cuda:
            record.host_profile = devtrace.profile(ticks, host=True)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    record.tokens, record.sends = loop.tokens, loop.sends
    record.prompt_len = {k: len(v) for k, v in loop.prompts.items()}

    # the requests finished in the window are judged
    in_win = [res for t, res in loop.finished if t0 <= t <= t1]
    failed = sum(res.finish_reason not in DONE for res in in_win)
    chk = tr["check"]
    picked = sample([r for r in in_win if r.finish_reason in DONE], seed,
                    chk["served_tokens"], chk["most_requests"])
    prompts = {r.req_id: loop.prompts[r.req_id] for r in picked}
    del sched, engine, loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out = {"run": record, "attempted": len(in_win), "failed": failed,
           "memory_peak_bytes": peak}
    out.update(judge(cell, params, picked, prompts, control))
    return out


def judge(cell, params: dict, picked: list, prompts: dict,
          control: bool) -> dict:
    """The reference over the sampled requests: the widest gap of a
    served token (and, with ``control``, of the fp8 control's best
    token) below the reference's best logit."""
    if not picked:
        return {"correct": False, "checks": {}, "note": "no request "
                "finished in the window"}
    R.exact()
    dev = params["embed"]["e"].device
    seqs, rows, served = [], [], []
    for r in picked:
        p = prompts[r.req_id]
        seq = np.concatenate([p, np.asarray(r.tokens[:-1], np.int32)])
        seqs.append(torch.as_tensor(seq, dtype=torch.int64, device=dev))
        rows.append(torch.arange(len(p) - 1, len(p) - 1 + r.n_generated,
                                 device=dev))
        served.append(r.tokens)
    spec = R.Spec.of(cell.config)
    t = time.perf_counter()
    ref, ctl = R.served_logits(params, spec, seqs, rows, control=control)
    log(f"reference: {len(seqs)} sequences of {[len(s) for s in seqs]} "
        f"tokens in {time.perf_counter() - t:.2f} s")
    gap = max(gaps(ref, served))
    limit = cell.limits["gap"]
    out = {"correct": gap <= limit,
           "checks": {"gap": {"value": gap, "limit": limit}},
           "compared": {"requests": len(picked),
                        "served_tokens": sum(len(s) for s in served)}}
    if control:
        best8 = [c.argmax(-1) for c in ctl]
        out["control"] = {"gap": max(gaps(ref, best8))}
    return out
