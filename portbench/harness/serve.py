"""Serving cells: the port's ``ContinuousScheduler`` behind a closed loop
of clients, in real time on the host's clock.

Set-up makes the weights on the device from the seed, builds the engine
and the scheduler (whose constructor prewarms the plans through the plan
store), lets every client send its first request, and runs the loop for
the traffic file's ``warm_ticks`` ticks, until slot occupancy is steady.
The window then runs the same loop for ``--seconds``.  A client sends
its next request the moment its previous one finishes; each request is
timed from that moment.  After the window a traced run profiles
``trace_ticks`` more ticks of the same loop, and as many again with
the host's operators recorded.

``correct``: once the window has closed, the peak memory read and the
scheduler's caches freed, a sample of the requests finished in the
window, drawn from the seed with the longest among them, goes through
the plain reference: one full causal forward over each prompt and its
served tokens.  The number compared is the widest gap by which a served
token's logit lies below the reference's best logit at its position.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..reference import dense as R
from . import devtrace
from . import traffic as T
from . import weights as W
from .run_record import Run, arch_config, log

DONE = ("length", "stop")


class ClosedLoop:
    """Clients that each send their next request when the last one
    finishes, taking the pool's requests in order."""

    def __init__(self, pool: list, clients: int):
        self.pool = pool
        self.next = 0
        self.pending = []
        self.sends: dict[int, float] = {}
        self.prompts: dict[int, np.ndarray] = {}
        self.tokens: list[tuple[float, int]] = []
        self.finished: list[tuple[float, object]] = []
        for _ in range(clients):
            self.send(time.perf_counter())

    def send(self, now: float) -> None:
        from repro_torch.serving.sched import Request
        rid = self.next
        self.next += 1
        prompt, out = self.pool[rid % len(self.pool)]
        self.sends[rid] = now
        self.prompts[rid] = prompt
        self.pending.append(Request(req_id=rid, tokens=prompt,
                                    max_new_tokens=out))

    def on_token(self, req, tok) -> None:
        self.tokens.append((time.perf_counter(), req.req_id))

    def on_finish(self, res) -> None:
        now = time.perf_counter()
        self.finished.append((now, res))
        self.send(now)

    def tick(self, sched) -> None:
        for req in self.pending:
            sched.submit(req)
        self.pending.clear()
        sched.step()


def sample(done: list, seed: int, served: int, most: int) -> list:
    """The longest finished request, then others drawn from the seed,
    until ``served`` served tokens or ``most`` requests."""
    if not done:
        return []
    done = sorted(done, key=lambda r: r.req_id)
    longest = max(done, key=lambda r: (r.n_generated + r.prompt_len,
                                       -r.req_id))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([seed, 3]).permutation(len(rest))
    out = [longest]
    for i in order:
        if sum(r.n_generated for r in out) >= served or len(out) >= most:
            break
        out.append(rest[i])
    return out


def gaps(ref_rows: list, tokens: list) -> list[float]:
    """Per sequence, the widest gap between the reference's best logit
    and the logit of the token at each row."""
    out = []
    for r, toks in zip(ref_rows, tokens):
        t = torch.as_tensor(toks, device=r.device, dtype=torch.int64)
        g = r.max(-1).values - r.gather(-1, t[:, None])[:, 0]
        out.append(float(g.max()))
    return out


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, store_dir, control: bool = False) -> dict:
    from repro_torch.models import build_model
    from repro_torch.obs.tracing import Tracer, set_tracer
    from repro_torch.planner import PlanStore
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.sched import ContinuousScheduler, SchedConfig
    cfg, tr = cell.config, cell.traffic
    cuda = device != "cpu"
    t = time.perf_counter()
    params = W.make(cfg, seed, device, masters=False)
    if cuda:
        torch.cuda.synchronize()
    log(f"set-up: torch and the port imported at "
        f"{t - t_start:.2f} s; weights {time.perf_counter() - t:.2f} s")
    engine = Engine(build_model(arch_config(cfg)), params,
                    ServeConfig(cache_len=tr["cache_len"]),
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
    log(f"set-up: scheduler and prewarm {prewarm_s:.2f} s; warm-up "
        f"{time.perf_counter() - t:.2f} s over {len(busy)} ticks, busy "
        f"slots by sixths {[sum(busy[i:i + q]) / q for i in range(0, len(busy), q)]}")

    window_tracer = Tracer() if trace else None
    set_tracer(window_tracer)
    t0 = time.perf_counter()
    t1 = t0 + seconds
    while time.perf_counter() < t1:
        loop.tick(sched)
    record = Run(cfg=cfg, traffic=tr, window=(t0, t1),
                 setup_s=t0 - t_start, prewarm_s=prewarm_s)
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
