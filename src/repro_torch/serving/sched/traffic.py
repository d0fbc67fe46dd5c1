"""Synthetic traffic: Poisson arrivals × prompt-length mixtures + replay.

The replay harness runs a trace against the scheduler in *virtual trace
time*: the clock jumps forward to the next arrival when the system is
idle and advances by the measured wall time of every scheduler tick, so
throughput/latency numbers reflect how the arrival process interacts
with real compute speed without busy-waiting through idle gaps.

``run_static_baseline`` replays the same trace through the static
``Engine.generate`` path (greedy batch formation from whatever has
arrived, run-to-completion, drain, repeat) — the comparison point for
bench_serving's continuous-vs-static tokens/s claim.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from ...faults import inject
from ..engine import Engine
from .requests import Request, RequestResult
from .scheduler import ContinuousScheduler


class TraceClock:
    """Virtual seconds since trace start.

    While *pinned*, ``now()`` additionally counts real elapsed time
    since the pin — so timestamps taken inside a scheduler tick (TTFT,
    finish) include the compute that produced them instead of being
    quantized to the tick's start."""

    def __init__(self):
        self._t = 0.0
        self._pin: float | None = None

    def now(self) -> float:
        if self._pin is not None:
            return self._t + (time.perf_counter() - self._pin)
        return self._t

    def advance(self, dt: float) -> None:
        self._t += max(dt, 0.0)

    def pin(self) -> None:
        self._pin = time.perf_counter()

    def release(self) -> None:
        """Fold the pinned real time into the virtual clock."""
        self.advance(time.perf_counter() - self._pin)
        self._pin = None

    def wait_until(self, t: float) -> None:
        self._t = max(self._t, t)


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Poisson arrivals at ``arrival_rate`` req/s (virtual), prompt
    lengths drawn from a weighted mixture of uniform ranges, per-request
    token budgets optionally uniform in ``max_new_range``."""

    n_requests: int = 32
    arrival_rate: float = 8.0
    # (lo, hi, weight): uniform prompt length in [lo, hi]
    prompt_mix: tuple[tuple[int, int, float], ...] = (
        (4, 15, 0.50), (16, 63, 0.35), (64, 160, 0.15))
    max_new_tokens: int = 32
    max_new_range: tuple[int, int] | None = None   # overrides the fixed cap
    vocab: int = 256
    stop_token: int | None = None
    seed: int = 0


def poisson_trace(cfg: TrafficConfig) -> list[Request]:
    """Materialize one reproducible trace from a TrafficConfig."""
    rng = np.random.default_rng(cfg.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / cfg.arrival_rate,
                                         cfg.n_requests))
    weights = np.asarray([w for _, _, w in cfg.prompt_mix], np.float64)
    weights = weights / weights.sum()
    reqs = []
    for i in range(cfg.n_requests):
        lo, hi, _ = cfg.prompt_mix[int(rng.choice(len(cfg.prompt_mix),
                                                  p=weights))]
        length = int(rng.integers(lo, hi + 1))
        tokens = rng.integers(0, cfg.vocab, (length,)).astype(np.int32)
        budget = cfg.max_new_tokens
        if cfg.max_new_range is not None:
            budget = int(rng.integers(cfg.max_new_range[0],
                                      cfg.max_new_range[1] + 1))
        reqs.append(Request(req_id=i, tokens=tokens,
                            max_new_tokens=budget,
                            arrival_s=float(arrivals[i]),
                            stop_token=cfg.stop_token))
    return reqs


def shared_prefix_trace(cfg: TrafficConfig, *, prefix_len: int,
                        n_prefixes: int = 1) -> list[Request]:
    """A Poisson trace whose prompts each start with one of
    ``n_prefixes`` common prefixes (system prompts / few-shot headers)
    followed by a per-request tail drawn from ``cfg.prompt_mix`` — the
    workload shape the KV prefix cache (serving.router.prefix) exists
    for.  Arrivals, tails and budgets come from ``poisson_trace(cfg)``
    unchanged; only the prompts grow by ``prefix_len``."""
    base = poisson_trace(cfg)
    rng = np.random.default_rng([cfg.seed, 7])
    prefixes = [rng.integers(0, cfg.vocab, (prefix_len,)).astype(np.int32)
                for _ in range(n_prefixes)]
    out = []
    for r in base:
        pre = prefixes[int(rng.integers(n_prefixes))]
        out.append(Request(
            req_id=r.req_id, tokens=np.concatenate([pre, r.tokens]),
            max_new_tokens=r.max_new_tokens, arrival_s=r.arrival_s,
            stop_token=r.stop_token, deadline_s=r.deadline_s))
    return out


def replay(scheduler: ContinuousScheduler, requests: list[Request],
           clock: TraceClock) -> list[RequestResult]:
    """Drive the scheduler through a trace in virtual time.  The
    scheduler must have been constructed with ``clock=clock.now``."""
    pending = collections.deque(sorted(requests,
                                       key=lambda r: r.arrival_s))
    while pending or scheduler.busy:
        # chaos: a traffic.burst hit collapses the next arrival gap to
        # zero — the request lands *now*, exercising admission control
        while pending and (pending[0].arrival_s <= clock.now() + 1e-12
                           or inject("traffic.burst") is not None):
            scheduler.submit(pending.popleft())
        if not scheduler.busy:
            clock.wait_until(pending[0].arrival_s)
            continue
        clock.pin()              # in-tick timestamps include compute
        try:
            scheduler.step()
        finally:
            clock.release()
    return scheduler.results


def run_static_baseline(engine: Engine, requests: list[Request],
                        clock: TraceClock, *, max_batch: int) -> dict:
    """Sequential static batches over the same trace: grab up to
    ``max_batch`` arrived requests, right-pad to the longest prompt, run
    ``Engine.generate`` to completion, drain, repeat.  Head-of-line
    blocking and the drain barrier are exactly what continuous batching
    removes.

    Delivered-token accounting matches the scheduler's: per row, tokens
    up to the request's own budget or its first stop token — the batch
    decodes to the *largest* budget in the group (a static deployment
    cannot retire rows early), so the overshoot is pure waste, exactly
    the cost continuous batching removes.  Ragged groups are
    right-padded, so baseline outputs are *not* oracle-faithful per row
    — this helper measures throughput, not correctness (the oracle
    comparison lives in the scheduler tests).  Mutates
    ``engine.cfg.max_new_tokens`` per group.
    """
    pending = collections.deque(sorted(requests,
                                       key=lambda r: r.arrival_s))
    stop = engine.cfg.stop_token
    orig_budget = engine.cfg.max_new_tokens
    total_tokens = 0
    n_batches = 0
    latencies = []
    try:
        while pending:
            if pending[0].arrival_s > clock.now():
                clock.wait_until(pending[0].arrival_s)
            group = []
            while pending and len(group) < max_batch and \
                    pending[0].arrival_s <= clock.now() + 1e-12:
                group.append(pending.popleft())
            width = max(r.prompt_len for r in group)
            batch = np.zeros((len(group), width), np.int32)
            for i, r in enumerate(group):
                batch[i, :r.prompt_len] = r.tokens
            engine.cfg.max_new_tokens = max(r.max_new_tokens
                                            for r in group)
            t0 = time.perf_counter()
            out = engine.generate(batch)
            clock.advance(time.perf_counter() - t0)
            n_batches += 1
            done = clock.now()
            for r, row in zip(group, out):
                lim = row[:r.max_new_tokens]
                if stop is not None and (lim == stop).any():
                    total_tokens += int(np.argmax(lim == stop)) + 1
                else:
                    total_tokens += int(lim.size)
                # no streaming: a static batch delivers at drain time
                latencies.append(done - r.arrival_s)
    finally:
        engine.cfg.max_new_tokens = orig_budget
    elapsed = max(clock.now(), 1e-9)
    return {"requests": len(requests), "batches": n_batches,
            "total_generated_tokens": total_tokens,
            "elapsed_s": round(elapsed, 6),
            "tokens_per_s": round(total_tokens / elapsed, 3),
            "delivery_p50_s": round(float(np.percentile(latencies, 50)), 6),
            "delivery_p95_s": round(float(np.percentile(latencies, 95)), 6)}
