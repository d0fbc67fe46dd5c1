"""Serving metrics: TTFT, per-token latency, throughput, occupancy.

All timestamps come from the scheduler's injected clock (wall time in
live serving, the virtual trace clock in replay), so the same metrics
layer serves both the benchmark harness and production-style telemetry.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .requests import RequestResult


def _pct(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs \
        else float("nan")


@dataclasses.dataclass
class ServingMetrics:
    """Accumulated over one scheduler run."""

    results: list[RequestResult] = dataclasses.field(default_factory=list)
    steps: int = 0                  # scheduler ticks
    decode_steps: int = 0           # ticks that ran a decode batch
    prefill_chunks: int = 0
    padded_prefill_tokens: int = 0  # wasted positions from bucket padding
    padded_decode_rows: int = 0     # inactive rows ridden through decode
    #                                 batches (slot-pool padding waste,
    #                                 the decode-side analogue of
    #                                 padded_prefill_tokens)
    # per-tick slot occupancy samples (active slots / total slots)
    occupancy_samples: list[float] = dataclasses.field(default_factory=list)
    # decode-tick batch efficiency (active rows / slot count)
    started_s: float = 0.0
    finished_s: float = 0.0
    # latency SLOs (None = not gated): a served request *attains* its
    # SLO when its TTFT (and, for requests that decoded past the first
    # token, its per-token latency) is within these bounds.  Goodput
    # counts only the tokens of SLO-attaining requests — the number a
    # latency-gated deployment actually gets paid for.
    ttft_slo_s: float | None = None
    tpot_slo_s: float | None = None

    def record_result(self, res: RequestResult) -> None:
        self.results.append(res)

    def record_tick(self, *, active: int, slots: int, decoded: bool,
                    chunks: int, padded_tokens: int,
                    padded_rows: int = 0) -> None:
        self.steps += 1
        self.decode_steps += decoded
        self.prefill_chunks += chunks
        self.padded_prefill_tokens += padded_tokens
        self.padded_decode_rows += padded_rows
        self.occupancy_samples.append(active / slots if slots else 0.0)

    # ------------------------------------------------------------- summary
    @property
    def total_generated(self) -> int:
        return sum(r.n_generated for r in self.results)

    @property
    def elapsed_s(self) -> float:
        return max(self.finished_s - self.started_s, 1e-9)

    @property
    def tokens_per_s(self) -> float:
        return self.total_generated / self.elapsed_s

    @classmethod
    def merged(cls, parts: "list[ServingMetrics]", *,
               elapsed_s: float | None = None,
               ttft_slo_s: float | None = None,
               tpot_slo_s: float | None = None) -> "ServingMetrics":
        """Fleet-level aggregate of per-replica metrics (the router's
        view): results and tick counters are summed; elapsed defaults to
        the slowest part (replicas run in parallel, so fleet elapsed is
        the makespan, not the sum)."""
        out = cls(ttft_slo_s=ttft_slo_s, tpot_slo_s=tpot_slo_s)
        for m in parts:
            out.results.extend(m.results)
            out.steps += m.steps
            out.decode_steps += m.decode_steps
            out.prefill_chunks += m.prefill_chunks
            out.padded_prefill_tokens += m.padded_prefill_tokens
            out.padded_decode_rows += m.padded_decode_rows
            out.occupancy_samples.extend(m.occupancy_samples)
        out.started_s = 0.0
        out.finished_s = elapsed_s if elapsed_s is not None else \
            max((m.elapsed_s for m in parts), default=0.0)
        return out

    def _attains_slo(self, r: RequestResult) -> bool:
        """Does one *served* request meet the configured latency SLOs?
        (Callers filter to served requests; a missing SLO bound always
        passes.)"""
        if self.ttft_slo_s is not None and \
                not r.ttft_s <= self.ttft_slo_s:      # NaN fails closed
            return False
        if self.tpot_slo_s is not None and r.n_generated > 1:
            tpot = (r.finish_s - r.first_token_s) / (r.n_generated - 1)
            if not tpot <= self.tpot_slo_s:
                return False
        return True

    def summary(self) -> dict:
        # shed requests (rejected/expired, and errored before their
        # first token) carry NaN first_token_s — latency percentiles are
        # computed over served requests only, or they'd all go NaN
        ttft = [r.ttft_s for r in self.results
                if r.n_generated > 0 and np.isfinite(r.first_token_s)]
        # per-token decode latency: generation span / tokens after the
        # first.  When *every* request generated <=1 token the sample
        # list is empty and percentiles would be NaN — report 0.0 so the
        # summary stays JSON-round-trippable and threshold-comparable.
        tpot = [(r.finish_s - r.first_token_s) / (r.n_generated - 1)
                for r in self.results
                if r.n_generated > 1 and np.isfinite(r.first_token_s)]
        tpot_p50 = _pct(tpot, 50) if tpot else 0.0
        tpot_p95 = _pct(tpot, 95) if tpot else 0.0
        by_reason: dict[str, int] = {}
        for r in self.results:
            by_reason[r.finish_reason] = by_reason.get(r.finish_reason,
                                                       0) + 1
        # SLO attainment / goodput over requests that actually started
        # (shed requests carry NaN first_token_s and are excluded from
        # the attainment denominator like they are from the percentiles;
        # they already count against `served`).  No samples -> 0.0, like
        # the tpot percentiles, so the summary stays NaN-free.
        started = [r for r in self.results
                   if r.n_generated > 0 and np.isfinite(r.first_token_s)]
        attained = [r for r in started if self._attains_slo(r)]
        slo = {}
        if self.ttft_slo_s is not None or self.tpot_slo_s is not None:
            slo = {
                "ttft_slo_s": self.ttft_slo_s,
                "tpot_slo_s": self.tpot_slo_s,
                "slo_attainment": round(
                    len(attained) / len(started) if started else 0.0, 4),
                "goodput_tokens_per_s": round(
                    sum(r.n_generated for r in attained)
                    / self.elapsed_s, 3),
            }
        return {
            "requests": len(self.results),
            "served": sum(1 for r in self.results if not r.shed),
            "rejected": by_reason.get("rejected", 0),
            "expired": by_reason.get("expired", 0),
            "errored": by_reason.get("errored", 0),
            "total_generated_tokens": self.total_generated,
            "elapsed_s": round(self.elapsed_s, 6),
            "tokens_per_s": round(self.tokens_per_s, 3),
            "ttft_p50_s": round(_pct(ttft, 50), 6),
            "ttft_p95_s": round(_pct(ttft, 95), 6),
            "tpot_p50_s": round(tpot_p50, 6),
            "tpot_p95_s": round(tpot_p95, 6),
            "steps": self.steps,
            "decode_steps": self.decode_steps,
            "prefill_chunks": self.prefill_chunks,
            "padded_prefill_tokens": self.padded_prefill_tokens,
            "padded_decode_rows": self.padded_decode_rows,
            "mean_slot_occupancy": round(
                float(np.mean(self.occupancy_samples))
                if self.occupancy_samples else 0.0, 4),
            **slo,
        }
