"""Continuous-batching serving scheduler (see scheduler.py for design).

Public surface:

  * ``ContinuousScheduler`` / ``SchedConfig`` — the scheduler itself,
  * ``Request`` / ``RequestResult`` / ``RequestState`` — the request API,
  * ``BucketSpec`` — prefill-chunk bucket quantization,
  * ``SlotManager`` — slot/free-list bookkeeping,
  * ``ServingMetrics`` — TTFT / tokens-per-s / occupancy,
  * ``TrafficConfig`` / ``poisson_trace`` / ``replay`` /
    ``run_static_baseline`` / ``TraceClock`` — synthetic traffic and the
    virtual-time replay harness (benchmarks/bench_serving.py).
"""
from .buckets import BucketSpec, Chunk
from .metrics import ServingMetrics
from .requests import (TERMINAL_STATES, Request, RequestResult,
                       RequestState)
from .scheduler import (SUPPORTED_FAMILIES, ContinuousScheduler,
                        SchedConfig, ensure_supported_family)
from .slots import Slot, SlotManager
from .traffic import (TraceClock, TrafficConfig, poisson_trace, replay,
                      run_static_baseline, shared_prefix_trace)

__all__ = [
    "BucketSpec", "Chunk", "ContinuousScheduler", "Request",
    "RequestResult", "RequestState", "SUPPORTED_FAMILIES", "SchedConfig",
    "ServingMetrics", "Slot", "SlotManager", "TERMINAL_STATES",
    "TraceClock", "TrafficConfig", "ensure_supported_family",
    "poisson_trace", "replay", "run_static_baseline",
    "shared_prefix_trace",
]
