"""The GOMA kernels' roofline share in a traced stretch.

The port opens a ``kernel.gemm`` span (attributes m, n, k) around every
B1 launch and a ``kernel.fused_mlp`` span (m, ff, k, n2) around every
MLP; an MLP whose chain does not fuse runs three B1 launches and one
``goma_combine`` over (m, ff) inside it.  The profiler's B1 and combine
kernels are matched to those spans in launch order; a stretch whose
counts differ reads nothing.
"""
from __future__ import annotations

from . import work

B1 = "goma_matmul"
COMBINE = "goma_combine"


def _phase(span, by_sid: dict, phase: str) -> bool:
    while span is not None:
        if span.name == phase:
            return True
        span = by_sid.get(span.parent)
    return False


def calls(spans: list, dtype: str) -> tuple[list, list, dict]:
    """(B1 calls, combine calls) of the spans, in launch order, each as
    (span, operations, bytes) in ``dtype``, and the spans by id."""
    by_sid = {s.sid: s for s in spans}
    unfused = {s.parent for s in spans if s.name == "kernel.gemm"}
    gemms, combines = [], []
    for s in spans:
        a = s.attrs
        if s.name == "kernel.gemm" and not a.get("force_plain"):
            gemms.append((s, *work.gemm_work(a["m"], a["n"], a["k"],
                                             dtype)))
        elif s.name == "kernel.fused_mlp" and s.sid in unfused:
            combines.append((s, *work.combine_work(a["m"], a["ff"],
                                                   dtype)))
    return gemms, combines, by_sid


def roofline_share(run, phase: str) -> float | None:
    """Σ least time over Σ device time, in percent, of the B1 and combine
    calls made inside spans named ``phase``."""
    if run.profile is None or not run.profile_spans:
        return None
    dtype = run.cfg["run"]["compute_dtype"]
    gemms, combines, by_sid = calls(run.profile_spans, dtype)
    least = device = 0.0
    for wanted, got in ((gemms, run.profile.named(B1)),
                        (combines, run.profile.named(COMBINE))):
        if len(wanted) != len(got):
            return None
        for (span, flops, nbytes), (_, _, dur_us) in zip(wanted, got):
            if _phase(span, by_sid, phase):
                least += work.least_time(flops, nbytes, dtype)
                device += dur_us / 1e6
    return 100.0 * least / device if device else None
