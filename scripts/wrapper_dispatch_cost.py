"""Host cost of routing a kernel wrapper through ``torch.library``.

    python3 scripts/wrapper_dispatch_cost.py [--device cuda] [--calls N]

The port's kernel wrappers (``kernels/goma_gemm.py`` and its siblings)
are plain Python functions with a fake-tensor branch, so that a traced
program sees each kernel as one opaque node (``capture.trace``).  The
idiomatic alternative is a ``torch.library.custom_op`` with a
``register_fake`` shape function.  This script times the host side of
both on one tensor: a plain function that checks the device and the fake
branch as the wrappers do, and the same body registered as a custom op,
called through ``torch.ops``.  The body allocates an empty tensor and
launches nothing, so the difference is the dispatch alone.  It prints
microseconds per call for each, and the difference times the B1 launches
of one full-width scheduler replay (6,528 to 6,912).
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch
from torch._subclasses.fake_tensor import FakeTensor


def body(a: torch.Tensor) -> torch.Tensor:
    return a.new_empty((64, 64))


def plain(a: torch.Tensor) -> torch.Tensor:
    if a.device.type != "cuda":
        if isinstance(a, FakeTensor):
            return a.new_empty((64, 64))
    return body(a)


@torch.library.custom_op("dispatch_probe::gemm", mutates_args=())
def probe(a: torch.Tensor) -> torch.Tensor:
    return body(a)


@probe.register_fake
def _(a):
    return a.new_empty((64, 64))


def per_call_us(fn, a, calls: int, rounds: int = 5) -> float:
    """Median over rounds of the mean host time of one call."""
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(a)
        out.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--calls", type=int, default=20000)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")
    a = torch.zeros((64, 64), device=args.device)
    op = torch.ops.dispatch_probe.gemm
    for fn in (plain, op):                      # warm both paths
        per_call_us(fn, a, 1000, rounds=1)
    plain_us = per_call_us(plain, a, args.calls)
    op_us = per_call_us(op, a, args.calls)
    print(json.dumps({
        "device": args.device, "torch": torch.__version__,
        "plain_wrapper_us": plain_us, "custom_op_us": op_us,
        "custom_op_extra_us": op_us - plain_us,
        "extra_ms_per_replay_6528_6912": [
            (op_us - plain_us) * n / 1e3 for n in (6528, 6912)]}))


if __name__ == "__main__":
    main()
