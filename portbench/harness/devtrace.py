"""The device trace of a traced run: ``torch.profiler`` over a stretch
of steady work after the window, reduced to what the metrics read.

``busy_s`` is the union of the kernels' intervals (kernels that overlap
count once), ``window_s`` the host's time from the profiler's start to
its stop after a synchronize.  The metrics' stretch records the device
alone: recording every host operator as well slows the host by a third
in the serving cells, and the idle share would grow with it.  A second
stretch with the host's operators recorded labels the idle gaps between
kernels by what the host was doing: the innermost CPU operator open at
the gap's middle.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time

KERNEL_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# a kernel's name as the breakdown gives it: templated names run long
NAME_CHARS = 160
# operators looked back over for the one open at a gap
SCAN = 256


class Profile:
    """kernels: [(name, start_us, dur_us)] in start order."""

    def __init__(self, kernels, cpu_ops, window_s: float):
        self.kernels = kernels
        self.cpu_ops = cpu_ops
        self.window_s = window_s
        self.busy_s, self.gaps = _busy_and_gaps(kernels)

    def named(self, part: str) -> list[tuple]:
        """The kernels whose name contains ``part``, in order."""
        return [k for k in self.kernels if part in k[0]]

    def device_ops(self, top: int = 10) -> list:
        tot = collections.Counter()
        for name, _, dur in self.kernels:
            tot[name[:NAME_CHARS]] += dur / 1e6
        return [[n, s] for n, s in tot.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle seconds summed by what the host was doing."""
        tot = collections.Counter()
        ops = sorted(self.cpu_ops, key=lambda o: o[1])
        starts = [o[1] for o in ops]
        for g0, g1 in self.gaps:
            mid = (g0 + g1) / 2
            label = "host: between operators"
            # the innermost open operator is the latest-starting one that
            # still runs at mid; look back over a bounded stretch
            i = bisect.bisect_right(starts, mid) - 1
            for name, t0, dur in reversed(ops[max(0, i - SCAN):i + 1]):
                if t0 + dur >= mid:
                    label = name
                    break
            tot[label] += (g1 - g0) / 1e6
        return [[n, s] for n, s in tot.most_common(top)]


def _busy_and_gaps(kernels):
    busy = 0.0
    gaps = []
    end = None
    for _, t0, dur in sorted(kernels, key=lambda k: k[1]):
        t1 = t0 + dur
        if end is None or t0 > end:
            if end is not None:
                gaps.append((end, t0))
            busy += dur
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    return busy / 1e6, gaps


def read_chrome(path: str, window_s: float) -> Profile:
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    kernels, cpu = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in KERNEL_CATS:
            kernels.append((e["name"], float(e["ts"]), float(e["dur"])))
        elif cat == "cpu_op":
            cpu.append((e["name"], float(e["ts"]), float(e["dur"])))
    kernels.sort(key=lambda k: k[1])
    return Profile(kernels, cpu, window_s)


def profile(fn, *, host: bool = False) -> Profile:
    """Run ``fn()`` under the profiler (the device, and with ``host`` the
    host's operators too) and reduce the trace.  The trace goes through a
    temporary file that is removed."""
    import torch
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                      else [])
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_chrome(path, window)
    finally:
        os.remove(path)
