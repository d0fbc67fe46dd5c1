"""Where the time of the scan kernels (B3 ``wkv6.cu``, B4 ``mamba2_ssd.cu``)
goes, phase by phase, on one NVIDIA card.

    python3 scripts/scan_phase_clocks.py [--out FILE]

Copies ``src/repro_torch/kernels/csrc`` into ``build/phase_clocks/``
and stamps each scan kernel there with ``clock64()``: before every
numbered phase comment (``// 1. ...``, ``// 4a. ...``) at the
indentation of the kernel's first one, a ``__syncthreads()`` and a stamp
that charges the cycles since the last stamp to the phase that was
running; at the kernel's end the last one.  Thread 0 of every CTA adds
its phase cycles to a device counter, so each phase's share is its part
of all CTAs' cycles, barrier waits included.  The stamped sources are
built with the port's nvcc flags and run through the port's own wrappers
(``wkv6_scan``, ``ssd_scan``) at the full-width prefill shapes; each
kernel is also timed unstamped (CUDA events, and device time by kernel
name from ``torch.profiler``), since the stamps' barriers add time of
their own.

Prints one JSON object per kernel and, with ``--out``, writes them all
to FILE.  Needs a CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# the kernels to stamp, by source file (`ssd_kernel` is B4's name in
# sources that compute C Bm^T inside the scan kernel)
KERNELS = {"wkv6.cu": ("wkv6_kernel",),
           "mamba2_ssd.cu": ("ssd_kernel", "ssd_scan_kernel")}
PHASES = 16
MARK = re.compile(r"^(\s*)// (\d+[a-z]?)\.\s+(.*)$")
BUFFER = f"__device__ unsigned long long scan_pc_buf[{PHASES}];"
ACCESS = f"""
extern "C" int scan_pc_read(unsigned long long* dst) {{
  return (int)cudaMemcpyFromSymbol(dst, scan_pc_buf, sizeof(scan_pc_buf));
}}
extern "C" int scan_pc_reset() {{
  unsigned long long z[{PHASES}] = {{}};
  return (int)cudaMemcpyToSymbol(scan_pc_buf, z, sizeof(z));
}}
"""


def _stamp(i: int) -> str:
    return ("__syncthreads(); if (threadIdx.x == 0) { const long long _t = "
            "clock64(); _pc_acc[_pc_cur] += _t - _pc_t0; _pc_t0 = _t; } "
            f"_pc_cur = {i};")


def _body(lines: list[str], name: str) -> tuple[int, int] | None:
    """Line indices of the opening and closing brace of kernel ``name``'s
    body, or None if the source has no such kernel."""
    start = next((i for i, ln in enumerate(lines)
                  if re.match(rf"^{name}\(", ln.strip())), None)
    if start is None:
        return None
    depth, opened = 0, None
    for i in range(start, len(lines)):
        code = lines[i].split("//")[0]
        for ch in code:
            if ch == "{":
                depth += 1
                if opened is None:
                    opened = i
            elif ch == "}":
                depth -= 1
                if opened is not None and depth == 0:
                    return opened, i
    raise ValueError(f"unbalanced braces in {name}")


def instrument(src: str, names) -> tuple[str, dict]:
    """The source with every kernel in ``names`` stamped, and each
    stamped kernel's phase labels by index (0 is the set-up before the
    first numbered phase)."""
    lines = src.splitlines()
    labels = {}
    for name in names:
        span = _body(lines, name)
        if span is None:
            continue
        opened, closed = span
        marks = [(i, MARK.match(lines[i])) for i in range(opened, closed)
                 if MARK.match(lines[i])]
        indent = marks[0][1].group(1)
        marks = [(i, m) for i, m in marks if m.group(1) == indent]
        if len(marks) >= PHASES:
            raise ValueError(f"{name}: more than {PHASES - 1} phases")
        labels[name] = ["set-up"] + [f"{m.group(2)}. {m.group(3)}"
                                     for _, m in marks]
        lines[closed] = (
            "  " + _stamp(0).split(" _pc_cur")[0]
            + f" if (threadIdx.x == 0) for (int _i = 0; _i < {PHASES}; ++_i)"
            " atomicAdd(&scan_pc_buf[_i], (unsigned long long)_pc_acc[_i]);"
            "\n" + lines[closed])
        for k, (i, m) in reversed(list(enumerate(marks, start=1))):
            lines[i] = f"{m.group(1)}{_stamp(k)}\n{lines[i]}"
        lines[opened] += (f"\n  long long _pc_t0 = clock64(), "
                          f"_pc_acc[{PHASES}] = {{}}; int _pc_cur = 0;")
    last = max(i for i, ln in enumerate(lines) if ln.startswith("#include"))
    lines[last] += "\n" + BUFFER
    return "\n".join(lines) + "\n" + ACCESS, labels


def build_stamped(out: pathlib.Path) -> tuple[types.SimpleNamespace, dict]:
    """Build the stamped scan sources; a namespace of their launchers
    (argtypes as the port sets them) and the phase labels by kernel."""
    import ctypes

    from repro_torch.kernels import _build
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(_build.CSRC, out)
    labels, procs = {}, []
    for src, names in KERNELS.items():
        text, lab = instrument((out / src).read_text(), names)
        (out / src).write_text(text)
        labels.update(lab)
        procs.append((src, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / _build._lib_name(src)), str(out / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    ns = types.SimpleNamespace(libs={})
    for src, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on stamped {src}:\n{log}")
        lib = ctypes.CDLL(str(out / _build._lib_name(src)))
        ns.libs[src] = lib
        for name, argtypes in _build.SIGNATURES.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                setattr(ns, name, fn)
    return ns, labels


def events_ms(fn, reps: int = 10) -> float:
    fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms_by_kernel(fn, reps: int = 20, tries: int = 3) -> dict:
    """Device time of one fn() by kernel name (torch.profiler over
    ``reps`` calls); a profile that recorded no device time is taken
    again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = {e.key[:60]: e.self_device_time_total / 1e3 / reps
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}
        if sum(times.values()) > 0:
            return times
    return {}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="JSON file for the splits")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("scan_phase_clocks: no CUDA device")
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba2_ssd import ssd_scan
    from repro_torch.kernels.wkv6 import wkv6_scan
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    B, S, H, P, N, C = 4, 256, 64, 64, 64, 128
    wkv = [rnd((B, S, H, P), 0.5) for _ in range(3)]
    wkv += [-torch.exp(rnd((B, S, H, P)) - 2.0), rnd((H, P), 0.3)]
    H4 = 80
    ssd = [rnd((B, S, H4, P), 0.5),
           torch.nn.functional.softplus(rnd((B, S, H4))), rnd((H4,), 0.2),
           rnd((B, S, N), 0.5), rnd((B, S, N), 0.5)]
    calls = {"wkv6_kernel": ("wkv6.cu", [B, S, H, P], C,
                             lambda: wkv6_scan(*wkv, chunk=C)),
             "ssd": ("mamba2_ssd.cu", [B, S, H4, P, N], C,
                     lambda: ssd_scan(*ssd, chunk=C))}
    plain = {k: (events_ms(fn), device_ms_by_kernel(fn))
             for k, (_, _, _, fn) in calls.items()}
    ns, labels = build_stamped(ROOT / "build" / "phase_clocks")
    real_load = _build.load
    _build.load = lambda: ns
    results = []
    try:
        for key, (src, shape, chunk, fn) in calls.items():
            lib = ns.libs[src]
            name = next(n for n in KERNELS[src] if n in labels)
            fn()
            torch.cuda.synchronize()
            lib.scan_pc_reset()
            stamped_ms = events_ms(fn, reps=1)   # two calls: warm-up, timed
            buf = (ctypes.c_ulonglong * PHASES)()
            lib.scan_pc_read(buf)
            cycles = list(buf)[:len(labels[name])]
            total = sum(cycles)
            ms, dev = plain[key]
            results.append({
                "kernel": name, "device": smi, "shape": shape,
                "chunk": chunk, "dtype": "float32", "ms": ms,
                "device_ms_by_kernel": dev, "stamped_ms": stamped_ms,
                "phases": [{"phase": lab, "share": c / total}
                           for lab, c in zip(labels[name], cycles)]})
            print(json.dumps(results[-1]), flush=True)
    finally:
        _build.load = real_load
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
