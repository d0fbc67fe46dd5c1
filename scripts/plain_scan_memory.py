"""Peak device memory of the plain scans (``wkv6_scan_plain``,
``ssd_scan_plain``) at the full-width prefill shapes of ``chip_smoke.py``'s
phases 8 and 9, without grad, as those phases' kernel-vs-plain checks run
them; and, with ``--src``, the same for another checkout's plain scans,
in the same process, so that two versions are compared on one card.

    python3 scripts/plain_scan_memory.py [--src OTHER/src] [--out FILE]

For each version and scan: the peak bytes allocated during one call
above what its inputs hold (``torch.cuda.max_memory_allocated``), and the
call's time (CUDA events, after a warm-up).  Prints one JSON object.
Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

import torch  # noqa: E402

# chip_smoke.py's FULL_WKV (B, S, H, P) and FULL_SSD (B, S, H, P, N): the
# rwkv6-7b and zamba2-2.7b prefills of phases 8 and 9, chunk 128
WKV, SSD, CHUNK = (4, 256, 64, 64), (4, 256, 80, 64, 64), 128


def load(src: pathlib.Path, name: str, tag: str):
    """The module ``repro_torch.kernels.<name>`` of the checkout ``src``
    under its own name (its relative imports resolved in that checkout)."""
    pkg = f"_plain_{tag}"
    if pkg not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            pkg, src / "repro_torch" / "__init__.py",
            submodule_search_locations=[str(src / "repro_torch")])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[pkg] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"{pkg}.kernels.{name}")


def measure(fn) -> dict:
    torch.cuda.synchronize()
    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return {"peak_bytes": peak, "peak_gib": peak / 2**30,
            "ms": start.elapsed_time(end)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None,
                    help="another checkout's src directory to compare")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("plain_scan_memory: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda shape, s=1.0: torch.randn(shape, generator=gen,
                                          device="cuda") * s
    r, k, v = (rn(WKV, 0.5) for _ in range(3))
    logw = -torch.exp(rn(WKV) - 2.0)
    u = rn(WKV[2:], 0.5)
    B, S, H, P, N = SSD
    xh = rn((B, S, H, P), 0.5)
    dt = torch.nn.functional.softplus(rn((B, S, H)))
    a_log, Bm, Cm = rn((H,), 0.2), rn((B, S, N), 0.5), rn((B, S, N), 0.5)
    versions = {"this": ROOT / "src"}
    if args.src:
        versions["other"] = pathlib.Path(args.src).resolve()
    report = {"device": smi, "wkv6_shape": WKV, "ssd_shape": SSD,
              "chunk": CHUNK}
    for tag, src in versions.items():
        w = load(src, "wkv6", tag)
        s = load(src, "mamba2_ssd", tag)
        with torch.no_grad():
            report[tag] = {
                "src": str(src),
                "wkv6_scan_plain": measure(lambda: w.wkv6_scan_plain(
                    r, k, v, logw, u, chunk=CHUNK)),
                "ssd_scan_plain": measure(lambda: s.ssd_scan_plain(
                    xh, dt, a_log, Bm, Cm, chunk=CHUNK))}
    print(json.dumps(report))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
