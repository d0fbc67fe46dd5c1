#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 portbench/run.py --workload yi34b.chat --seed 7 --seconds 45 \\
        --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, from the port's spans and a device trace.  The last
line of standard output is one JSON object; the numbers compared for
``correct`` are the last lines of standard error and the line's last
key.  ``--control 1`` also computes the fp8 control's readings (used to
set the limits; the benchmark's own runs leave it off).

Without a CUDA card, with fewer cards than the cell asks for, without
the port beside the benchmark, or with JAX or the JAX package loaded
once the window has closed, it exits non-zero and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "portbench" / ".cache"


def environment() -> None:
    """Caches at fixed paths inside the checkout; JAX kept away."""
    os.environ["USE_FLAX"] = "0"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ.pop("GOMA_PLAN_DB", None)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the port (src/repro_torch) is not beside the benchmark",
              file=sys.stderr)
        return 2
    from portbench.harness import result, spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    driver = importlib.import_module(
        f"portbench.harness.{cell.traffic['kind']}")
    out = driver.run(cell, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device="cuda",
                     t_start=T_START, store_dir=CACHE / "plans",
                     control=bool(args.control))
    found = result.forbidden_modules()
    if found:
        print(f"modules that must not load were loaded: {found}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips}
    result.emit(result.line(cell, out, bool(args.trace), device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
