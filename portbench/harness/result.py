"""The run's last line, and the checks printed beside it."""
from __future__ import annotations

import json
import sys

from . import spec

# top-level module names that the benchmark's process must not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules, compared
    whole: ``repro_torch`` is not ``repro``."""
    modules = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in modules}
    return sorted(t for t in tops if t in FORBIDDEN)


def metrics(cell, out: dict, trace: bool) -> dict:
    """Each of the cell's metrics for this kind of run, from its reader;
    a reader that finds nothing to read leaves its metric out."""
    wanted = cell.per_layer if trace else cell.end_to_end
    got = {}
    for m in wanted:
        value = spec.reader(m["name"])(out["run"])
        if value is not None:
            got[m["name"]] = {"value": value, "unit": m["unit"]}
    return got


def line(cell, out: dict, trace: bool, device: dict) -> dict:
    prof = out["run"].profile
    device = dict(device, memory_peak_bytes=out["memory_peak_bytes"])
    if trace and prof is not None:
        device.update(busy_s=prof.busy_s, window_s=prof.window_s)
    result = {"correct": bool(out["correct"]) and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics(cell, out, trace), "device": device}
    if trace and prof is not None:
        host = out["run"].host_profile or prof
        result["breakdown"] = {"device_ops": prof.device_ops(),
                               "idle_gaps": host.idle_gaps()}
    for key in ("compared", "control", "note"):
        if key in out:
            result[key] = out[key]
    result["checks"] = out["checks"]
    return result


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, then the result
    as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
