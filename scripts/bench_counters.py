"""One benchmark run (``portbench/run.py``'s arguments), then, in the same
process, the registry's latent-attention and step-graph counters over
the whole run (set-up, window and check) and the latent attention
kernel's eager launches (a graph's replays launch nothing new).

    python3 scripts/bench_counters.py --workload dsv2lite.chat8k \\
        --seed N --seconds 51 --trace 0

Prints run.py's result line, then one JSON line of the counters.  Exits
with run.py's code.
"""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    from portbench import run
    rc = run.main(sys.argv[1:])
    from repro_torch.kernels import mla_attention as MK
    from repro_torch.obs.registry import get_registry
    reg = get_registry()
    print(json.dumps({"rc": rc, **{k: reg.get(k) for k in (
        "attn.mla", "attn.mla_kernel", "attn.walk", "serve.graphs.captured",
        "serve.graphs.failures")},
        "mla_attention.launches": MK.mla_attention.launches}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
