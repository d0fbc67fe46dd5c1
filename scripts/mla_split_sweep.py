"""The latent attention kernel's device time at each split width: the
keys one CTA walks before ``mla_combine`` joins the partials
(``kernels.mla_attention.SPLIT``, 1024 in the port).

    python3 scripts/mla_split_sweep.py [--splits 1024,256,512,2048,4096]

At ``chip_smoke.py``'s phase-24 shapes: DeepSeek-V2-Lite's decode over
128 slots of 8192 keys (positions from chat8k's length distributions)
and 512-wide chunks over a 4096 and a 6144 bucket.  Prints one JSON line
a (split, case): device time (torch.profiler), the least time
(``work``'s bytes over the memory rate), and the largest difference from
the first split's output over its scale (the sums' order moves, nothing
else).  Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", default="1024,256,512,2048,4096")
    args = ap.parse_args()
    import numpy as np
    import torch
    import chip_smoke as C
    from repro_torch.kernels import mla_attention as MK
    rng = np.random.default_rng(C.SEED)
    gen = torch.Generator(device="cuda").manual_seed(C.SEED)
    B, T = C.MLA_DECODE
    H, D = C.MLA_HEADS, MK.KEY_DIM
    cache = torch.randn((B, T, D), generator=gen, device="cuda").to(
        torch.bfloat16)

    def queries(B, S):
        return (0.05 * torch.randn((B, S, H, D), generator=gen,
                                   device="cuda")).to(torch.bfloat16)
    qpos = torch.tensor(C.mla_positions(rng, B, T), dtype=torch.int64,
                        device="cuda")[:, None].contiguous()
    cases = [("decode", queries(B, 1), cache, qpos)]
    for W, ctx in C.MLA_CHUNKS:
        start = ctx - W - 100
        cases.append((f"chunk{W}@{ctx}", queries(1, W), cache[3:4, :ctx],
                      torch.arange(start, start + W, device="cuda")[None]))
    first = {}
    for split in (int(x) for x in args.splits.split(",")):
        MK.SPLIT = split
        for name, q, ckv, pos in cases:
            out = MK.mla_attention(q, ckv, pos).float()
            ref = first.setdefault(name, out)
            w = MK.work(*q.shape[:3], ckv.shape[1], pos)
            print(json.dumps({
                "split": split, "case": name,
                "device_ms": C.device_ms(lambda: MK.mla_attention(q, ckv,
                                                                  pos)),
                "bound_ms": w["bytes"] / C.HBM_BYTES_PER_S * 1e3,
                "diff_vs_first": float((out - ref).abs().max()
                                       / ref.abs().max())}), flush=True)


if __name__ == "__main__":
    main()
