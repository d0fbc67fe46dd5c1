"""Serving entry point of the port: one static batch through ``Engine.generate``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --fused-mlp [--smoke] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given; without a card
and without that flag it exits with an error instead of falling back.
Weights are random, made on the device from a seeded torch.Generator.
The continuous scheduler (``--continuous``) and the plan store come with
later slices of the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..models import build_model
from ..serving import Engine, ServeConfig


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--fused-mlp", action="store_true",
                    help="route gated-MLP blocks through the GOMA-chain-"
                         "planned fused kernel (the B1 composition where "
                         "the chain does not fuse)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is available; pass --device cpu to serve "
                 "on the CPU")

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.fused_mlp:
        cfg = dataclasses.replace(cfg, fused_mlp=True)
    model = build_model(cfg)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(0), device)
    eng = Engine(model, params, ServeConfig(
        max_new_tokens=args.new_tokens, temperature=args.temperature,
        cache_len=args.prompt_len + args.new_tokens + 8))

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab,
                           (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    out = eng.generate(prompts,
                       rng=torch.Generator(device=device).manual_seed(1)
                       if args.temperature > 0 else None)
    dt = time.perf_counter() - t0
    tok_s = args.batch * args.new_tokens / dt
    print(f"{cfg.name} on {device}: generated {out.shape} in {dt:.2f}s "
          f"({tok_s:.1f} tok/s)")
    print(out[:, :12])


if __name__ == "__main__":
    main()
