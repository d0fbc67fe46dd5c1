"""Seeded weights of a dense decoder, made by the benchmark on the
device, in the layout the port and the reference both read.

One normal draw per stacked tensor from a ``torch.Generator`` on the
device, in a fixed order, so the same seed gives the same tensors in
every process: the port is handed them, and after the window the
reference reads the same tensors (serving) or draws them again
(training, whose step updated them in place).  Scales: projections
1/sqrt(d_in), the embedding 0.02, the head 1/sqrt(d_model), norm scales
1 and biases 0.

Dtypes: served, the projections are in the compute dtype and the rest
in the parameter dtype; with ``masters`` (training) every tensor is in
the parameter dtype.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make(cfg: dict, seed: int, device, *, masters: bool) -> dict:
    from .work import dims
    x = dims(cfg)
    run = cfg["run"]
    pdt = DTYPES[run["param_dtype"]]
    cdt = pdt if masters else DTYPES[run["compute_dtype"]]
    n, d, ff, V = x["layers"], x["d"], x["ff"], x["vocab"]
    q, kv = x["heads"] * x["hd"], x["kv"] * x["hd"]
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def normal(shape, std, dtype):
        return torch.empty(shape, dtype=dtype, device=device).normal_(
            0.0, std, generator=gen)

    def proj(d_in, d_out):
        return {"w": normal((n, d_in, d_out), 1.0 / math.sqrt(d_in), cdt)}

    def norm(shape):
        out = {"scale": torch.ones(shape, dtype=pdt, device=device)}
        if run["norm"] == "layernorm":
            out["bias"] = torch.zeros(shape, dtype=pdt, device=device)
        return out

    p = {"embed": {"e": normal((V, d), 0.02, pdt)},
         "final_norm": norm((d,))}
    p["layers"] = {
        "ln1": norm((n, d)),
        "attn": {"wq": proj(d, q), "wk": proj(d, kv), "wv": proj(d, kv),
                 "wo": proj(q, d)},
        "ln2": norm((n, d)),
        "mlp": {"wg": proj(d, ff), "wu": proj(d, ff), "wd": proj(ff, d)}}
    p["lm_head"] = {"w": normal((d, V), 1.0 / math.sqrt(d), pdt)}
    return p


def leaves(tree: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, paths joined by '/', in sorted-key
    order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out += leaves(v, path + "/")
        else:
            out.append((path, v))
    return out
