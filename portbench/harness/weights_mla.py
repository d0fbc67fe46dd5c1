"""Seeded weights of a DeepSeek-V2 model (latent attention, leading dense
layers, then MoE layers), made by the benchmark on the device, in the
layout the port and ``reference/deepseek_v2.py`` both read.

One normal draw per stacked tensor from a ``torch.Generator`` on the
device, in a fixed order, so the same seed gives the same tensors in
every process.  Scales: projections, expert banks and the router
1/sqrt(d_in), the embedding 0.02, the head 1/sqrt(d_model), norm scales
1.  Dtypes: the projections, the banks and the shared experts in the
compute dtype; the router, the norms, the embedding and the head in the
parameter dtype (fp32).
"""
from __future__ import annotations

import math

import torch

from .weights import DTYPES


def make(cfg: dict, seed: int, device) -> dict:
    run = cfg["run"]
    pdt, cdt = DTYPES[run["param_dtype"]], DTYPES[run["compute_dtype"]]
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    H, R = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, E = cfg["v_head_dim"], cfg["n_routed_experts"]
    nd = cfg["first_k_dense_replace"]
    nm = cfg["num_hidden_layers"] - nd
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def normal(shape, std, dtype):
        return torch.empty(shape, dtype=dtype, device=device).normal_(
            0.0, std, generator=gen)

    def proj(n, d_in, d_out, dtype=cdt):
        return {"w": normal((n, d_in, d_out), 1.0 / math.sqrt(d_in), dtype)}

    def ones(shape):
        return {"scale": torch.ones(shape, dtype=pdt, device=device)}

    def block(n):
        return {"ln1": ones((n, d)),
                "attn": {"wq": proj(n, d, H * (nope + rope)),
                         "wkv_a": proj(n, d, R + rope),
                         "kv_norm": ones((n, R)),
                         "wkv_b": proj(n, R, H * (nope + vd)),
                         "wo": proj(n, H * vd, d)},
                "ln2": ones((n, d))}

    def gated(n, ff):
        return {"wg": proj(n, d, ff), "wu": proj(n, d, ff),
                "wd": proj(n, ff, d)}

    def bank(d_in, d_out):
        return normal((nm, E, d_in, d_out), 1.0 / math.sqrt(d_in), cdt)

    p = {"embed": {"e": normal((V, d), 0.02, pdt)},
         "final_norm": ones((d,))}
    p["dense_layers"] = dict(block(nd),
                             mlp=gated(nd, cfg["intermediate_size"]))
    ff = cfg["moe_intermediate_size"]
    p["layers"] = dict(block(nm), moe={
        "router": proj(nm, d, E, pdt), "wg": bank(d, ff), "wu": bank(d, ff),
        "wd": bank(ff, d), "shared": gated(nm, ff * cfg["n_shared_experts"])})
    p["lm_head"] = {"w": normal((d, V), 1.0 / math.sqrt(d), pdt)}
    return p
