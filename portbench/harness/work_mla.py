"""The yardstick's model flops of a DeepSeek-V2 model (latent attention,
leading dense layers, MoE layers), kept here, not read from the program,
so that a change to the program cannot move it.

A token's forward flops: 2 x the matmul parameters it is multiplied by
(the attention projections of every layer; the dense layers' MLP; in
each MoE layer the router, its top-k routed experts and the shared
experts), and attention in the published, expanded form: 2 x heads x
context x (qk head size + v head size) a token a layer, whether or not
the program absorbs.  The head once for every token whose logits are
used.  Peaks are ``work.py``'s.
"""
from __future__ import annotations

from .work import PEAK_FLOPS  # noqa: F401  (the readers' peak)


def dims(cfg: dict) -> dict:
    nd = cfg["first_k_dense_replace"]
    return {"layers": cfg["num_hidden_layers"], "dense": nd,
            "moe": cfg["num_hidden_layers"] - nd, "d": cfg["hidden_size"],
            "heads": cfg["num_attention_heads"],
            "qk": cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
            "rope": cfg["qk_rope_head_dim"], "v": cfg["v_head_dim"],
            "rank": cfg["kv_lora_rank"], "dense_ff": cfg["intermediate_size"],
            "ff": cfg["moe_intermediate_size"],
            "experts": cfg["n_routed_experts"],
            "top_k": cfg["num_experts_per_tok"],
            "shared": cfg["n_shared_experts"], "vocab": cfg["vocab_size"]}


def attn_params(cfg: dict) -> int:
    """W_q, W_kva, W_kvb and W_o of one layer."""
    x = dims(cfg)
    H, d = x["heads"], x["d"]
    return (d * H * x["qk"] + d * (x["rank"] + x["rope"])
            + x["rank"] * H * (x["qk"] - x["rope"] + x["v"])
            + H * x["v"] * d)


def active_params(cfg: dict) -> int:
    """Matmul parameters a token is multiplied by in every layer."""
    x = dims(cfg)
    d = x["d"]
    dense = 3 * d * x["dense_ff"]
    moe = (d * x["experts"] + 3 * d * x["ff"] * x["top_k"]
           + 3 * d * x["ff"] * x["shared"])
    return (x["layers"] * attn_params(cfg) + x["dense"] * dense
            + x["moe"] * moe)


def head_params(cfg: dict) -> int:
    x = dims(cfg)
    return x["d"] * x["vocab"]


def attn_flops(cfg: dict, keys: float) -> float:
    """Attention flops of ``keys`` (query, key) pairs in every layer."""
    x = dims(cfg)
    return 2.0 * x["heads"] * keys * (x["qk"] + x["v"]) * x["layers"]


def token_flops(cfg: dict, context: int, head: bool) -> float:
    """Forward model flops of one token at ``context`` visible keys
    (itself included), with the head where its logits are used."""
    f = 2.0 * active_params(cfg) + attn_flops(cfg, context)
    return f + (2.0 * head_params(cfg) if head else 0.0)


def chunk_flops(cfg: dict, start: int, n: int) -> float:
    """Forward model flops of prompt positions [start, start + n) of a
    causal prefill, without the head."""
    keys = n * start + n * (n + 1) / 2.0
    return 2.0 * active_params(cfg) * n + attn_flops(cfg, keys)
