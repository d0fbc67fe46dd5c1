"""The yardstick's arithmetic: the card's peaks, a GEMM's operations and
bytes, and a dense decoder's model flops.  Kept here, not read from the
program, so that a change to the program cannot move the yardstick.

Peaks are NVIDIA's data sheet for the H100 SXM, dense rates without
sparsity, at its 700 W limit.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "tf32": 495e12}
PEAK_BYTES_PER_S = 3.35e12
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def least_time(flops: float, nbytes: float, dtype: str) -> float:
    """The least seconds the card could take: the larger of the
    operations at the type's peak and the bytes at the memory's peak."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def gemm_work(m: int, n: int, k: int, dtype: str) -> tuple[float, float]:
    """(operations, bytes) of C[m, n] = A[m, k] @ B[k, n]: each input read
    once and the output written once."""
    b = BYTES[dtype]
    return 2.0 * m * n * k, float(b * (m * k + k * n + m * n))


def combine_work(m: int, ff: int, dtype: str) -> tuple[float, float]:
    """(operations, bytes) of the gated combine act(G) * U over (m, ff):
    two inputs read, one output written; a few operations an element."""
    return 4.0 * m * ff, float(BYTES[dtype] * 3 * m * ff)


def dims(cfg: dict) -> dict:
    """The sizes the flop counts need, from a configuration file."""
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or d // h
    return {"layers": cfg["num_hidden_layers"], "d": d, "heads": h,
            "kv": cfg["num_key_value_heads"], "hd": hd,
            "ff": cfg["intermediate_size"], "vocab": cfg["vocab_size"]}


def layer_matmul_params(cfg: dict) -> int:
    """Weights one decoder layer multiplies: the four attention
    projections and the gated MLP's three."""
    x = dims(cfg)
    q = x["heads"] * x["hd"]
    kv = x["kv"] * x["hd"]
    return x["d"] * (2 * q + 2 * kv) + 3 * x["d"] * x["ff"]


def head_params(cfg: dict) -> int:
    x = dims(cfg)
    return x["d"] * x["vocab"]


def attn_flops(cfg: dict, context: int) -> float:
    """Forward flops of one query token's attention in every layer over
    ``context`` keys: the scores and the weighted sum."""
    x = dims(cfg)
    return 4.0 * context * x["heads"] * x["hd"] * x["layers"]


def token_flops(cfg: dict, context: int, head: bool) -> float:
    """Forward model flops of one token at ``context`` visible keys
    (itself included), with the LM head where the token yields logits
    that are used."""
    x = dims(cfg)
    f = 2.0 * layer_matmul_params(cfg) * x["layers"] + attn_flops(
        cfg, context)
    return f + (2.0 * head_params(cfg) if head else 0.0)


def chunk_flops(cfg: dict, start: int, n: int) -> float:
    """Forward model flops of prompt positions [start, start + n) of a
    causal prefill, without the LM head."""
    x = dims(cfg)
    lin = 2.0 * layer_matmul_params(cfg) * x["layers"] * n
    # position p sees p + 1 keys
    keys = n * start + n * (n + 1) / 2.0
    return lin + 4.0 * keys * x["heads"] * x["hd"] * x["layers"]


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model flops of one training step: forward and backward (three
    times the forward) of every position with the head, causal
    attention, and no recomputation."""
    return 3.0 * batch * (chunk_flops(cfg, 0, seq)
                          + 2.0 * head_params(cfg) * seq)
