"""Roofline terms of one rank's program on the H100 (the counterpart of
the reference's ``launch/roofline.py``, which holds a TPU's constants and
reads collectives off compiled HLO).

Three terms per (arch x shape x mesh) cell, in seconds, from one rank's
program (``launch.hlo_analysis.analyze_program``: the port's programs are
per rank, so its flops and bytes are per chip, as the reference's
post-SPMD numbers are):

    compute    = sum over dtypes of that dtype's flops / its peak
    memory     = bytes / HBM rate
    collective = per-chip link bytes / NVLink rate

The one departure from the reference's arithmetic is the compute term:
the port's attention walk and LM head are fp32 products on the CUDA
cores, which run at a fifteenth of the bf16 tensor cores' rate, so one
peak would understate them.  ``roofline_fraction`` keeps the reference's
definition, against the bf16 peak.

H100 SXM5 80GB constants (NVIDIA's H100 data sheet; dense rates, without
sparsity, at the 700 W power limit): 989 TFLOP/s bf16 and fp16, 495 TFLOP/s
TF32 (which the scans' 3xTF32 products run at), 67 TFLOP/s fp32 outside
the tensor cores, 3.35 TB/s HBM3, NVLink 4 at 450 GB/s a direction.

Collectives come from the counts the port keeps by kind
(``TensorParallel.comm``, a train step's ``step.comm``): every collective
the port issues is an ``all_reduce`` (gloo runs only ``all_reduce`` and
``broadcast`` on CUDA tensors), but each kind is the logical collective
it stands for, and the roofline charges that one, with the reference's
ring formulas (``ring_link_bytes``): the FSDP gather and the logits
gather are all-gathers of the whole tensor, the FSDP gradient reduction
a reduce-scatter to this rank's block, and the others all-reduces.  On a
trace's meta tensors the collectives record their calls and bytes
without running, so a dry-run counts them as a run does.
"""
from __future__ import annotations

import dataclasses

# H100 SXM5 80GB, NVIDIA's data sheet: the peak rate of each unit by the
# type of its products (dense)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
HBM_BW = 3.35e12           # bytes/s / chip
NVLINK_BW = 450e9          # bytes/s / chip, one direction

# the logical collective each kind of the port's comm counts stands for
KIND_COLLECTIVE = {"fsdp_gather": "all-gather", "logits_gather": "all-gather",
                   "reduce_scatter": "reduce-scatter"}


def ring_link_bytes(base: str, res_bytes: float, group: int) -> float:
    """Per-chip link bytes of one collective of ``base`` kind whose result
    is ``res_bytes`` over a group of ``group`` chips: the reference's ring
    formulas (its ``parse_collectives``)."""
    frac = (group - 1) / group if group > 1 else 0.0
    if base == "all-reduce":
        return 2.0 * res_bytes * frac       # reduce-scatter + all-gather
    if base == "all-gather":
        return res_bytes * frac             # result is gathered
    if base == "reduce-scatter":
        return res_bytes * (group - 1) if group > 1 else 0  # result shard
    if base == "all-to-all":
        return res_bytes * frac
    if base == "collective-permute":
        return res_bytes
    raise ValueError(f"no ring formula for {base!r}")


@dataclasses.dataclass
class CollectiveStats:
    """Per-chip collective traffic of one rank's program."""

    ops: dict            # kind -> {"count", "result_bytes", "link_bytes"}
    link_bytes: float    # per-chip link bytes (ring formulas)

    def as_dict(self):
        return {"ops": self.ops, "link_bytes": self.link_bytes}


def collective_stats(comm: dict, groups: dict) -> CollectiveStats:
    """The collectives counted in ``comm`` (kind -> {"calls", "bytes"},
    the bytes of each call's tensor), each charged as its logical
    collective (``KIND_COLLECTIVE``, else all-reduce) over its group's
    size (``groups``: kind -> chips).  A reduce-scatter's result is the
    rank's block, the tensor's bytes over the group; the others' result
    is the tensor.  ``ops`` is keyed by the reference's collective names;
    ``kinds`` by the port's."""
    ops: dict[str, dict] = {}
    link = 0.0
    for kind, row in sorted(comm.items()):
        if not row.get("calls"):
            continue
        base = KIND_COLLECTIVE.get(kind, "all-reduce")
        g = groups[kind]
        per_call = row["bytes"] / row["calls"]
        res = per_call / g if base == "reduce-scatter" else per_call
        lb = row["calls"] * ring_link_bytes(base, res, g)
        d = ops.setdefault(base, {"count": 0, "result_bytes": 0,
                                  "link_bytes": 0.0, "kinds": {}})
        d["count"] += row["calls"]
        d["result_bytes"] += int(row["calls"] * res)
        d["link_bytes"] += lb
        d["kinds"][kind] = {"calls": row["calls"], "bytes": row["bytes"],
                            "group": g}
        link += lb
    return CollectiveStats(ops=ops, link_bytes=link)


@dataclasses.dataclass
class Roofline:
    flops: float               # per chip (one rank's program)
    hbm_bytes: float           # per chip
    link_bytes: float          # per-chip collective bytes
    chips: int
    model_flops: float = 0.0   # GLOBAL 6*N*D (or per-graph estimate)
    flops_by_dtype: dict | None = None   # dtype -> flops; None: all bf16

    @property
    def t_compute(self) -> float:
        by = self.flops_by_dtype
        if by is None:
            by = {"bfloat16": self.flops}
        return sum(f / PEAK_FLOPS[d] for d, f in by.items())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.link_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / modeled step time (bound by max term)."""
        t_useful = self.model_flops / (self.chips * PEAK_FLOPS["bfloat16"])
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / t_bound if t_bound > 0 else 0.0

    @property
    def flops_efficiency(self) -> float:
        """MODEL_FLOPS / global program flops — remat/redundancy waste."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def as_dict(self):
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "link_bytes": self.link_bytes, "chips": self.chips,
            "model_flops": self.model_flops,
            "flops_by_dtype": self.flops_by_dtype,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_fraction": self.roofline_fraction,
            "flops_efficiency": self.flops_efficiency,
        }


def model_flops_estimate(cfg, shape, n_params: int) -> float:
    """Useful MODEL_FLOPS per step.

    Parameter term: 6*N*D training / 2*N*D prefill / 2*N_active per decode
    token (MoE counts active params).  Attention term: the quadratic
    score+context GEMMs (4*B*S^2*H*hd per layer forward, x3 with backward,
    halved causal) — at 32k context this legitimately dominates small
    models and must count as useful work, not waste.  SSM/RWKV chunked
    scans add their (sub-quadratic) state-update flops."""
    active = n_params
    if cfg.n_experts:
        expert_frac = (cfg.top_k + cfg.shared_experts) / max(
            cfg.n_experts + cfg.shared_experts, 1)
        dense_part = 0.35
        active = n_params * (dense_part + (1 - dense_part) * expert_frac)
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S

    # attention quadratic useful work (causal: half the square)
    n_attn = cfg.attention_layer_count()
    H, hd = cfg.n_heads, cfg.head_dim
    if shape.kind in ("train", "prefill") and n_attn:
        attn = n_attn * 4.0 * B * (S * S / 2) * H * hd
        if cfg.alt_local_global and cfg.window:
            local = n_attn // 2
            attn = ((n_attn - local) * 4.0 * B * (S * S / 2) * H * hd
                    + local * 4.0 * B * S * min(cfg.window, S) * H * hd)
    else:
        attn = 0.0

    # recurrent-state useful work (chunked SSD/WKV): ~4*B*S*inner*state
    rec = 0.0
    if cfg.ssm_layer_count() and shape.kind in ("train", "prefill"):
        d_inner = cfg.ssm_inner_dim()
        rec += cfg.ssm_layer_count() * 4.0 * B * S * d_inner * cfg.ssm_state
    if cfg.rwkv_layer_count() and shape.kind in ("train", "prefill"):
        rec += cfg.rwkv_layer_count() * 4.0 * B * S * cfg.d_model * 64

    if shape.kind == "train":
        return 6.0 * active * tokens + 3.0 * (attn + rec)
    if shape.kind == "prefill":
        return 2.0 * active * tokens + (attn + rec)
    # decode: one token per sequence; attention reads the KV cache
    dec_attn = n_attn * 4.0 * B * S * H * hd if n_attn else 0.0
    return 2.0 * active * B + dec_attn
