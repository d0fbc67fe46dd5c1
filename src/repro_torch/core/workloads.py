"""GEMM workload extraction from LLM prefill graphs (paper §V-A1).

Each model's prefill phase is reduced to the paper's eight GEMM types with
occurrence-count weights w_g (eq. 35) derived from structural parameters
(#layers, #heads, MoE fanout).  The paper's four evaluation models are
defined here; `arch_gemms` additionally extracts GEMM sets from this
repo's ten assigned architectures (repro.configs) so the GOMA mapper can
plan them too (DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from .geometry import Gemm

GEMM_TYPES = ("attn_q_proj", "attn_kv_proj", "attn_score", "attn_context",
              "attn_output", "mlp_gate_up", "mlp_down", "lm_head")


@dataclasses.dataclass(frozen=True)
class LlmSpec:
    """Structural parameters needed to enumerate prefill GEMMs."""

    name: str
    layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # MoE (0 = dense)
    n_experts: int = 0
    top_k: int = 0
    shared_experts: int = 0
    # sliding-window layers (gemma2-style local/global alternation)
    window: int | None = None
    local_ratio: float = 0.0   # fraction of layers using the window


# --- the paper's four evaluation models (public configs) -------------------
QWEN3_0_6B = LlmSpec("qwen3-0.6b", layers=28, d_model=1024, n_heads=16,
                     kv_heads=8, head_dim=128, d_ff=3072, vocab=151936)
LLAMA32_1B = LlmSpec("llama-3.2-1b", layers=16, d_model=2048, n_heads=32,
                     kv_heads=8, head_dim=64, d_ff=8192, vocab=128256)
QWEN3_32B = LlmSpec("qwen3-32b", layers=64, d_model=5120, n_heads=64,
                    kv_heads=8, head_dim=128, d_ff=25600, vocab=151936)
LLAMA33_70B = LlmSpec("llama-3.3-70b", layers=80, d_model=8192, n_heads=64,
                      kv_heads=8, head_dim=128, d_ff=28672, vocab=128256)

EDGE_MODELS = (QWEN3_0_6B, LLAMA32_1B)
CENTER_MODELS = (QWEN3_32B, LLAMA33_70B)
EDGE_SEQ_LENS = (1024, 8192, 32768)
CENTER_SEQ_LENS = (2048, 32768, 131072)


def prefill_gemms(spec: LlmSpec, seq: int) -> list[tuple[str, Gemm, int]]:
    """The eight GEMM mapping instances of one prefill, with weights.

    Conventions (P(x,y) = sum_z A(x,z)B(y,z)): x = output rows, y = output
    cols, z = reduction.  Per-head attention GEMMs are one instance each,
    weighted by #layers x #heads.  lm_head is applied to the last token
    only (matrix-vector, as the paper's Fig. 7 discussion notes).
    """
    L, H, KV, hd = spec.layers, spec.n_heads, spec.kv_heads, spec.head_dim
    d, ff, vocab = spec.d_model, spec.d_ff, spec.vocab
    score_len = seq
    if spec.window is not None and spec.local_ratio >= 1.0:
        score_len = min(seq, spec.window)

    out: list[tuple[str, Gemm, int]] = [
        ("attn_q_proj", Gemm(seq, H * hd, d, "attn_q_proj"), L),
        ("attn_kv_proj", Gemm(seq, KV * hd, d, "attn_kv_proj"), 2 * L),
        ("attn_score", Gemm(seq, score_len, hd, "attn_score"), L * H),
        ("attn_context", Gemm(seq, hd, score_len, "attn_context"), L * H),
        ("attn_output", Gemm(seq, d, H * hd, "attn_output"), L),
    ]
    if spec.n_experts:
        # fine-grained MoE: per-expert token share (capacity-balanced)
        m_exp = max(1, seq * spec.top_k // spec.n_experts)
        n_mats = spec.n_experts + spec.shared_experts
        out += [
            ("mlp_gate_up", Gemm(m_exp, ff, d, "mlp_gate_up"), 2 * L * n_mats),
            ("mlp_down", Gemm(m_exp, d, ff, "mlp_down"), L * n_mats),
        ]
    else:
        out += [
            ("mlp_gate_up", Gemm(seq, ff, d, "mlp_gate_up"), 2 * L),
            ("mlp_down", Gemm(seq, d, ff, "mlp_down"), L),
        ]
    out.append(("lm_head", Gemm(1, vocab, d, "lm_head"), 1))
    return out


def decode_gemms(spec: LlmSpec, batch: int,
                 cache_len: int) -> list[tuple[str, Gemm, int]]:
    """GEMM instances of one batched decode step (serving traffic shape).

    One new token per sequence: every projection collapses to M = batch
    rows, and the attention score/context GEMMs run against the KV cache
    (y resp. z extent = cache_len).  These are the shapes a serving engine
    re-plans on every deployment — the planner's bread and butter.
    """
    L, H, KV, hd = spec.layers, spec.n_heads, spec.kv_heads, spec.head_dim
    d, ff, vocab = spec.d_model, spec.d_ff, spec.vocab
    ctx = cache_len
    if spec.window is not None and spec.local_ratio >= 1.0:
        ctx = min(cache_len, spec.window)
    out: list[tuple[str, Gemm, int]] = [
        ("attn_q_proj", Gemm(batch, H * hd, d, "attn_q_proj"), L),
        ("attn_kv_proj", Gemm(batch, KV * hd, d, "attn_kv_proj"), 2 * L),
        ("attn_score", Gemm(batch, ctx, hd, "attn_score"), L * H),
        ("attn_context", Gemm(batch, hd, ctx, "attn_context"), L * H),
        ("attn_output", Gemm(batch, d, H * hd, "attn_output"), L),
    ]
    if spec.n_experts:
        m_exp = max(1, batch * spec.top_k // spec.n_experts)
        n_mats = spec.n_experts + spec.shared_experts
        out += [
            ("mlp_gate_up", Gemm(m_exp, ff, d, "mlp_gate_up"), 2 * L * n_mats),
            ("mlp_down", Gemm(m_exp, d, ff, "mlp_down"), L * n_mats),
        ]
    else:
        out += [
            ("mlp_gate_up", Gemm(batch, ff, d, "mlp_gate_up"), 2 * L),
            ("mlp_down", Gemm(batch, d, ff, "mlp_down"), L),
        ]
    out.append(("lm_head", Gemm(batch, vocab, d, "lm_head"), 1))
    return out


def merge_gemm_rows(rows: "Sequence[tuple[str, Gemm, int]]"
                    ) -> list[tuple[str, Gemm, int]]:
    """Merge identical (Gemm, name) rows by summing repeat weights,
    first-seen order — so a scenario never carries the same mapping
    instance twice and the batch planner solves each unique shape once
    (asserted via ``core.solver.solver_stats`` in the tests)."""
    merged: dict[tuple[str, Gemm], int] = {}
    order: list[tuple[str, Gemm]] = []
    for gtype, gemm, w in rows:
        key = (gtype, gemm)
        if key in merged:
            merged[key] += w
        else:
            merged[key] = w
            order.append(key)
    return [(t, g, merged[(t, g)]) for t, g in order]


def scenario_gemms(spec: LlmSpec, *, prefill_seqs: Sequence[int] = (),
                   decode_batches: Sequence[int] = (),
                   cache_len: int = 4096) -> list[tuple[str, Gemm, int]]:
    """A whole serving scenario: prefill seq sweep + decode step shapes.

    Identical (Gemm, name) rows across phases (e.g. lm_head in every
    prefill of a sweep) are merged with summed weights; distinct names
    over equal dims are left to the planner's content-addressed dedup.
    """
    out: list[tuple[str, Gemm, int]] = []
    for seq in prefill_seqs:
        out.extend(prefill_gemms(spec, seq))
    for batch in decode_batches:
        out.extend(decode_gemms(spec, batch, cache_len))
    return merge_gemm_rows(out)


def _mlp_chain_rows(spec: LlmSpec, m: int, name: str):
    """The MLP gate/up -> silu* -> down chain rows of one model phase.

    The attention chains (x -> QKV -> score) tie per-head slices of the
    projection output to the score GEMM's K — not a whole-operand
    producer-N / consumer-K tie — so only the MLP block is extracted as
    a fusable chain (DESIGN.md §Fusion)."""
    from .fusion import GemmChain
    ff, d = spec.d_ff, spec.d_model
    if spec.n_experts:
        m_exp = max(1, m * spec.top_k // spec.n_experts)
        n_mats = spec.n_experts + spec.shared_experts
        chain = GemmChain(
            producer=Gemm(m_exp, ff, d, "mlp_gate_up"),
            consumer=Gemm(m_exp, d, ff, "mlp_down"),
            producer_count=2, elementwise="silu_mul", name=name)
        return [("mlp_chain", chain, spec.layers * n_mats)]
    chain = GemmChain(
        producer=Gemm(m, ff, d, "mlp_gate_up"),
        consumer=Gemm(m, d, ff, "mlp_down"),
        producer_count=2, elementwise="silu_mul", name=name)
    return [("mlp_chain", chain, spec.layers)]


def prefill_chains(spec: LlmSpec, seq: int) -> list:
    """Fusable dependent-GEMM chains of one prefill: (type, chain, weight).

    The counterpart of ``prefill_gemms`` for the fusion-aware planner —
    currently the MLP block only (see ``_mlp_chain_rows``)."""
    return _mlp_chain_rows(spec, seq, f"{spec.name}_mlp_prefill{seq}")


def decode_chains(spec: LlmSpec, batch: int, cache_len: int) -> list:
    """Fusable chains of one batched decode step: (type, chain, weight).

    ``cache_len`` does not enter the MLP shapes; it is accepted for
    signature symmetry with ``decode_gemms``."""
    return _mlp_chain_rows(spec, batch, f"{spec.name}_mlp_decode{batch}")


def config_decode_chains(cfg, batch: int = 1) -> list:
    """Chains a ``fused_mlp``-routed model will actually *dispatch* in
    one decode/prefill-chunk step (the serving engine passes its *own*
    model config, so prewarmed chain shapes match dispatch by
    construction — smoke variants included).

    Only the gated dense-MLP block routes through the fused op
    (``models.layers.mlp_apply(use_fused=)``); MoE expert GEMMs go
    through ``moe_apply`` and recurrent families have no gated MLP, so
    those configs contribute none — prewarming chains a deployment
    never dispatches would just burn startup solves.  (Analytical MoE
    chain extraction for the planner/benchmarks lives in
    ``prefill_chains``/``decode_chains``/``mlp_chain``.)"""
    from .fusion import GemmChain
    if cfg.family not in ("dense", "vlm") or not cfg.d_ff or \
            cfg.n_experts or not cfg.mlp_layer_count():
        return []
    d, ff = cfg.d_model, cfg.d_ff
    chain = GemmChain(
        producer=Gemm(batch, ff, d, "mlp_gate_up"),
        consumer=Gemm(batch, d, ff, "mlp_down"),
        producer_count=2, elementwise="silu_mul",
        name=f"{cfg.name}_mlp_b{batch}")
    return [("mlp_chain", chain, cfg.mlp_layer_count())]


def arch_decode_chains(arch_id: str, batch: int = 1,
                       cache_len: int = 4096) -> list:
    """Dispatchable fused-MLP chains of one decode/prefill-chunk step
    for the repo's assigned architectures (a prefill chunk of width W
    flattens to the batch-W decode extraction; MoE/recurrent archs
    contribute none — see ``config_decode_chains``)."""
    from ..configs import get_config
    return config_decode_chains(get_config(arch_id), batch=batch)


def paper_cases() -> list[tuple[str, LlmSpec, int, str]]:
    """The 24 evaluation cases: (case_name, model, seq, hw_template)."""
    from .hardware import CENTER_TEMPLATES, EDGE_TEMPLATES
    cases = []
    for spec in EDGE_MODELS:
        for seq in EDGE_SEQ_LENS:
            for hw in EDGE_TEMPLATES:
                cases.append((f"{spec.name}({seq // 1024}k)@{hw}",
                              spec, seq, hw))
    for spec in CENTER_MODELS:
        for seq in CENTER_SEQ_LENS:
            for hw in CENTER_TEMPLATES:
                cases.append((f"{spec.name}({seq // 1024}k)@{hw}",
                              spec, seq, hw))
    return cases


def arch_gemms(arch_id: str, seq: int = 4096,
               batch: int = 1) -> list[tuple[str, Gemm, int]]:
    """GEMM extraction for the repo's assigned architectures.

    Attention-free blocks (RWKV6, Mamba2) contribute their projection
    GEMMs; their recurrent scans are not GEMMs and are handled by the
    dedicated kernels instead (DESIGN.md §Arch-applicability).
    """
    from ..configs import get_config
    cfg = get_config(arch_id)
    m = seq * batch
    L, d = cfg.layers, cfg.d_model
    out: list[tuple[str, Gemm, int]] = []
    n_attn = cfg.attention_layer_count()
    if n_attn:
        H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        out += [
            ("attn_q_proj", Gemm(m, H * hd, d, "attn_q_proj"), n_attn),
            ("attn_kv_proj", Gemm(m, KV * hd, d, "attn_kv_proj"), 2 * n_attn),
            ("attn_score", Gemm(m, seq, hd, "attn_score"), n_attn * H),
            ("attn_context", Gemm(m, hd, seq, "attn_context"), n_attn * H),
            ("attn_output", Gemm(m, d, H * hd, "attn_output"), n_attn),
        ]
    n_ssm = cfg.ssm_layer_count()
    if n_ssm:
        inner = cfg.ssm_inner_dim()
        out += [
            ("ssm_in_proj", Gemm(m, 2 * inner, d, "ssm_in_proj"), n_ssm),
            ("ssm_out_proj", Gemm(m, d, inner, "ssm_out_proj"), n_ssm),
        ]
    n_rwkv = cfg.rwkv_layer_count()
    if n_rwkv:
        out += [
            ("rwkv_time_mix", Gemm(m, d, d, "rwkv_time_mix"), 4 * n_rwkv),
            ("rwkv_channel_mix", Gemm(m, cfg.d_ff, d, "rwkv_channel_mix"),
             n_rwkv),
            ("rwkv_channel_out", Gemm(m, d, cfg.d_ff, "rwkv_channel_out"),
             n_rwkv),
        ]
    if cfg.n_experts:
        m_exp = max(1, m * cfg.top_k // cfg.n_experts)
        n_mats = cfg.n_experts + cfg.shared_experts
        out += [
            ("mlp_gate_up", Gemm(m_exp, cfg.d_ff, d, "mlp_gate_up"),
             2 * L * n_mats),
            ("mlp_down", Gemm(m_exp, d, cfg.d_ff, "mlp_down"), L * n_mats),
        ]
    elif not n_rwkv and cfg.d_ff:
        n_mlp = cfg.mlp_layer_count()
        out += [
            ("mlp_gate_up", Gemm(m, cfg.d_ff, d, "mlp_gate_up"), 2 * n_mlp),
            ("mlp_down", Gemm(m, d, cfg.d_ff, "mlp_down"), n_mlp),
        ]
    out.append(("lm_head", Gemm(1, cfg.vocab, d, "lm_head"), 1))
    return out


# ---------------------------------------------------------------------------
# PlanProgram shims: the hand enumerations above expressed in the unified
# planning IR (capture.program.PlanProgram).  These are the differential
# oracle for jaxpr capture — capturing the reference programs of a spec
# (capture.reference) must reproduce these multisets exactly — and the
# uniform input every planning consumer (CLI, batch planner, serving
# prewarm) lowers from.
# ---------------------------------------------------------------------------

def prefill_program(spec: LlmSpec, seq: int):
    """One prefill as a PlanProgram (GEMMs + fusable chains)."""
    from ..capture.program import PlanProgram
    return PlanProgram.from_rows(
        f"{spec.name}_prefill{seq}", prefill_gemms(spec, seq),
        prefill_chains(spec, seq))


def decode_program(spec: LlmSpec, batch: int, cache_len: int):
    """One batched decode step as a PlanProgram."""
    from ..capture.program import PlanProgram
    return PlanProgram.from_rows(
        f"{spec.name}_decode{batch}", decode_gemms(spec, batch, cache_len),
        decode_chains(spec, batch, cache_len))


def scenario_program(spec: LlmSpec, *, prefill_seqs: Sequence[int] = (),
                     decode_batches: Sequence[int] = (),
                     cache_len: int = 4096):
    """A whole serving scenario as a PlanProgram."""
    from ..capture.program import PlanProgram
    chains: list = []
    for seq in prefill_seqs:
        chains.extend(prefill_chains(spec, seq))
    for batch in decode_batches:
        chains.extend(decode_chains(spec, batch, cache_len))
    return PlanProgram.from_rows(
        f"{spec.name}_scenario",
        scenario_gemms(spec, prefill_seqs=prefill_seqs,
                       decode_batches=decode_batches, cache_len=cache_len),
        chains)


def arch_program(arch_id: str, seq: int = 4096, batch: int = 1):
    """One architecture prefill extraction as a PlanProgram (chains from
    the dispatchable fused-MLP set at M = seq * batch)."""
    from ..capture.program import PlanProgram
    from ..configs import get_config
    return PlanProgram.from_rows(
        f"{arch_id}_prefill{seq}", arch_gemms(arch_id, seq=seq, batch=batch),
        config_decode_chains(get_config(arch_id), batch=seq * batch))


def arch_decode_program(arch_id: str, batch: int = 1,
                        cache_len: int = 4096):
    """One architecture decode-step extraction as a PlanProgram."""
    from ..capture.program import PlanProgram
    return PlanProgram.from_rows(
        f"{arch_id}_decode{batch}",
        arch_decode_gemms(arch_id, batch=batch, cache_len=cache_len),
        arch_decode_chains(arch_id, batch=batch, cache_len=cache_len))


def arch_decode_gemms(arch_id: str, batch: int = 1,
                      cache_len: int = 4096) -> list[tuple[str, Gemm, int]]:
    """Decode-step GEMM extraction for the repo's architectures.

    Mirrors `arch_gemms` with M collapsed to the batch size (one token
    per sequence) and attention score/context run against the KV cache.
    Recurrent families (RWKV6, Mamba2) keep only their projections — the
    per-step state update is not a GEMM.
    """
    from ..configs import get_config
    cfg = get_config(arch_id)
    b, d = batch, cfg.d_model
    out: list[tuple[str, Gemm, int]] = []
    n_attn = cfg.attention_layer_count()
    if n_attn:
        H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        ctx = cache_len
        if cfg.window is not None and cfg.attn_every == 0 and \
                not cfg.alt_local_global:
            ctx = min(cache_len, cfg.window)
        out += [
            ("attn_q_proj", Gemm(b, H * hd, d, "attn_q_proj"), n_attn),
            ("attn_kv_proj", Gemm(b, KV * hd, d, "attn_kv_proj"), 2 * n_attn),
            ("attn_score", Gemm(b, ctx, hd, "attn_score"), n_attn * H),
            ("attn_context", Gemm(b, hd, ctx, "attn_context"), n_attn * H),
            ("attn_output", Gemm(b, d, H * hd, "attn_output"), n_attn),
        ]
    n_ssm = cfg.ssm_layer_count()
    if n_ssm:
        inner = cfg.ssm_inner_dim()
        out += [
            ("ssm_in_proj", Gemm(b, 2 * inner, d, "ssm_in_proj"), n_ssm),
            ("ssm_out_proj", Gemm(b, d, inner, "ssm_out_proj"), n_ssm),
        ]
    n_rwkv = cfg.rwkv_layer_count()
    if n_rwkv:
        out += [
            ("rwkv_time_mix", Gemm(b, d, d, "rwkv_time_mix"), 4 * n_rwkv),
            ("rwkv_channel_mix", Gemm(b, cfg.d_ff, d, "rwkv_channel_mix"),
             n_rwkv),
            ("rwkv_channel_out", Gemm(b, d, cfg.d_ff, "rwkv_channel_out"),
             n_rwkv),
        ]
    if cfg.n_experts:
        m_exp = max(1, b * cfg.top_k // cfg.n_experts)
        n_mats = cfg.n_experts + cfg.shared_experts
        out += [
            ("mlp_gate_up", Gemm(m_exp, cfg.d_ff, d, "mlp_gate_up"),
             2 * cfg.layers * n_mats),
            ("mlp_down", Gemm(m_exp, d, cfg.d_ff, "mlp_down"),
             cfg.layers * n_mats),
        ]
    elif not n_rwkv and cfg.d_ff:
        n_mlp = cfg.mlp_layer_count()
        out += [
            ("mlp_gate_up", Gemm(b, cfg.d_ff, d, "mlp_gate_up"), 2 * n_mlp),
            ("mlp_down", Gemm(b, d, cfg.d_ff, "mlp_down"), n_mlp),
        ]
    out.append(("lm_head", Gemm(b, cfg.vocab, d, "lm_head"), 1))
    return out
