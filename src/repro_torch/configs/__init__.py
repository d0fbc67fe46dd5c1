"""Architecture registry: the 10 assigned architectures (+ smoke variants).

    from repro_torch.configs import get_config, ARCHS
    cfg = get_config("llama3-8b")            # full assignment config
    cfg = get_config("llama3-8b", smoke=True)  # reduced CPU-testable config
"""
from __future__ import annotations

from .base import SHAPES, ArchConfig, ShapeSpec
from .deepseek_moe_16b import CONFIG as DEEPSEEK_MOE_16B
from .gemma2_27b import CONFIG as GEMMA2_27B
from .granite_moe_1b import CONFIG as GRANITE_MOE_1B
from .llama3_8b import CONFIG as LLAMA3_8B
from .llava_next_34b import CONFIG as LLAVA_NEXT_34B
from .rwkv6_7b import CONFIG as RWKV6_7B
from .seamless_m4t_medium import CONFIG as SEAMLESS_M4T_MEDIUM
from .stablelm_1_6b import CONFIG as STABLELM_1_6B
from .yi_34b import CONFIG as YI_34B
from .zamba2_2_7b import CONFIG as ZAMBA2_2_7B

ARCHS: dict[str, ArchConfig] = {c.name: c for c in (
    RWKV6_7B, SEAMLESS_M4T_MEDIUM, ZAMBA2_2_7B, STABLELM_1_6B, LLAMA3_8B,
    YI_34B, GEMMA2_27B, DEEPSEEK_MOE_16B, GRANITE_MOE_1B, LLAVA_NEXT_34B,
)}


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config: small layers/width/experts/vocab."""
    kw = dict(
        layers=4 if cfg.family in ("ssm", "hybrid") else 2,
        d_model=64, d_ff=128, vocab=257,
        n_heads=4, kv_heads=max(1, 4 * cfg.kv_heads // max(cfg.n_heads, 1)),
        head_dim=16, ssm_head_dim=16, ssm_state=16 if cfg.ssm_state else 0,
        ssd_chunk=8, param_dtype="float32", compute_dtype="float32",
    )
    if cfg.family == "rwkv":
        kw["d_model"] = 128  # rwkv head size is fixed at 64
        kw["d_ff"] = 256
    if cfg.n_experts:
        kw["n_experts"] = 4
        kw["top_k"] = 2
        kw["shared_experts"] = min(cfg.shared_experts, 1)
    if cfg.attn_every:
        kw["attn_every"] = 2
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
    if cfg.window:
        kw["window"] = 8
    if cfg.frontend_len:
        kw["frontend_len"] = 6
    return cfg.replace(name=cfg.name + "-smoke", **kw)


def get_config(name: str, *, smoke: bool = False) -> ArchConfig:
    cfg = ARCHS[name]
    return smoke_config(cfg) if smoke else cfg


__all__ = ["ARCHS", "ArchConfig", "SHAPES", "ShapeSpec", "get_config",
           "smoke_config"]
