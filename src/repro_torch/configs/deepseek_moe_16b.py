"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16) d_ff=1408(expert)
vocab=102400; 2 shared + 64 routed experts, top-6 (fine-grained)
[arXiv:2401.06066; hf].

Simplification noted in DESIGN.md: the original's dense first layer is
modeled as MoE like the rest (uniform scan stack)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe", layers=28, d_model=2048,
    n_heads=16, kv_heads=16, head_dim=128, d_ff=1408, vocab=102400,
    n_experts=64, top_k=6, shared_experts=2,
    param_dtype="float32", compute_dtype="bfloat16",
)
