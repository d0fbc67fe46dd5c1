"""rwkv6-7b [ssm/attn-free]: 32L d_model=4096 d_ff=14336 vocab=65536.

RWKV-6 "Finch" — data-dependent decay linear attention [arXiv:2404.05892;
hf].  Attention-free: runs the long_500k shape (O(1)-state decode)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="rwkv", layers=32, d_model=4096,
    n_heads=64, kv_heads=64, head_dim=64,      # wkv head size 64
    d_ff=14336, vocab=65536,
    param_dtype="float32", compute_dtype="bfloat16",
    notes="attn-free; wkv state (H,64,64) per layer; token-shift carries",
)
