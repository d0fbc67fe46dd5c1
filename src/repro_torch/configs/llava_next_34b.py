"""llava-next-34b [vlm]: yi-34b backbone (60L d_model=7168 56H kv=8
d_ff=20480 vocab=64000) + anyres patch-embedding STUB
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

The vision tower is a stub per the assignment: input_specs supplies
precomputed patch embeddings (B, patches, d_model); anyres tiling at
672x672 / 14px patches with 5 tiles -> 2880 patch positions."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm", layers=60, d_model=7168,
    n_heads=56, kv_heads=8, head_dim=128, d_ff=20480, vocab=64000,
    rope_theta=5000000.0, frontend="patches", frontend_len=2880,
    param_dtype="float32", compute_dtype="bfloat16",
)
