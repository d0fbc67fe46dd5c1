"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155; 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe", layers=24, d_model=1024,
    n_heads=16, kv_heads=8, head_dim=64, d_ff=512, vocab=49155,
    n_experts=32, top_k=8, shared_experts=0,
    param_dtype="float32", compute_dtype="bfloat16",
)
