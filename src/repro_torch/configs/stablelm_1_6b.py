"""stablelm-1.6b [dense]: 24L d_model=2048 32H (kv=32) d_ff=5632
vocab=100352 [hf:stabilityai/stablelm-2-1_6b; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b", family="dense", layers=24, d_model=2048,
    n_heads=32, kv_heads=32, head_dim=64, d_ff=5632, vocab=100352,
    norm="layernorm",
    param_dtype="float32", compute_dtype="bfloat16",
)
