"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 [arXiv:2407.21783; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b", family="dense", layers=32, d_model=4096,
    n_heads=32, kv_heads=8, head_dim=128, d_ff=14336, vocab=128256,
    rope_theta=500000.0,
    param_dtype="float32", compute_dtype="bfloat16",
)
