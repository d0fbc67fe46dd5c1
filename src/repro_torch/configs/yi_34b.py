"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[arXiv:2403.04652; hf] — llama-architecture GQA."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b", family="dense", layers=60, d_model=7168,
    n_heads=56, kv_heads=8, head_dim=128, d_ff=20480, vocab=64000,
    rope_theta=5000000.0,
    param_dtype="float32", compute_dtype="bfloat16",
)
