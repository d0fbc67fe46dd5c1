"""zamba2-2.7b [hybrid]: 54L Mamba2 d_model=2560 + shared attention block
(32H kv=32, d_ff=10240), ssm_state=64, vocab=32000 [arXiv:2411.15242; hf].

One weight-shared attention+MLP block is applied every 6 Mamba2 layers
(9 applications).  Sub-quadratic: runs long_500k."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", layers=54, d_model=2560,
    n_heads=32, kv_heads=32, head_dim=80, d_ff=10240, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6,
    param_dtype="float32", compute_dtype="bfloat16",
    notes="Mamba2 + shared attn blocks; decode state = SSM + 9 KV caches",
)
