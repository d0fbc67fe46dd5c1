"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 [arXiv:2408.00118; hf].

Local(4096-window)/global alternating attention, logit softcap 30,
attention softcap 50, embedding scaled by sqrt(d_model)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b", family="dense", layers=46, d_model=4608,
    n_heads=32, kv_heads=16, head_dim=128, d_ff=36864, vocab=256000,
    window=4096, alt_local_global=True,
    logit_softcap=30.0, attn_softcap=50.0,
    param_dtype="float32", compute_dtype="bfloat16",
)
