"""seamless-m4t-medium [audio enc-dec]: 12L enc + 12L dec, d_model=1024,
16H (kv=16), d_ff=4096, vocab=256206 [arXiv:2308.11596; hf].

The speech frontend is a STUB per the assignment: input_specs supplies
precomputed frame embeddings (B, frames, d_model)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec", layers=12,
    encoder_layers=12, d_model=1024, n_heads=16, kv_heads=16, head_dim=64,
    d_ff=4096, vocab=256206, frontend="frames", frontend_len=1024,
    param_dtype="float32", compute_dtype="bfloat16",
    notes="multimodal enc-dec; frame-embedding stub frontend",
)
