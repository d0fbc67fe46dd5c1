"""deepseek-v2-lite [moe, latent attention]: 27L d_model=2048 16H,
MLA (no q-LoRA, kv_lora_rank 512, qk_nope 128 + qk_rope 64, v 128, YaRN
rope), one dense first layer (d_ff 10944), then 26 MoE layers of 64
routed experts (d_ff 1408, top-6, softmax, weights not renormalised) and
2 shared; vocab 102400, untied [arXiv:2405.04434; hf
deepseek-ai/DeepSeek-V2-Lite config.json].

A port-only configuration: ``configs/base.py`` and ``configs/__init__.py``
are copies of the reference's and hold no latent attention, so the
published settings that ``ArchConfig`` lacks live in ``MLAConfig``, and
the model (``models/mla.py``, ``models/model.py``) recognises it by type.
The family stays "moe", which the continuous scheduler serves; the
experts run the dropless dispatch (``models/moe.py``).
"""
from __future__ import annotations

import dataclasses

from .base import ArchConfig


@dataclasses.dataclass(frozen=True)
class MLAConfig(ArchConfig):
    """``ArchConfig`` with multi-head latent attention and leading dense
    layers.  ``head_dim`` is the query/key head size (nope + rope) and
    ``d_ff`` the routed experts' width."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # YaRN (rope_scaling of config.json)
    rope_factor: float = 40.0
    rope_original_max: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    # layers before the first MoE layer, with a dense gated MLP of this
    # width (first_k_dense_replace, intermediate_size)
    first_dense_layers: int = 1
    dense_d_ff: int = 10944
    # the routed experts' top-k weights: renormalised or not, then scaled
    norm_topk_prob: bool = False
    routed_scale: float = 1.0

    @property
    def moe_layers(self) -> int:
        return self.layers - self.first_dense_layers


CONFIG = MLAConfig(
    name="deepseek-v2-lite", family="moe", layers=27, d_model=2048,
    n_heads=16, kv_heads=16, head_dim=192, d_ff=1408, vocab=102400,
    n_experts=64, top_k=6, shared_experts=2, rope_theta=10000.0,
    moe_dispatch="dropless", fused_mlp=True,
    param_dtype="float32", compute_dtype="bfloat16",
)

