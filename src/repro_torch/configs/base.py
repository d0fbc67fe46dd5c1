"""Architecture configuration schema + input-shape sets.

One ``ArchConfig`` per assigned architecture lives in
``src/repro/configs/<id>.py`` with the exact dimensions from the
assignment; each also provides a ``smoke()`` reduced config of the same
family for CPU tests.  The four assignment shapes are defined here.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


# The assignment's LM shapes (seq_len x global_batch).
SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | rwkv | encdec | vlm
    layers: int                 # decoder layers (or total LM layers)
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # MoE
    n_experts: int = 0
    top_k: int = 0
    shared_experts: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0         # zamba2: shared attn block period
    # attention details
    window: int | None = None   # sliding-window size (local layers)
    alt_local_global: bool = False
    logit_softcap: float | None = None
    attn_softcap: float | None = None
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    # encoder-decoder
    encoder_layers: int = 0
    # modality frontend stub: None | "frames" (audio) | "patches" (vision)
    frontend: str | None = None
    frontend_len: int = 0       # prefix length supplied by the stub
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # misc
    tie_embeddings: bool = False
    conv_kernel: int = 4
    ssd_chunk: int = 128
    notes: str = ""
    # --- §Perf knobs (EXPERIMENTS.md) ---------------------------------
    # pad the vocab so embedding/lm_head shard over TP even for odd
    # vocabs (e.g. 256206); padded logit rows are masked in the loss
    vocab_pad_multiple: int = 1
    # cast the (fp32-master) scanned layer stacks to compute_dtype
    # before the scan: FSDP all-gathers move bf16 instead of fp32
    gather_in_compute_dtype: bool = False
    # remat policy: "full" recomputes everything; "dots" saves matmul
    # outputs (jax dots_with_no_batch_dims_saveable) trading memory for
    # a smaller recompute flops term
    remat_policy: str = "full"
    # compute the lm_head matmul and store logits in this dtype (the loss
    # upcasts to f32 inside log_softmax); "bfloat16" halves the largest
    # activation tensor of big-vocab models
    logits_dtype: str = "float32"
    # route the RWKV6/Mamba2 chunked scans through the Pallas kernels
    # (kernels/wkv6.py, kernels/mamba2_ssd.py); interpret mode off-TPU
    use_pallas_scan: bool = False
    # MoE dispatch: "dense" (one-hot, static, E/top_k redundant compute)
    # or "gathered" (sort-based capacity buckets, §Perf hillclimb B3)
    moe_dispatch: str = "dense"
    # route gated-MLP blocks through the GOMA-chain-planned fused Pallas
    # kernel (kernels/goma_fused.py): gate/up -> silu* -> down with the
    # intermediate strip held in VMEM scratch; interpret mode off-TPU.
    # Token-identical to the unfused composition (DESIGN.md §Fusion).
    fused_mlp: bool = False

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    # ---- derived ----------------------------------------------------------
    def attention_layer_count(self) -> int:
        if self.family == "rwkv":
            return 0
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            return self.layers // max(self.attn_every, 1)
        if self.family == "encdec":
            return self.layers + self.encoder_layers  # + cross handled apart
        return self.layers

    def ssm_layer_count(self) -> int:
        if self.family == "ssm":
            return self.layers
        if self.family == "hybrid":
            return self.layers
        return 0

    def rwkv_layer_count(self) -> int:
        return self.layers if self.family == "rwkv" else 0

    def mlp_layer_count(self) -> int:
        if self.family == "rwkv":
            return 0
        if self.family == "hybrid":
            return self.layers // max(self.attn_every, 1)  # shared block MLP
        if self.family == "encdec":
            return self.layers + self.encoder_layers
        if self.family == "ssm":
            return 0
        return self.layers

    def ssm_inner_dim(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (see DESIGN.md)."""
        return self.family in ("rwkv", "ssm", "hybrid")

    def shapes(self) -> list[ShapeSpec]:
        out = [SHAPES["train_4k"], SHAPES["prefill_32k"],
               SHAPES["decode_32k"]]
        if self.sub_quadratic:
            out.append(SHAPES["long_500k"])
        return out

    def skipped_shapes(self) -> list[tuple[str, str]]:
        if self.sub_quadratic:
            return []
        return [("long_500k", "full-attention architecture: 500k dense-KV "
                 "decode requires sub-quadratic attention (DESIGN.md "
                 "§Arch-applicability)")]

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
