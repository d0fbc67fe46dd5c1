"""DeepSeek-V2 (the dsv2lite cells' model) in plain PyTorch, in the
published, expanded form: the reference that decides ``correct``.

Per layer: RMSNorm; multi-head latent attention (no q-LoRA): q = x W_q
split into q_nope and q_pe, [c_kv | k_pe] = x W_kva, c_kv RMSNormed,
[k_nope | v] = c_kv W_kvb per head, k_pe shared by the heads; YaRN
rotary embedding on q_pe and k_pe as the published modeling code applies
it (interleaved pairs regrouped into halves, then rotated as halves;
cos and sin times mscale / mscale_all_dim); scores (q_nope k_nope + q_pe
k_pe) times (nope + rope)^-1/2 times mscale(factor, mscale_all_dim)^2,
causal softmax, then v and W_o; RMSNorm; then the dense gated MLP (the
first ``first_k_dense_replace`` layers) or the mixture of experts: an
fp32 softmax router over the routed experts, the top-k weights
renormalised only if ``norm_topk_prob``, times ``routed_scaling_factor``,
each expert a gated SiLU MLP run on exactly the tokens routed to it (a
loop over the experts, nothing dropped), the weighted outputs summed
over each token's choices, plus the shared experts as one gated MLP of
their summed width.  A final RMSNorm and an untied head.

Everything is fp32 with TF32 off (``dense.exact``), a layer's weights
upcast once and run over every sequence, attention blocked by query
rows so that long sequences fit.  It reads the benchmark's weights
(``harness/weights_mla.py``) and keeps nothing of the port's state; it
imports nothing of the port.  The configuration file's ``departures``
list where the port departs from the published model; this reference
follows the port there.

``fp8=True`` is the control: every product of an activation with a
weight (the attention projections, the dense MLP, every expert, the
shared experts and the head; not the router) takes its operands rounded
to float8 e4m3 with one scale per tensor, as ``dense.linear`` does.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .dense import exact, linear  # noqa: F401  (exact: the callers' switch)

F32 = torch.float32
Q_BLOCK = 1024      # query rows a block of the attention's scores


@dataclasses.dataclass(frozen=True)
class Spec:
    layers: int
    dense_layers: int
    d: int
    heads: int
    nope: int
    rope: int
    vd: int
    rank: int
    dense_ff: int
    ff: int
    experts: int
    top_k: int
    shared: int
    vocab: int
    theta: float
    factor: float
    original_max: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float
    eps: float
    norm_topk: bool
    routed_scale: float

    @classmethod
    def of(cls, cfg: dict) -> "Spec":
        rs = cfg["rope_scaling"]
        return cls(
            layers=cfg["num_hidden_layers"],
            dense_layers=cfg["first_k_dense_replace"],
            d=cfg["hidden_size"], heads=cfg["num_attention_heads"],
            nope=cfg["qk_nope_head_dim"], rope=cfg["qk_rope_head_dim"],
            vd=cfg["v_head_dim"], rank=cfg["kv_lora_rank"],
            dense_ff=cfg["intermediate_size"],
            ff=cfg["moe_intermediate_size"],
            experts=cfg["n_routed_experts"],
            top_k=cfg["num_experts_per_tok"],
            shared=cfg["n_shared_experts"], vocab=cfg["vocab_size"],
            theta=float(cfg["rope_theta"]), factor=float(rs["factor"]),
            original_max=rs["original_max_position_embeddings"],
            beta_fast=float(rs["beta_fast"]),
            beta_slow=float(rs["beta_slow"]), mscale=float(rs["mscale"]),
            mscale_all_dim=float(rs["mscale_all_dim"]),
            eps=float(cfg["run"]["norm_eps"]),
            norm_topk=bool(cfg["norm_topk_prob"]),
            routed_scale=float(cfg["routed_scaling_factor"]))


# ------------------------------------------------------------------ YaRN
def yarn_get_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def correction_dims(spec: Spec) -> tuple[int, int]:
    """yarn_find_correction_range of the modeling code."""
    def dim_of(rot):
        return (spec.rope * math.log(spec.original_max / (rot * 2 * math.pi))
                / (2 * math.log(spec.theta)))
    low = math.floor(dim_of(spec.beta_fast))
    high = math.ceil(dim_of(spec.beta_slow))
    return max(low, 0), min(high, spec.rope - 1)


def inv_freq(spec: Spec, device=None) -> torch.Tensor:
    dim = spec.rope
    freq_extra = 1.0 / (spec.theta ** (
        torch.arange(0, dim, 2, dtype=F32, device=device) / dim))
    freq_inter = 1.0 / (spec.factor * spec.theta ** (
        torch.arange(0, dim, 2, dtype=F32, device=device) / dim))
    low, high = correction_dims(spec)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=F32, device=device)
                        - low) / (high - low), 0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def softmax_scale(spec: Spec) -> float:
    m = yarn_get_mscale(spec.factor, spec.mscale_all_dim)
    return (spec.nope + spec.rope) ** -0.5 * m * m


def rope(x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """x (S, H, rope) at positions 0..S-1, as apply_rotary_pos_emb."""
    S, H, d = x.shape
    freqs = torch.outer(torch.arange(S, dtype=F32, device=x.device),
                        inv_freq(spec, x.device))
    m = (yarn_get_mscale(spec.factor, spec.mscale)
         / yarn_get_mscale(spec.factor, spec.mscale_all_dim))
    emb = torch.cat([freqs, freqs], -1)
    cos, sin = (emb.cos() * m)[:, None], (emb.sin() * m)[:, None]
    x = x.reshape(S, H, d // 2, 2).transpose(-1, -2).reshape(S, H, d)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + rot * sin


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, spec: Spec):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + spec.eps) * scale


# ------------------------------------------------------------- the layer
def attention(x: torch.Tensor, w: dict, spec: Spec, fp8: bool):
    """Latent attention over one sequence x (S, d), causal."""
    S = x.shape[0]
    H = spec.heads
    q = linear(x, w["attn/wq/w"], fp8).reshape(S, H, spec.nope + spec.rope)
    q_nope, q_pe = q[..., :spec.nope], q[..., spec.nope:]
    kva = linear(x, w["attn/wkv_a/w"], fp8)
    c = rmsnorm(kva[:, :spec.rank], w["attn/kv_norm/scale"], spec)
    k_pe = kva[:, None, spec.rank:]
    kv = linear(c, w["attn/wkv_b/w"], fp8).reshape(S, H, spec.nope + spec.vd)
    k_nope, v = kv[..., :spec.nope], kv[..., spec.nope:]
    q = torch.cat([q_nope, rope(q_pe, spec)], -1).transpose(0, 1)
    k = torch.cat([k_nope, rope(k_pe, spec).expand(S, H, spec.rope)],
                  -1).transpose(0, 1)                          # (H, S, 192)
    v = v.transpose(0, 1)
    scale = softmax_scale(spec)
    out = []
    for r0 in range(0, S, Q_BLOCK):
        r1 = min(S, r0 + Q_BLOCK)
        s = (q[:, r0:r1] @ k[:, :r1].transpose(1, 2)) * scale
        mask = (torch.arange(r1, device=x.device)[None, :]
                <= torch.arange(r0, r1, device=x.device)[:, None])
        s = s.masked_fill(~mask, float("-inf"))
        out.append(torch.softmax(s, -1) @ v[:, :r1])
    o = torch.cat(out, 1).transpose(0, 1).reshape(S, H * spec.vd)
    return linear(o, w["attn/wo/w"], fp8)


def gated(x, wg, wu, wd, fp8):
    return linear(F.silu(linear(x, wg, fp8)) * linear(x, wu, fp8), wd, fp8)


def experts(x: torch.Tensor, w: dict, spec: Spec, fp8: bool):
    """The mixture of experts over token rows x (T, d)."""
    probs = torch.softmax(x @ w["moe/router/w"], -1)
    top_w, top_i = torch.topk(probs, spec.top_k, dim=-1)
    if spec.norm_topk:
        top_w = top_w / top_w.sum(-1, keepdim=True)
    top_w = top_w * spec.routed_scale
    outs = x.new_zeros((x.shape[0], spec.top_k, spec.d))
    for e in range(spec.experts):
        tok, choice = (top_i == e).nonzero(as_tuple=True)
        if tok.numel():
            outs[tok, choice] = gated(x[tok], w["moe/wg"][e], w["moe/wu"][e],
                                      w["moe/wd"][e], fp8)
    y = (outs * top_w[..., None]).sum(1)
    if spec.shared:
        y = y + gated(x, w["moe/shared/wg/w"], w["moe/shared/wu/w"],
                      w["moe/shared/wd/w"], fp8)
    return y, probs, top_i


def layer(xs: list, w: dict, spec: Spec, fp8: bool = False):
    """One layer over sequences xs (each (S, d)); returns (xs, the MoE's
    (probs, top_i) over all their rows, or None)."""
    xs = [x + attention(rmsnorm(x, w["ln1/scale"], spec), w, spec, fp8)
          for x in xs]
    hs = torch.cat([rmsnorm(x, w["ln2/scale"], spec) for x in xs])
    if "moe/router/w" in w:
        y, probs, top_i = experts(hs, w, spec, fp8)
        routed = (probs, top_i)
    else:
        y = gated(hs, w["mlp/wg/w"], w["mlp/wu/w"], w["mlp/wd/w"], fp8)
        routed = None
    ys = y.split([x.shape[0] for x in xs])
    return [x + yi for x, yi in zip(xs, ys)], routed


def _leaves(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def layer_weights(params: dict, i: int, spec: Spec) -> dict:
    """Layer ``i`` (the dense ones first) in fp32 copies."""
    stack, j = (("dense_layers", i) if i < spec.dense_layers
                else ("layers", i - spec.dense_layers))
    return {k: v[j].to(F32) for k, v in _leaves(params[stack]).items()}


def head(x: torch.Tensor, params: dict, spec: Spec, fp8: bool):
    h = rmsnorm(x, params["final_norm"]["scale"].to(F32), spec)
    return linear(h, params["lm_head"]["w"].to(F32), fp8)


@torch.no_grad()
def served_logits(params: dict, spec: Spec, seqs: list, rows: list, *,
                  control: bool = False):
    """Logits (len(rows[i]), vocab) of each sequence ``seqs[i]`` (1-D
    int64 on the weights' device) at positions ``rows[i]``, from one full
    causal forward, layer by layer; with ``control`` also the fp8
    control's."""
    emb = params["embed"]["e"]
    xs = [emb[s].to(F32) for s in seqs]
    x8 = [x.clone() for x in xs] if control else None
    for i in range(spec.layers):
        w = layer_weights(params, i, spec)
        xs, _ = layer(xs, w, spec)
        if control:
            x8, _ = layer(x8, w, spec, fp8=True)
        del w

    def heads(xl, fp8):
        return [head(x[r], params, spec, fp8) for x, r in zip(xl, rows)]
    return heads(xs, False), (heads(x8, True) if control else None)


def loss(params: dict, batch: dict, spec: Spec) -> torch.Tensor:
    """Mean next-token NLL over labels >= 0 of a (B, S) batch, plus 0.01 x
    the MoE layers' summed Switch load-balancing loss (the port's
    training loss; a departure listed in the configuration file)."""
    tokens, labels = batch["tokens"], batch["labels"]
    emb = params["embed"]["e"].to(F32)
    xs = [emb[t] for t in tokens]
    aux = torch.zeros((), dtype=F32, device=emb.device)
    for i in range(spec.layers):
        xs, routed = layer(xs, layer_weights(params, i, spec), spec)
        if routed is not None:
            probs, top_i = routed
            f = F.one_hot(top_i, spec.experts).sum(1).to(F32).mean(0)
            aux = aux + spec.experts * (f * probs.mean(0)).sum() / spec.top_k
    logits = head(torch.stack(xs), params, spec, False)
    logp = torch.log_softmax(logits, -1)
    valid = (labels >= 0).to(F32)
    nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum().clamp(min=1.0) + 0.01 * aux
