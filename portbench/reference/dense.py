"""A dense pre-norm decoder in plain PyTorch: the reference of the
yi-34b and stablelm-1.6b cells.

Embedding, RMSNorm or LayerNorm, rotary embedding over the whole head
(the half-split "rotate half" form), causal grouped-query attention with
a plain softmax, the SwiGLU MLP (silu(x Wg) * (x Wu)) Wd, a final norm
and an untied head; the next-token loss is the mean NLL from an fp32
log-softmax over the labels >= 0; AdamW is the textbook update with
global-norm clipping.  Everything is fp32 with TF32 off (``exact``).
The configuration file states each place where the port departs from
the published model, and this reference follows the port there, so that
a comparison measures arithmetic and not a known departure.

It reads the benchmark's weights in their layout (``layers/attn/wq/w``
stacked on the layer axis), upcast to fp32 a layer at a time, and keeps
nothing the port made.

``fp8=True`` is the control: every product of an activation with a
weight (the seven projections and the head) takes its operands rounded
to float8 e4m3 with one scale per tensor (its amax onto 448), and in the
backward the incoming gradient rounded to e5m2 (amax onto 57344): the
step below the configurations' bf16 that would tempt a later change.
Attention's own products stay in fp32.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
FP8_MAX = {E4M3: 448.0, E5M2: 57344.0}


def exact() -> None:
    """fp32 products in fp32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor, fmt=E4M3) -> torch.Tensor:
    """``x`` rounded to float8 ``fmt`` under one per-tensor scale, back in
    fp32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX[fmt]
    return (x / scale).to(fmt).to(F32) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_fp8(g, E5M2)
        return qg @ qb.T, qa.T @ qg


def linear(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """x (..., k) @ w (k, n)."""
    if not fp8:
        return x @ w
    lead = x.shape[:-1]
    return _Fp8Matmul.apply(x.reshape(-1, x.shape[-1]), w).reshape(
        *lead, w.shape[1])


@dataclasses.dataclass(frozen=True)
class Spec:
    layers: int
    d: int
    heads: int
    kv: int
    hd: int
    ff: int
    vocab: int
    theta: float
    norm: str
    eps: float

    @classmethod
    def of(cls, cfg: dict) -> "Spec":
        d, h = cfg["hidden_size"], cfg["num_attention_heads"]
        run = cfg["run"]
        return cls(layers=cfg["num_hidden_layers"], d=d, heads=h,
                   kv=cfg["num_key_value_heads"],
                   hd=cfg.get("head_dim") or d // h,
                   ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                   theta=float(cfg["rope_theta"]), norm=run["norm"],
                   eps=float(run["norm_eps"]))


def norm(x: torch.Tensor, scale, bias, spec: Spec) -> torch.Tensor:
    if spec.norm == "rmsnorm":
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                               + spec.eps) * scale
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + spec.eps) * scale + bias


def rope(x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """x (B, S, H, hd) at positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / spec.theta ** (torch.arange(0, hd, 2, device=x.device,
                                            dtype=F32) / hd)
    ang = torch.arange(S, device=x.device, dtype=F32)[:, None] * inv
    ang = torch.cat([ang, ang], -1)[None, :, None, :]
    half = hd // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * torch.cos(ang) + rot * torch.sin(ang)


def attention(q, k, v, spec: Spec) -> torch.Tensor:
    """Causal grouped-query attention, one sequence at a time:
    q (B, S, H, hd), k and v (B, S, KV, hd); query head h reads key head
    h // (H / KV)."""
    g = spec.heads // spec.kv
    S = q.shape[1]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    outs = []
    for b in range(q.shape[0]):
        qb = q[b].transpose(0, 1)                               # (H, S, hd)
        kb = k[b].transpose(0, 1).repeat_interleave(g, 0)
        vb = v[b].transpose(0, 1).repeat_interleave(g, 0)
        s = (qb @ kb.transpose(1, 2)) / math.sqrt(spec.hd)
        s = s.masked_fill(~mask, float("-inf"))
        outs.append((torch.softmax(s, -1) @ vb).transpose(0, 1))
    return torch.stack(outs)


LAYER_KEYS = ("ln1/scale", "ln1/bias", "attn/wq/w", "attn/wk/w",
              "attn/wv/w", "attn/wo/w", "ln2/scale", "ln2/bias",
              "mlp/wg/w", "mlp/wu/w", "mlp/wd/w")


def layer(x: torch.Tensor, w: dict, spec: Spec, fp8: bool = False):
    """One decoder layer on x (B, S, d); ``w`` maps LAYER_KEYS to fp32
    tensors (the biases None under RMSNorm)."""
    B, S, _ = x.shape
    h = norm(x, w["ln1/scale"], w["ln1/bias"], spec)
    q = rope(linear(h, w["attn/wq/w"], fp8).reshape(B, S, spec.heads,
                                                      spec.hd), spec)
    k = rope(linear(h, w["attn/wk/w"], fp8).reshape(B, S, spec.kv,
                                                      spec.hd), spec)
    v = linear(h, w["attn/wv/w"], fp8).reshape(B, S, spec.kv, spec.hd)
    a = attention(q, k, v, spec).reshape(B, S, spec.heads * spec.hd)
    x = x + linear(a, w["attn/wo/w"], fp8)
    h = norm(x, w["ln2/scale"], w["ln2/bias"], spec)
    g = linear(h, w["mlp/wg/w"], fp8)
    u = linear(h, w["mlp/wu/w"], fp8)
    return x + linear(F.silu(g) * u, w["mlp/wd/w"], fp8)


def _get(tree: dict, path: str):
    for k in path.split("/"):
        if k not in tree:
            return None
        tree = tree[k]
    return tree


def layer_weights(params: dict, i: int) -> dict:
    """Layer ``i``'s weights from the benchmark's tree, in fp32 copies."""
    out = {}
    for key in LAYER_KEYS:
        t = _get(params["layers"], key)
        out[key] = None if t is None else t[i].to(F32)
    return out


@torch.no_grad()
def served_logits(params: dict, spec: Spec, seqs: list, rows: list, *,
                  control: bool = False):
    """Logits (len(rows[i]), vocab) of each sequence ``seqs[i]`` (1-D
    int64 tensors on the weights' device) at positions ``rows[i]``, from
    one full causal forward, layer by layer: each layer's weights are
    upcast once and run over every sequence.  With ``control`` also the
    fp8 control's logits of the same rows."""
    emb = params["embed"]["e"]
    xs = [emb[s].to(F32)[None] for s in seqs]
    x8 = [x.clone() for x in xs] if control else None
    for i in range(spec.layers):
        w = layer_weights(params, i)
        xs = [layer(x, w, spec) for x in xs]
        if control:
            x8 = [layer(x, w, spec, fp8=True) for x in x8]
        del w

    def head(xl, fp8):
        fn = params["final_norm"]
        fb = fn.get("bias")
        out = []
        for x, r in zip(xl, rows):
            h = norm(x[0, r], fn["scale"].to(F32),
                     None if fb is None else fb.to(F32), spec)
            out.append(linear(h, params["lm_head"]["w"].to(F32), fp8))
        return out

    return head(xs, False), (head(x8, True) if control else None)


# ------------------------------------------------------------- training
def flat(params: dict) -> dict:
    """{path: tensor} of every leaf of a benchmark tree."""
    out = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[f"{prefix}{k}"] = v
    walk(params, "")
    return out


def loss(p: dict, batch: dict, spec: Spec, fp8: bool = False):
    """Mean next-token NLL over labels >= 0; ``p`` is ``flat``'s dict of
    fp32 leaves.  Each layer is recomputed in the backward."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = p["embed/e"][tokens]
    stacked = {k: p.get(f"layers/{k}") for k in LAYER_KEYS}
    parts = {k: (None if v is None else v.unbind(0))
             for k, v in stacked.items()}
    keys = [k for k in LAYER_KEYS if parts[k] is not None]

    def body(x, *ws):
        w = dict.fromkeys(LAYER_KEYS)
        w.update(zip(keys, ws))
        return layer(x, w, spec, fp8)

    for i in range(spec.layers):
        x = checkpoint(body, x, *[parts[k][i] for k in keys],
                       use_reentrant=False)
    h = norm(x, p["final_norm/scale"], p.get("final_norm/bias"), spec)
    logits = linear(h, p["lm_head/w"], fp8)
    logp = torch.log_softmax(logits.to(F32), -1)
    valid = (labels >= 0).to(F32)
    nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum().clamp(min=1.0)


def learning_rate(job: dict, step: int) -> float:
    """Linear warmup over ``warmup_steps``, then cosine decay to
    ``min_lr_frac`` of ``lr`` at ``total_steps``; ``step`` counts from 0."""
    warm = min((step + 1) / job["warmup_steps"], 1.0)
    prog = min(max((step - job["warmup_steps"])
                   / max(job["total_steps"] - job["warmup_steps"], 1), 0.0),
               1.0)
    cos = job["min_lr_frac"] + (1 - job["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return job["lr"] * warm * cos


def train(params: dict, batches: list, spec: Spec, job: dict, *,
          fp8: bool = False) -> dict:
    """``len(batches)`` AdamW steps from ``params`` (left as they are).
    Returns each step's loss, every leaf's norm of the first step's
    clipped gradient, and every leaf's norm of the change after the last
    step."""
    p0 = {k: v.detach().to(F32) for k, v in flat(params).items()}
    p = {k: v.clone().requires_grad_() for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p0.items()}
    b1, b2 = job["beta1"], job["beta2"]
    losses, grad_norms = [], None
    for t, batch in enumerate(batches):
        value = loss(p, batch, spec, fp8)
        value.backward()
        torch.nn.utils.clip_grad_norm_(list(p.values()), job["grad_clip"])
        lr = learning_rate(job, t)
        with torch.no_grad():
            if grad_norms is None:
                grad_norms = {k: float(x.grad.norm()) for k, x in p.items()}
            for k, x in p.items():
                g = x.grad
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = m[k] / (1 - b1 ** (t + 1))
                vhat = v2[k] / (1 - b2 ** (t + 1))
                upd = mhat / (vhat.sqrt() + job["eps"])
                if x.ndim >= 2:
                    upd = upd + job["weight_decay"] * x
                x.sub_(lr * upd)
                x.grad = None
        losses.append(float(value.detach()))
    with torch.no_grad():
        change = {k: float((p[k] - p0[k]).norm()) for k in p}
    return {"losses": losses, "grad_norms": grad_norms, "change": change}
