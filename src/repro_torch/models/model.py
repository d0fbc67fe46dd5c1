"""Model assembly for the dense, RWKV-6, Mamba2 and Mamba2-hybrid
families (the counterpart of the reference's ``models/model.py``).

Parameters keep the reference's pytree layout, with the layer stack on
axis 0 of every ``params["layers"]`` leaf; the stack runs as a Python
loop over the layers.  The hybrid (zamba2) applies one weight-shared
attention+MLP block after every ``attn_every`` Mamba2 layers, with a KV
cache per application.  Entry points are functions of (params, batch[,
cache]) as in the reference.  The MoE, encoder-decoder and VLM families,
sliding windows and softcaps come with later slices of the port and
raise here.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..configs.base import ArchConfig
from . import layers as L
from . import rwkv as RW
from . import ssm as SSM

# the projection weights by family, as key paths from the root of the
# parameter tree: the reference casts them to the compute dtype at every
# use (layers.dense), the port once when they are made or converted
_ATTN_MLP = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
             ("mlp", "wg"), ("mlp", "wu"), ("mlp", "wd"))
_SSM = (("layers", "ssm", "in_proj"), ("layers", "ssm", "out_proj"))
PROJECTIONS = {
    "dense": tuple(("layers",) + w for w in _ATTN_MLP),
    "rwkv": tuple(("layers", "time", w)
                  for w in ("wr", "wk", "wv", "wg", "ww", "wo"))
    + tuple(("layers", "chan", w) for w in ("wk", "wv", "wr")),
    "ssm": _SSM,
    "hybrid": _SSM + tuple(("shared_block",) + w for w in _ATTN_MLP),
}


def index_tree(tree: dict, i: int) -> dict:
    """Every leaf of a stacked tree indexed at axis 0 (views, no copies):
    one layer's parameters."""
    return {k: index_tree(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def tree_to(params: dict, device) -> dict:
    """The same parameter tree on another device."""
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in params.items()}


@dataclasses.dataclass
class Model:
    cfg: ArchConfig

    def __post_init__(self):
        cfg = self.cfg
        if cfg.family not in PROJECTIONS:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family!r} family is not ported yet "
                f"(the port serves {', '.join(PROJECTIONS)}; moe, encdec "
                f"and vlm come later)")
        if cfg.window or cfg.alt_local_global or cfg.attn_softcap or \
                cfg.logit_softcap:
            raise NotImplementedError(
                f"{cfg.name}: sliding windows and softcaps are not ported "
                f"yet")

    # ------------------------------------------------------------ init
    def init_params(self, generator: torch.Generator,
                    device: str | torch.device = "cuda") -> dict:
        """Random weights made on ``device`` from ``generator`` (which
        must live on that device), with the reference's scales: normal
        projections with std 1/sqrt(d_in), embeddings with std 0.02,
        unit norm scales; RWKV mixes 0.5, bonus 0 and decay bias -6;
        Mamba2 conv taps with std 1/sqrt(K), A_log 0, D 1, dt_bias 0.
        Projection weights are made in the compute dtype, the bonus,
        decay bias, A_log, D and dt_bias in fp32, the rest in the
        parameter dtype."""
        cfg = self.cfg
        pdt, cdt = L.dtype_of(cfg.param_dtype), L.dtype_of(cfg.compute_dtype)
        f32 = torch.float32
        n, d = cfg.layers, cfg.d_model

        def normal(shape, std, dtype):
            return torch.empty(shape, dtype=dtype, device=device).normal_(
                0.0, std, generator=generator)

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=device)

        def proj(d_in, d_out, lead=(n,)):
            return {"w": normal(lead + (d_in, d_out), 1.0 / math.sqrt(d_in),
                                cdt)}

        def norm(shape):
            return {"scale": full(shape, 1.0, pdt)}

        def attn_mlp(lead):
            hq = cfg.n_heads * cfg.head_dim
            hkv = cfg.kv_heads * cfg.head_dim
            return {"ln1": norm(lead + (d,)),
                    "attn": {"wq": proj(d, hq, lead), "wk": proj(d, hkv, lead),
                             "wv": proj(d, hkv, lead),
                             "wo": proj(hq, d, lead)},
                    "ln2": norm(lead + (d,)),
                    "mlp": {"wg": proj(d, cfg.d_ff, lead),
                            "wu": proj(d, cfg.d_ff, lead),
                            "wd": proj(cfg.d_ff, d, lead)}}

        p = {"embed": {"e": normal((cfg.padded_vocab, d), 0.02, pdt)},
             "final_norm": norm((d,))}
        fam = cfg.family
        if fam == "dense":
            p["layers"] = attn_mlp((n,))
        elif fam == "rwkv":
            nh, hd = RW.rwkv_dims(cfg)
            p["layers"] = {
                "ln1": norm((n, d)),
                "time": {"mix": full((n, 5, d), 0.5, pdt),
                         **{w: proj(d, d)
                            for w in ("wr", "wk", "wv", "wg", "ww", "wo")},
                         "u": full((n, nh, hd), 0.0, f32),
                         "w_bias": full((n, d), -6.0, f32)},
                "ln2": norm((n, d)),
                "chan": {"mix": full((n, 2, d), 0.5, pdt),
                         "wk": proj(d, cfg.d_ff), "wv": proj(cfg.d_ff, d),
                         "wr": proj(d, d)}}
        else:   # ssm, hybrid
            d_inner, nh, hd, ns = SSM.ssm_dims(cfg)
            K = cfg.conv_kernel
            p["layers"] = {
                "ln": norm((n, d)),
                "ssm": {"in_proj": proj(d, 2 * d_inner + 2 * ns + nh),
                        "conv_w": normal((n, K, d_inner + 2 * ns),
                                         1.0 / math.sqrt(K), pdt),
                        "A_log": full((n, nh), 0.0, f32),
                        "D": full((n, nh), 1.0, f32),
                        "dt_bias": full((n, nh), 0.0, f32),
                        "out_proj": proj(d_inner, d)}}
            if fam == "hybrid":
                p["shared_block"] = attn_mlp(())
        if not cfg.tie_embeddings:
            w = normal((d, cfg.padded_vocab), 1.0 / math.sqrt(d), pdt)
            p["lm_head"] = {"w": w}
        return p

    # ----------------------------------------------------------- embed
    def _embed_in(self, params, tokens):
        x = L.embed(params["embed"], tokens)
        return x.to(L.dtype_of(self.cfg.compute_dtype))

    def _lm_logits(self, params, x):
        cfg = self.cfg
        x = L.apply_norm(params["final_norm"], x, cfg.norm)
        w = (params["embed"]["e"].T if cfg.tie_embeddings
             else params["lm_head"]["w"])
        ldt = L.dtype_of(cfg.logits_dtype)
        if ldt != torch.float32:
            logits = x.to(ldt) @ w.to(ldt)
        else:
            logits = x.to(torch.float32) @ w.to(torch.float32)
        if cfg.padded_vocab != cfg.vocab:
            # mask the pad rows out of the softmax
            pad = torch.arange(cfg.padded_vocab, device=logits.device)
            logits = logits + torch.where(pad < cfg.vocab, 0.0, -1e9)
        return logits

    # ------------------------------------------------------ layer stack
    def _attn_block(self, lp, x, positions, *, cache=None, cache_index=None):
        """Pre-norm attention and gated MLP with residuals: a dense layer,
        or the hybrid's shared block.  ``cache`` {"k", "v"} is updated in
        place."""
        cfg = self.cfg
        h, _ = L.attention_apply(
            lp["attn"], L.apply_norm(lp["ln1"], x, cfg.norm),
            n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            q_positions=positions, cache=cache, cache_index=cache_index)
        x = x + h
        h = L.mlp_apply(lp["mlp"], L.apply_norm(lp["ln2"], x, cfg.norm),
                        use_fused=cfg.fused_mlp)
        return x + h

    def _forward_stack(self, params, x, positions, *, caches=None,
                       cache_index=None):
        """Run the layers in order.  caches: the model's layer caches
        (``init_cache(...)["layers"]``), updated in place, or None.  With
        ``cache_index`` None (a prefill) the recurrent layers start from
        a zero state and shift and their caches are only written: a
        fresh cache's zeros are passed down as None, so the scans can
        take their kernels (B3, B4), as ``use_pallas_scan`` means."""
        fam = self.cfg.family
        if fam == "dense":
            for i in range(self.cfg.layers):
                cache = (None if caches is None
                         else {"k": caches["k"][i], "v": caches["v"][i]})
                x = self._attn_block(index_tree(params["layers"], i), x,
                                     positions, cache=cache,
                                     cache_index=cache_index)
            return x
        if fam == "rwkv":
            return self._rwkv_stack(params, x, caches, cache_index)
        return self._ssm_stack(params, x, positions, caches, cache_index)

    def _rwkv_stack(self, params, x, caches, cache_index):
        cfg = self.cfg
        decode = cache_index is not None
        for i in range(cfg.layers):
            lp = index_tree(params["layers"], i)
            carry = (index_tree(caches, i) if caches is not None and decode
                     else {})
            h, (state, tshift) = RW.rwkv_time_apply(
                lp["time"], cfg, L.apply_norm(lp["ln1"], x, cfg.norm),
                state=carry.get("state"), shift=carry.get("tshift"),
                decode=decode)
            x = x + h
            h, cshift = RW.rwkv_channel_apply(
                lp["chan"], cfg, L.apply_norm(lp["ln2"], x, cfg.norm),
                shift=carry.get("cshift"))
            x = x + h
            if caches is not None:
                caches["state"][i].copy_(state)
                caches["tshift"][i].copy_(tshift)
                caches["cshift"][i].copy_(cshift)
        return x

    def _ssm_stack(self, params, x, positions, caches, cache_index):
        """Mamba2 layers in groups of ``attn_every``; in the hybrid, the
        shared block after each group, with that group's KV cache."""
        cfg = self.cfg
        period = cfg.attn_every if cfg.family == "hybrid" else cfg.layers
        shared = params.get("shared_block")
        decode = cache_index is not None
        for g in range(cfg.layers // period):
            for j in range(period):
                lp = index_tree(params["layers"], g * period + j)
                state = conv = None
                if caches is not None and decode:
                    state = caches["ssm"]["state"][g, j]
                    conv = caches["ssm"]["conv"][g, j]
                h, (state, conv) = SSM.ssm_apply(
                    lp["ssm"], cfg, L.apply_norm(lp["ln"], x, cfg.norm),
                    state=state, conv_state=conv, decode=decode)
                x = x + h
                if caches is not None:
                    caches["ssm"]["state"][g, j].copy_(state)
                    caches["ssm"]["conv"][g, j].copy_(conv)
            if shared is not None:
                cache = (None if caches is None
                         else {"k": caches["attn"]["k"][g],
                               "v": caches["attn"]["v"][g]})
                x = self._attn_block(shared, x, positions, cache=cache,
                                     cache_index=cache_index)
        return x

    # --------------------------------------------------------- serving
    def prefill(self, params, batch, max_len: int):
        """Returns (last-token logits (B, 1, V), cache)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        caches = self.init_cache(B, max_len, device=tokens.device)
        x = self._embed_in(params, tokens)
        pos = torch.arange(S, device=tokens.device)
        x = self._forward_stack(params, x, pos, caches=caches["layers"])
        return self._lm_logits(params, x[:, -1:]), caches

    def decode_step(self, params, cache, tokens, index: int):
        """One cache-resident step: tokens (B, S) written at
        [index, index + S) with causal attention over cache and chunk;
        ``index`` is one scalar write position shared by all rows.  The
        recurrent families take S == 1, as in the reference.
        Returns (logits (B, S, V), cache), the cache updated in place."""
        B, S = tokens.shape
        x = self._embed_in(params, tokens)
        pos = (int(index) + torch.arange(S, device=tokens.device)
               )[None].expand(B, S)
        x = self._forward_stack(params, x, pos, caches=cache["layers"],
                                cache_index=int(index))
        return self._lm_logits(params, x), cache

    def init_cache(self, batch: int, max_len: int,
                   device: str | torch.device = "cuda") -> dict:
        """Zeroed caches in the reference's layout: KV caches stacked on
        the layer axis (dense) or on the group axis (the hybrid's shared
        block); RWKV state and shift carries on the layer axis; Mamba2
        states and conv carries on (group, layer in group)."""
        cfg = self.cfg
        dt = L.dtype_of(cfg.compute_dtype)
        f32 = torch.float32
        n = cfg.layers

        def zeros(shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=device)

        def kv(n_layers):
            shape = (n_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
            return {"k": zeros(shape), "v": zeros(shape)}

        if cfg.family == "dense":
            return {"layers": kv(n)}
        if cfg.family == "rwkv":
            nh, hd = RW.rwkv_dims(cfg)
            return {"layers": {
                "state": zeros((n, batch, nh, hd, hd), f32),
                "tshift": zeros((n, batch, 1, cfg.d_model)),
                "cshift": zeros((n, batch, 1, cfg.d_model))}}
        period = cfg.attn_every if cfg.family == "hybrid" else n
        groups = n // period
        d_inner, nh, hd, ns = SSM.ssm_dims(cfg)
        out = {"ssm": {
            "state": zeros((groups, period, batch, nh, hd, ns), f32),
            "conv": zeros((groups, period, batch, cfg.conv_kernel - 1,
                           d_inner + 2 * ns))}}
        if cfg.family == "hybrid":
            out["attn"] = kv(groups)
        return {"layers": out}


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
