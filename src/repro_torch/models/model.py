"""Model assembly for the dense decoder family (the counterpart of the
reference's ``models/model.py``).

Parameters keep the reference's pytree layout, with the layer stack on
axis 0 of every ``params["layers"]`` leaf; the stack runs as a Python
loop over the layers.  Entry points are functions of (params, batch[,
cache]) as in the reference.  Other families (MoE, RWKV, SSM, hybrid,
encoder-decoder, VLM), sliding windows and softcaps come with later
slices of the port and raise here.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..configs.base import ArchConfig
from . import layers as L

# the dense projection weights: the reference casts them to the compute
# dtype at every use (layers.dense), the port once when they are made
DENSE_WEIGHTS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                 ("attn", "wo"), ("mlp", "wg"), ("mlp", "wu"),
                 ("mlp", "wd"))


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
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the port serves the dense family only so "
                f"far, not {cfg.family!r}")
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
        unit norm scales.  Dense projection weights are made in the
        compute dtype, the rest in the parameter dtype."""
        cfg = self.cfg
        pdt, cdt = L.dtype_of(cfg.param_dtype), L.dtype_of(cfg.compute_dtype)
        n, d = cfg.layers, cfg.d_model

        def normal(shape, std, dtype):
            return torch.empty(shape, dtype=dtype, device=device).normal_(
                0.0, std, generator=generator)

        def proj(d_in, d_out):
            return {"w": normal((n, d_in, d_out), 1.0 / math.sqrt(d_in),
                                cdt)}

        def norm(shape):
            return {"scale": torch.ones(shape, dtype=pdt, device=device)}

        hq, hkv = cfg.n_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
        p = {"embed": {"e": normal((cfg.padded_vocab, d), 0.02, pdt)},
             "final_norm": norm((d,)),
             "layers": {
                 "ln1": norm((n, d)),
                 "attn": {"wq": proj(d, hq), "wk": proj(d, hkv),
                          "wv": proj(d, hkv), "wo": proj(hq, d)},
                 "ln2": norm((n, d)),
                 "mlp": {"wg": proj(d, cfg.d_ff), "wu": proj(d, cfg.d_ff),
                         "wd": proj(cfg.d_ff, d)}}}
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
    def _forward_stack(self, params, x, positions, *, caches=None,
                       cache_index=None):
        """Run the layers in order; caches: {"k", "v"} stacked on axis 0
        (updated in place) or None."""
        cfg = self.cfg
        for i in range(cfg.layers):
            lp = index_tree(params["layers"], i)
            cache = (None if caches is None
                     else {"k": caches["k"][i], "v": caches["v"][i]})
            h, _ = L.attention_apply(
                lp["attn"], L.apply_norm(lp["ln1"], x, cfg.norm),
                n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                q_positions=positions, cache=cache, cache_index=cache_index)
            x = x + h
            h = L.mlp_apply(lp["mlp"], L.apply_norm(lp["ln2"], x, cfg.norm),
                            use_fused=cfg.fused_mlp)
            x = x + h
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
        ``index`` is one scalar write position shared by all rows.
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
        cfg = self.cfg
        shape = (cfg.layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
        dt = L.dtype_of(cfg.compute_dtype)
        return {"layers": {"k": torch.zeros(shape, dtype=dt, device=device),
                           "v": torch.zeros(shape, dtype=dt, device=device)}}


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
