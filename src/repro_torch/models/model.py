"""Model assembly for every family of the catalog: dense (gemma2's
local/global alternation and softcaps included), MoE, RWKV-6, Mamba2,
Mamba2-hybrid, encoder-decoder and VLM (the counterpart of the
reference's ``models/model.py``).

Parameters keep the reference's pytree layout, with the layer stack on
axis 0 of every ``params["layers"]`` (and ``params["encoder"]``) leaf;
the stack runs as a Python loop over the layers.  An MoE layer is a
dense layer whose MLP is the mixture of experts (``moe.py``).  A
latent-attention model (``configs.deepseek_v2_lite.MLAConfig``, family
"moe") keeps its leading dense layers in ``params["dense_layers"]`` and
its MoE layers in ``params["layers"]``, each with multi-head latent
attention (``mla.py``), and one latent cache over all of them.  The
hybrid (zamba2) applies one weight-shared attention+MLP block after
every ``attn_every`` Mamba2 layers, with a KV cache per application.
The VLM is the dense stack over a prefix of patch embeddings in front of
the prompt; the encoder-decoder encodes frame embeddings (non-causal
self-attention) and decodes with causal self-attention, then
cross-attention to the encoder's output, then the MLP.  The frontends
are stubs, as in the reference: the caller supplies the patches or
frames.  Entry points are functions of (params, batch[, cache]) as in
the reference.

Training: ``loss`` is the reference's masked next-token loss, with each
layer body rematerialized under ``remat`` (``torch.utils.checkpoint``,
or a selective checkpoint that keeps the matmul outputs under the
config's ``remat_policy="dots"``), and ``init_params(masters=True)``
makes every leaf in the parameter dtype, as the reference's optimizer
keeps them.  The kernels have no backward: a loss through the fused MLP
or the scan kernels raises under grad, as ``jax.grad`` fails through the
reference's Pallas kernels, and runs under ``torch.no_grad()``.

Sharded (``dist.serve.shard_model``): ``tp`` runs a rank's share of the
Megatron layout over the mesh's model axis (``parallel.py``), and
``fsdp``, where installed, holds each leaf split over its data axis too
(``dist.fsdp``): each layer body gathers its own leaves inside the
rematerialized body, so the backward's recompute gathers them again; the
embedding, the final norm and the LM head are gathered where a pass uses
them.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import SHAPES, ArchConfig, ShapeSpec
from ..configs.deepseek_v2_lite import MLAConfig
from ..sharding.rules import map_with_paths
from . import layers as L
from . import mla as MLA
from . import moe as MOE
from . import rwkv as RW
from . import ssm as SSM
from .parallel import TensorParallel

# the projection weights by family, as key paths from the root of the
# parameter tree: the reference casts them to the compute dtype at every
# use (layers.dense), the port once when they are made or converted.  The
# MoE family's expert banks and shared experts are not among them: the
# reference upcasts those to fp32 at every use, the port stores them in
# the compute dtype and upcasts them per layer call in the dense and
# gathered dispatches (moe.py, convert.py)
_ATTN = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"))
_ATTN_MLP = _ATTN + (("mlp", "wg"), ("mlp", "wu"), ("mlp", "wd"))
_SSM = (("layers", "ssm", "in_proj"), ("layers", "ssm", "out_proj"))
_XATTN = tuple(("xattn",) + w[1:] for w in _ATTN)
PROJECTIONS = {
    "dense": tuple(("layers",) + w for w in _ATTN_MLP),
    "vlm": tuple(("layers",) + w for w in _ATTN_MLP),
    "encdec": tuple(("encoder",) + w for w in _ATTN_MLP)
    + tuple(("layers",) + w for w in _ATTN_MLP + _XATTN),
    "moe": tuple(("layers",) + w for w in _ATTN),
    "rwkv": tuple(("layers", "time", w)
                  for w in ("wr", "wk", "wv", "wg", "ww", "wo"))
    + tuple(("layers", "chan", w) for w in ("wk", "wv", "wr")),
    "ssm": _SSM,
    "hybrid": _SSM + tuple(("shared_block",) + w for w in _ATTN_MLP),
}

# the products remat_policy="dots" keeps (jax's
# dots_with_no_batch_dims_saveable): 2-D matmuls, which every projection
# lowers to; batched products (attention's einsums, the experts) are
# recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def index_tree(tree: dict, i: int) -> dict:
    """Every leaf of a stacked tree indexed at axis 0 (views, no copies):
    one layer's parameters."""
    return {k: index_tree(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def unbind_tree(tree: dict) -> list[dict]:
    """Every layer's parameters of a stacked tree: each leaf unbound once
    on axis 0 (views, no copies).  Under autograd one unbind's backward
    writes the stacked gradient once; indexing every layer
    (``index_tree``) would fill a zero stacked gradient a layer and add
    them up."""
    parts = {k: unbind_tree(v) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def tree_to(params: dict, device) -> dict:
    """The same parameter tree on another device."""
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in params.items()}


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    # the tensor-parallel layout this model runs on (dist.serve's
    # shard_model installs it); None on one device
    tp: TensorParallel | None = dataclasses.field(default=None, repr=False,
                                                  compare=False)
    # the FSDP layout over the mesh's data axis (dist.fsdp's
    # FullyShardedData, which shard_model installs with mode="fsdp"); None
    # where every data rank holds its TP-local leaves whole
    fsdp: object = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.cfg.family not in PROJECTIONS:
            raise ValueError(f"unknown family {self.cfg.family}")

    # ------------------------------------------------------------ init
    def init_params(self, generator: torch.Generator,
                    device: str | torch.device = "cuda", *,
                    masters: bool = False) -> dict:
        """Random weights made on ``device`` from ``generator`` (which
        must live on that device), with the reference's scales: normal
        projections with std 1/sqrt(d_in), embeddings with std 0.02,
        unit norm scales (zero biases for layernorm); RWKV mixes 0.5,
        bonus 0 and decay bias -6;
        Mamba2 conv taps with std 1/sqrt(K), A_log 0, D 1, dt_bias 0.
        Projection weights, expert banks and shared experts are made in
        the compute dtype, the MoE router, the bonus, decay bias, A_log,
        D and dt_bias in fp32, the rest in the parameter dtype.  With
        ``masters`` (training) the projections, banks and shared experts
        are made in the parameter dtype too, as the reference keeps every
        leaf, and every use casts them (``layers.dense``, the fused MLP,
        the experts' upcast).

        On a tensor-parallel model each leaf is drawn whole and at once
        cut to this rank's slice (``tp.place``, then ``fsdp.place``), so
        the whole tensor is freed before the next one is drawn: a rank's
        peak stays near its shard plus the largest tensor.  The draws
        come in the same order either way, so every rank's slices come
        from one device's weights."""
        cfg = self.cfg
        pdt, cdt = L.dtype_of(cfg.param_dtype), L.dtype_of(cfg.compute_dtype)
        if masters:
            cdt = pdt
        f32 = torch.float32
        n, d = cfg.layers, cfg.d_model
        place = self.tp.place if self.tp is not None else None
        if self.fsdp is not None:
            place = lambda path, t: self.fsdp.place(path,
                                                    self.tp.place(path, t))

        # each leaf is a thunk until the tree is complete; the tree is
        # then made leaf by leaf in its insertion order, which is the
        # order the thunks were written in
        def normal(shape, std, dtype):
            return lambda: torch.empty(shape, dtype=dtype,
                                       device=device).normal_(
                0.0, std, generator=generator)

        def full(shape, value, dtype):
            return lambda: torch.full(shape, value, dtype=dtype,
                                      device=device)

        def proj(d_in, d_out, lead=(n,)):
            return {"w": normal(lead + (d_in, d_out), 1.0 / math.sqrt(d_in),
                                cdt)}

        def norm(shape):
            if cfg.norm == "layernorm":
                return {"scale": full(shape, 1.0, pdt),
                        "bias": full(shape, 0.0, pdt)}
            return {"scale": full(shape, 1.0, pdt)}

        def attn(lead):
            hq = cfg.n_heads * cfg.head_dim
            hkv = cfg.kv_heads * cfg.head_dim
            return {"wq": proj(d, hq, lead), "wk": proj(d, hkv, lead),
                    "wv": proj(d, hkv, lead), "wo": proj(hq, d, lead)}

        def attn_mlp(lead, moe=False, cross=False):
            lp = {"ln1": norm(lead + (d,)), "attn": attn(lead),
                  "ln2": norm(lead + (d,))}
            if cross:
                lp["lnx"] = norm(lead + (d,))
                lp["xattn"] = attn(lead)
            if moe:
                lp["moe"] = MOE.moe_init(normal, cfg, lead, cdt)
            else:
                lp["mlp"] = {"wg": proj(d, cfg.d_ff, lead),
                             "wu": proj(d, cfg.d_ff, lead),
                             "wd": proj(cfg.d_ff, d, lead)}
            return lp

        def mla_layers(lead, moe):
            lp = {"ln1": norm(lead + (d,)),
                  "attn": MLA.mla_init(normal, full, cfg, lead, cdt, pdt),
                  "ln2": norm(lead + (d,))}
            if moe:
                lp["moe"] = MOE.moe_init(normal, cfg, lead, cdt)
            else:
                lp["mlp"] = {"wg": proj(d, cfg.dense_d_ff, lead),
                             "wu": proj(d, cfg.dense_d_ff, lead),
                             "wd": proj(cfg.dense_d_ff, d, lead)}
            return lp

        p = {"embed": {"e": normal((cfg.padded_vocab, d), 0.02, pdt)},
             "final_norm": norm((d,))}
        fam = cfg.family
        if isinstance(cfg, MLAConfig):
            p["dense_layers"] = mla_layers((cfg.first_dense_layers,), False)
            p["layers"] = mla_layers((cfg.moe_layers,), True)
        elif fam in ("dense", "moe", "vlm"):
            p["layers"] = attn_mlp((n,), moe=fam == "moe")
        elif fam == "encdec":
            p["encoder"] = attn_mlp((cfg.encoder_layers,))
            p["layers"] = attn_mlp((n,), cross=True)
            p["enc_norm"] = norm((d,))
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
        if place is None:
            return map_with_paths(lambda path, make: make(), p)
        return map_with_paths(lambda path, make: place(path, make()), p)

    # ----------------------------------------------------------- embed
    def _embed_in(self, params, tokens, prefix=None):
        """Token embeddings (gemma2's scaled by sqrt(d_model) in the
        embedding's dtype), behind the frontend's ``prefix`` (B, P, d)
        when one is given, in the compute dtype.  With the vocabulary
        split over TP ranks, each rank looks up the tokens of its rows
        (zeros elsewhere) and one all_reduce sums the ranks' lookups,
        exactly."""
        cfg = self.cfg
        tp = self.tp
        embed = self._whole(params["embed"], "embed")
        if tp is not None and tp.embed_split:
            e = embed["e"]
            rows = tokens - tp.index * e.shape[0]
            mine = (rows >= 0) & (rows < e.shape[0])
            x = tp.all_reduce(torch.where(
                mine[..., None], e[rows.clamp(0, e.shape[0] - 1)], 0))
        else:
            x = L.embed(embed, tokens)
        if cfg.name.startswith("gemma2"):
            # the scale rounded to the embedding's dtype, as the reference
            # takes it
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
        if prefix is not None:
            x = torch.cat([prefix.to(x.dtype), x], dim=1)
        return x.to(L.dtype_of(cfg.compute_dtype))

    def _lm_logits(self, params, x):
        cfg = self.cfg
        x = L.apply_norm(self._whole(params["final_norm"], "final_norm"), x,
                         cfg.norm)
        head = "embed" if cfg.tie_embeddings else "lm_head"
        w = self._whole(params[head], head)
        w = w["e"].T if cfg.tie_embeddings else w["w"]
        # the vocab-split head is a split region: its input's gradient is
        # summed over the ranks
        x = self._enter(x, "embed/e" if cfg.tie_embeddings else "lm_head/w")
        ldt = L.dtype_of(cfg.logits_dtype)
        if ldt != torch.float32:
            logits = x.to(ldt) @ w.to(ldt)
        else:
            logits = x.to(torch.float32) @ w.to(torch.float32)
        tp = self.tp
        if tp is not None and tp.head_split:
            # the ranks' vocab columns gathered exactly: each writes its
            # own into zeros, and the all_reduce sums them
            logits = tp.gather_columns(logits, cfg.padded_vocab)
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * torch.tanh(
                logits / cfg.logit_softcap)
        if cfg.padded_vocab != cfg.vocab:
            # mask the pad rows out of the softmax
            pad = torch.arange(cfg.padded_vocab, device=logits.device)
            logits = logits + torch.where(pad < cfg.vocab, 0.0, -1e9)
        return logits

    # ------------------------------------------------------ layer stack
    def _heads(self, block: str) -> dict:
        """The head counts the attention at ``block`` (a parameter path
        such as "layers/attn") runs: a tensor-parallel rank's share."""
        cfg = self.cfg
        if self.tp is None:
            return dict(n_heads=cfg.n_heads, kv_heads=cfg.kv_heads)
        return self.tp.heads[block]

    def _reduce(self, x: torch.Tensor, path: str) -> torch.Tensor:
        """The output of the projection at ``path``, summed over the
        tensor-parallel ranks where that projection is split by rows."""
        return x if self.tp is None else self.tp.reduce(x, path)

    def _enter(self, x: torch.Tensor, path: str) -> torch.Tensor:
        """``x`` entering the split region that the projection at
        ``path`` closes (``TensorParallel.enter``: its gradient summed
        over the ranks in the backward)."""
        return x if self.tp is None else self.tp.enter(x, path)

    def _enterer(self, path: str):
        """``_enter`` at ``path`` as a function, or None without TP."""
        return None if self.tp is None else (
            lambda x: self.tp.enter(x, path))

    def _layers(self, params, key: str) -> list[dict]:
        """Every layer's parameters of the stack at ``key`` (views): under
        FSDP each layer's local parts, which the body gathers
        (``_whole``)."""
        if self.fsdp is None:
            return unbind_tree(params[key])
        return self.fsdp.layer_parts(key, params[key])

    def _whole(self, tree: dict, prefix: str, layer: int | None = None):
        """The whole (TP-local) parameters of the subtree at ``prefix``:
        under FSDP gathered over the data axis (layer ``layer`` of a
        stack from its parts), else ``tree`` itself."""
        if self.fsdp is None:
            return tree
        if layer is None:
            return self.fsdp.gather_tree(prefix, tree)
        return self.fsdp.gather_layer(prefix, tree, layer)

    def _ckpt(self, fn):
        """``fn`` rematerialized in training: under grad its activations
        are recomputed in the backward instead of kept (the reference's
        ``jax.checkpoint``); with ``remat_policy="dots"`` the matmul
        outputs are kept and the rest recomputed.  Without grad (serving,
        the loss under ``no_grad``) ``fn`` runs as it is."""
        kw = {}
        if self.cfg.remat_policy == "dots":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _save_dots)

        def run(*args):
            if not torch.is_grad_enabled():
                return fn(*args)
            return checkpoint(fn, *args, use_reentrant=False, **kw)
        return run

    def _attn_block(self, lp, x, positions, *, block="layers", layer=None,
                    window_flag=None, cache=None, cache_index=None,
                    remat=False, data_mean=None, angles=None):
        """Pre-norm attention and gated MLP (or mixture of experts) with
        residuals: a dense, VLM or MoE layer, or the hybrid's shared
        block (``block`` is the path of its parameters).  The config's
        window applies unless ``window_flag`` is False (a global layer
        of an alternating stack), and its attention softcap to every
        layer.  ``cache`` {"k", "v"} is updated in place.  Returns (x,
        aux): the MoE layer's load-balancing loss, None for the others.
        On a tensor-parallel rank the attention runs the rank's heads and
        the MLP its share of d_ff (the MoE its experts), and one
        all_reduce after each sums the partial outputs.  With ``remat``
        the block is rematerialized (``_ckpt``; training passes no
        cache).  ``layer``: the index of a stacked layer (its parameters
        are gathered inside the body under FSDP).  ``angles``: a
        latent-attention pass's rope angles (``mla.rope_angles``)."""
        cfg = self.cfg

        def body(lp, x):
            lp = self._whole(lp, block, layer)
            y = L.apply_norm(lp["ln1"], x, cfg.norm)
            if isinstance(cfg, MLAConfig):
                h = MLA.mla_apply(lp["attn"], cfg, y, positions,
                                  cache=cache, cache_index=cache_index,
                                  angles=angles)
            else:
                h, _ = L.attention_apply(
                    lp["attn"], y, **self._heads(f"{block}/attn"),
                    head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                    q_positions=positions, causal=True, window=cfg.window,
                    window_active=window_flag, softcap=cfg.attn_softcap,
                    cache=cache, cache_index=cache_index,
                    enter=self._enterer(f"{block}/attn/wo/w"))
            x = x + self._reduce(h, f"{block}/attn/wo/w")
            y = L.apply_norm(lp["ln2"], x, cfg.norm)
            if "moe" in lp:
                h, aux = MOE.moe_apply(lp["moe"], cfg, y, tp=self.tp,
                                       data_mean=data_mean)
            else:
                h, aux = self._reduce(L.mlp_apply(
                    lp["mlp"], self._enter(y, f"{block}/mlp/wd/w"),
                    use_fused=cfg.fused_mlp), f"{block}/mlp/wd/w"), None
            return x + h, aux
        return (self._ckpt(body) if remat else body)(lp, x)

    def _forward_stack(self, params, x, positions, *, caches=None,
                       cache_index=None, remat=False, data_mean=None):
        """Run the layers in order.  caches: the model's layer caches
        (``init_cache(...)["layers"]``), updated in place, or None.  With
        ``cache_index`` None (a prefill) the recurrent layers start from
        a zero state and shift and their caches are only written: a
        fresh cache's zeros are passed down as None, so the scans can
        take their kernels (B3, B4), as ``use_pallas_scan`` means.
        Returns (x, aux): the sum of the MoE layers' load-balancing
        losses (0 for the other families), as the reference's scan sums
        them.  ``remat`` rematerializes each layer body;
        ``data_mean`` (the mean over the data ranks) takes the MoE loss
        over the global batch (a training loss on data ranks)."""
        cfg = self.cfg
        fam = cfg.family
        aux = x.new_zeros((), dtype=torch.float32)
        if isinstance(cfg, MLAConfig):
            return self._mla_stack(params, x, positions, caches,
                                   cache_index, remat, data_mean, aux)
        if fam in ("dense", "moe", "vlm"):
            for i, lp in enumerate(self._layers(params, "layers")):
                cache = (None if caches is None
                         else {"k": caches["k"][i], "v": caches["v"][i]})
                # gemma2's alternation: even layers local, odd global
                wf = (i % 2 == 0) if cfg.alt_local_global else None
                x, a = self._attn_block(
                    lp, x, positions, layer=i,
                    window_flag=wf, cache=cache, cache_index=cache_index,
                    remat=remat, data_mean=data_mean)
                if a is not None:
                    aux = aux + a
            return x, aux
        if fam == "rwkv":
            return self._rwkv_stack(params, x, caches, cache_index,
                                    remat), aux
        return self._ssm_stack(params, x, positions, caches, cache_index,
                               remat), aux

    def _mla_stack(self, params, x, positions, caches, cache_index, remat,
                   data_mean, aux):
        """The latent-attention stack: the leading dense layers, then the
        MoE layers; layer i reads and writes slice i of the latent cache
        ({"ckv"}, stacked over every layer).  One device only."""
        if self.tp is not None or self.fsdp is not None:
            raise ValueError(f"{self.cfg.name}: latent attention runs on "
                             f"one device; it has no tensor-parallel or "
                             f"FSDP layout")
        stack = [("dense_layers", lp)
                 for lp in unbind_tree(params["dense_layers"])]
        stack += [("layers", lp) for lp in unbind_tree(params["layers"])]
        angles = MLA.rope_angles(positions, self.cfg)
        for i, (block, lp) in enumerate(stack):
            cache = (None if caches is None
                     else {k: v[i] for k, v in caches.items()})
            x, a = self._attn_block(lp, x, positions, block=block,
                                    cache=cache, cache_index=cache_index,
                                    remat=remat, data_mean=data_mean,
                                    angles=angles)
            if a is not None:
                aux = aux + a
        return x, aux

    def _rwkv_stack(self, params, x, caches, cache_index, remat=False):
        """RWKV-6 layers; on a tensor-parallel rank the time mix runs the
        rank's heads and the channel mix its share of d_ff, one
        all_reduce after each (``TensorParallel``)."""
        cfg = self.cfg
        decode = cache_index is not None
        heads = None if self.tp is None else self.tp.rwkv_heads

        def body(lp, x, carry, i):
            lp = self._whole(lp, "layers", i)
            h, (state, tshift) = RW.rwkv_time_apply(
                lp["time"], cfg, L.apply_norm(lp["ln1"], x, cfg.norm),
                state=carry.get("state"), shift=carry.get("tshift"),
                decode=decode, heads=heads,
                enter=self._enterer("layers/time/wo/w"))
            x = x + self._reduce(h, "layers/time/wo/w")
            h, cshift = RW.rwkv_channel_apply(
                lp["chan"], cfg, L.apply_norm(lp["ln2"], x, cfg.norm),
                shift=carry.get("cshift"),
                reduce=lambda v: self._reduce(v, "layers/chan/wv/w"),
                enter=self._enterer("layers/chan/wv/w"))
            return x + h, state, tshift, cshift
        if remat:
            body = self._ckpt(body)
        for i, lp in enumerate(self._layers(params, "layers")):
            carry = (index_tree(caches, i) if caches is not None and decode
                     else {})
            x, state, tshift, cshift = body(lp, x, carry, i)
            if caches is not None:
                caches["state"][i].copy_(state)
                caches["tshift"][i].copy_(tshift)
                caches["cshift"][i].copy_(cshift)
        return x

    def _ssm_stack(self, params, x, positions, caches, cache_index,
                   remat=False):
        """Mamba2 layers in groups of ``attn_every``; in the hybrid, the
        shared block after each group, with that group's KV cache."""
        cfg = self.cfg
        period = cfg.attn_every if cfg.family == "hybrid" else cfg.layers
        shared = params.get("shared_block")
        decode = cache_index is not None
        heads = None if self.tp is None else self.tp.ssm_heads

        def body(lp, x, state, conv, i):
            lp = self._whole(lp, "layers", i)
            y = self._enter(L.apply_norm(lp["ln"], x, cfg.norm),
                            "layers/ssm/out_proj/w")
            h, (state, conv) = SSM.ssm_apply(
                lp["ssm"], cfg, y, state=state, conv_state=conv,
                decode=decode, heads=heads)
            return x + self._reduce(h, "layers/ssm/out_proj/w"), state, conv
        if remat:
            body = self._ckpt(body)
        layers = self._layers(params, "layers")
        for g in range(cfg.layers // period):
            for j in range(period):
                state = conv = None
                if caches is not None and decode:
                    state = caches["ssm"]["state"][g, j]
                    conv = caches["ssm"]["conv"][g, j]
                i = g * period + j
                x, state, conv = body(layers[i], x, state, conv, i)
                if caches is not None:
                    caches["ssm"]["state"][g, j].copy_(state)
                    caches["ssm"]["conv"][g, j].copy_(conv)
            if shared is not None:
                cache = (None if caches is None
                         else {"k": caches["attn"]["k"][g],
                               "v": caches["attn"]["v"][g]})
                x, _ = self._attn_block(shared, x, positions,
                                        block="shared_block", cache=cache,
                                        cache_index=cache_index,
                                        remat=remat)
        return x

    # --------------------------------------------------- encoder-decoder
    def _encode(self, params, enc_embeds, remat=False):
        """The encoder over frame embeddings (B, F, d): non-causal
        self-attention, then the MLP (unfused, as the reference calls
        it), then the encoder's norm.  On a tensor-parallel rank every
        rank ends with the whole output, after its all_reduces."""
        cfg = self.cfg
        pos = torch.arange(enc_embeds.shape[1], device=enc_embeds.device)

        def body(lp, x, i):
            lp = self._whole(lp, "encoder", i)
            h, _ = L.attention_apply(
                lp["attn"], L.apply_norm(lp["ln1"], x, cfg.norm),
                **self._heads("encoder/attn"),
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                q_positions=pos, causal=False,
                enter=self._enterer("encoder/attn/wo/w"))
            x = x + self._reduce(h, "encoder/attn/wo/w")
            return x + self._reduce(L.mlp_apply(
                lp["mlp"], self._enter(L.apply_norm(lp["ln2"], x, cfg.norm),
                                       "encoder/mlp/wd/w")),
                "encoder/mlp/wd/w")
        if remat:
            body = self._ckpt(body)
        x = enc_embeds
        for i, lp in enumerate(self._layers(params, "encoder")):
            x = body(lp, x, i)
        return L.apply_norm(self._whole(params["enc_norm"], "enc_norm"), x,
                            cfg.norm)

    def _decode_stack_encdec(self, params, x, enc_out, positions, *,
                             caches=None, cache_index=None, remat=False):
        """The decoder: causal self-attention over its KV cache
        (``caches["self"]``, updated in place), cross-attention to
        ``enc_out`` (its keys and values projected again at every step,
        as the reference does), then the MLP (unfused)."""
        cfg = self.cfg

        def body(lp, x, enc_out, cache, i):
            lp = self._whole(lp, "layers", i)
            h, _ = L.attention_apply(
                lp["attn"], L.apply_norm(lp["ln1"], x, cfg.norm),
                **self._heads("layers/attn"), head_dim=cfg.head_dim,
                rope_theta=cfg.rope_theta, q_positions=positions,
                causal=True, cache=cache, cache_index=cache_index,
                enter=self._enterer("layers/attn/wo/w"))
            x = x + self._reduce(h, "layers/attn/wo/w")
            h, _ = L.attention_apply(
                lp["xattn"], L.apply_norm(lp["lnx"], x, cfg.norm),
                **self._heads("layers/xattn"), head_dim=cfg.head_dim,
                rope_theta=None, q_positions=positions, causal=False,
                xkv=enc_out, enter=self._enterer("layers/xattn/wo/w"))
            x = x + self._reduce(h, "layers/xattn/wo/w")
            return x + self._reduce(L.mlp_apply(
                lp["mlp"], self._enter(L.apply_norm(lp["ln2"], x, cfg.norm),
                                       "layers/mlp/wd/w")),
                "layers/mlp/wd/w")
        if remat:
            body = self._ckpt(body)
        for i, lp in enumerate(self._layers(params, "layers")):
            cache = (None if caches is None
                     else {"k": caches["self"]["k"][i],
                           "v": caches["self"]["v"][i]})
            x = body(lp, x, enc_out, cache, i)
        return x

    # -------------------------------------------------------- training
    def loss(self, params, batch, *, remat: bool = True, data_mean=None):
        """The reference's training loss: mean next-token NLL over the
        labels >= 0 (-1 masks a position), from an fp32 log_softmax over
        the padded vocabulary (pad rows masked by ``_lm_logits``), plus
        0.01 x the layers' summed load-balancing loss for MoE.  ``batch``:
        ``tokens`` and ``labels`` (B, S) integer tensors, and ``frames``
        (the encoder's input) or ``patches`` (a prefix) (B, F, d) for the
        frontends' families.  ``remat`` rematerializes every layer body
        (``_ckpt``).  Returns a 0-d fp32 tensor.  On a mesh each data
        rank's loss is over its rows (the train step averages them), the
        MoE load-balancing loss over the global batch: ``data_mean`` is
        the differentiable mean over the data ranks
        (``launch.mesh.HostMesh.data_mean``; the replicated train step's
        over its group), by default the mesh's data axis on a sharded
        model, and none on one rank."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        cdt = L.dtype_of(cfg.compute_dtype)
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        aux = None
        if cfg.family == "encdec":
            enc = self._encode(params, batch["frames"].to(cdt), remat=remat)
            x = self._decode_stack_encdec(params,
                                          self._embed_in(params, tokens),
                                          enc, pos, remat=remat)
        else:
            prefix = batch.get("patches") if cfg.family == "vlm" else None
            x = self._embed_in(params, tokens, prefix)
            pos = torch.arange(x.shape[1], device=tokens.device)
            if data_mean is None and self.tp is not None:
                data_mean = functools.partial(self.tp.mesh.data_mean,
                                              comm=self.tp.comm)
            x, aux = self._forward_stack(params, x, pos, remat=remat,
                                         data_mean=data_mean)
            if prefix is not None:
                x = x[:, prefix.shape[1]:]
        logits = self._lm_logits(params, x)
        valid = (labels >= 0).to(torch.float32)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None]
                            .to(torch.int64))[..., 0]
        loss = torch.sum(nll * valid) / torch.clamp(torch.sum(valid),
                                                    min=1.0)
        if cfg.family != "encdec" and cfg.n_experts:
            loss = loss + 0.01 * aux
        return loss

    # --------------------------------------------------------- serving
    def prefill(self, params, batch, max_len: int):
        """Returns (last-token logits (B, 1, V), cache).  ``batch`` holds
        ``tokens`` (B, S) and, for the frontends' families, ``frames``
        (B, F, d: the encoder's input; the cache then carries its output
        as ``enc_out``) or ``patches`` (B, P, d: a prefix in front of the
        prompt, whose positions come first in the cache)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        caches = self.init_cache(B, max_len, device=tokens.device)
        if cfg.family == "encdec":
            enc = self._encode(params, batch["frames"].to(
                L.dtype_of(cfg.compute_dtype)))
            x = self._embed_in(params, tokens)
            pos = torch.arange(S, device=tokens.device)
            x = self._decode_stack_encdec(params, x, enc, pos,
                                          caches=caches["layers"])
            caches["enc_out"] = enc
        else:
            prefix = batch.get("patches") if cfg.family == "vlm" else None
            x = self._embed_in(params, tokens, prefix)
            pos = torch.arange(x.shape[1], device=tokens.device)
            x, _ = self._forward_stack(params, x, pos,
                                       caches=caches["layers"])
        return self._lm_logits(params, x[:, -1:]), caches

    def decode_step(self, params, cache, tokens, index: int | torch.Tensor):
        """One cache-resident step: tokens (B, S) written at
        [index, index + S) with causal attention over cache and chunk.
        ``index`` is one int write position shared by all rows, or a (B,)
        integer tensor on the tokens' device with each row's own position
        (the continuous scheduler's slot-indexed decode; each row is
        masked at its own valid length, and the step reads nothing of it
        back to the host).  The recurrent families take S == 1 and one
        shared position, as in the reference.  The encoder-decoder reads
        its encoder's output from ``cache["enc_out"]``.
        Returns (logits (B, S, V), cache), the cache updated in place."""
        B, S = tokens.shape
        offs = torch.arange(S, device=tokens.device)
        if isinstance(index, torch.Tensor):
            if self.cfg.family not in ("dense", "moe", "vlm", "encdec"):
                raise ValueError(
                    f"{self.cfg.name}: per-row positions need a pure KV "
                    f"cache; the {self.cfg.family!r} family carries "
                    f"recurrent state that the continuous scheduler "
                    f"cannot slot (it serves dense and MoE models)")
            index = index.to(torch.int64)
            pos = index[:, None] + offs[None, :]
        else:
            index = int(index)
            pos = (index + offs)[None].expand(B, S)
        x = self._embed_in(params, tokens)
        if self.cfg.family == "encdec":
            x = self._decode_stack_encdec(params, x, cache["enc_out"], pos,
                                          caches=cache["layers"],
                                          cache_index=index)
        else:
            x, _ = self._forward_stack(params, x, pos,
                                       caches=cache["layers"],
                                       cache_index=index)
        return self._lm_logits(params, x), cache

    def init_cache(self, batch: int, max_len: int,
                   device: str | torch.device = "cuda") -> dict:
        """Zeroed caches in the reference's layout: KV caches stacked on
        the layer axis (dense) or on the group axis (the hybrid's shared
        block); RWKV state and shift carries on the layer axis; Mamba2
        states and conv carries on (group, layer in group).  The MoE and
        VLM families' cache is the dense one, but a latent-attention
        model's holds [c_kv | k_pe] of every layer, {"ckv"}
        (``mla.cache_shapes``); the encoder-decoder's is
        the decoder's self-attention cache, {"self": {"k", "v"}}.  On a
        tensor-parallel rank the KV caches hold the rank's KV heads
        (``cache_spec``'s split), the recurrent states the rank's heads
        and the Mamba2 conv carry its [x_r, B, C] channels; the RWKV
        shift carries stay whole (``TensorParallel``)."""
        cfg = self.cfg
        dt = L.dtype_of(cfg.compute_dtype)
        f32 = torch.float32
        n = cfg.layers

        def zeros(shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=device)

        def kv(n_layers, block="layers"):
            heads = self._heads(f"{block}/attn")["kv_heads"]
            shape = (n_layers, batch, max_len, heads, cfg.head_dim)
            return {"k": zeros(shape), "v": zeros(shape)}

        if isinstance(cfg, MLAConfig):
            return {"layers": {k: zeros(shape) for k, shape in
                               MLA.cache_shapes(cfg, n, batch,
                                                max_len).items()}}
        if cfg.family in ("dense", "moe", "vlm"):
            return {"layers": kv(n)}
        if cfg.family == "encdec":
            return {"layers": {"self": kv(n)}}
        if cfg.family == "rwkv":
            nh, hd = RW.rwkv_dims(cfg)
            nh = nh if self.tp is None else self.tp.rwkv_heads
            return {"layers": {
                "state": zeros((n, batch, nh, hd, hd), f32),
                "tshift": zeros((n, batch, 1, cfg.d_model)),
                "cshift": zeros((n, batch, 1, cfg.d_model))}}
        period = cfg.attn_every if cfg.family == "hybrid" else n
        groups = n // period
        _, nh, hd, ns = SSM.ssm_dims(cfg)
        nh = nh if self.tp is None else self.tp.ssm_heads
        d_inner = nh * hd
        out = {"ssm": {
            "state": zeros((groups, period, batch, nh, hd, ns), f32),
            "conv": zeros((groups, period, batch, cfg.conv_kernel - 1,
                           d_inner + 2 * ns))}}
        if cfg.family == "hybrid":
            out["attn"] = kv(groups, "shared_block")
        return {"layers": out}

    def input_specs(self, shape: ShapeSpec | str) -> dict:
        """Meta-tensor stand-ins for every model input (the dry-run), of
        the reference's shapes and dtypes: a train or prefill batch, or a
        decode step's one new token, its write position and a cache of
        ``seq_len`` positions (this rank's heads on a tensor-parallel
        model)."""
        cfg = self.cfg
        if isinstance(shape, str):
            shape = SHAPES[shape]
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        cdt = L.dtype_of(cfg.compute_dtype)

        def sds(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        def frontend(out):
            if cfg.family == "encdec":
                out["frames"] = sds((B, cfg.frontend_len or S, cfg.d_model),
                                    cdt)
            if cfg.family == "vlm":
                out["patches"] = sds((B, cfg.frontend_len, cfg.d_model), cdt)
            return out

        if shape.kind == "train":
            return frontend({"tokens": sds((B, S), i32),
                             "labels": sds((B, S), i32)})
        if shape.kind == "prefill":
            return frontend({"tokens": sds((B, S), i32)})
        # decode: one new token against a cache of size S
        out = {"tokens": sds((B, 1), i32), "index": sds((), i32),
               "cache": self.init_cache(B, S, device="meta")}
        if cfg.family == "encdec":
            out["cache"]["enc_out"] = sds(
                (B, cfg.frontend_len or S, cfg.d_model), cdt)
        return out


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
