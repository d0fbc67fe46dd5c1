"""Sharding rules: parameter-path patterns -> PartitionSpec (the
counterpart of the reference's ``sharding/rules.py``).

Megatron-style TP over the "model" axis, DP over ("pod", "data"); expert
parallelism reuses the model axis (experts sharded on their leading dim).
Rules are regex patterns over '/'-joined parameter paths, first match
wins; stacked layers have a leading layer axis, detected by the tensor's
rank relative to the rule's spec length and padded with None.

The table, the path format and every spec are the reference's.  A mesh
is any object with ``shape`` (axis name -> size) and ``axis_names``, as a
``jax.sharding.Mesh`` has them (``launch.mesh.HostMesh`` here); there is
no NamedSharding, so ``param_shardings`` and ``cache_shardings`` return
trees of specs, and ``shard_params`` returns this rank's local slice of
every leaf (its coordinates from ``mesh.coords``).
"""
from __future__ import annotations

import math
import re

import torch

DP = ("pod", "data")      # flattened data-parallel submesh
TP = "model"


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of them, or
    None (not split); trailing dims past the entries are not split."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec

# pattern -> spec for the *unstacked* (single-layer) parameter
PARAM_RULES: list[tuple[str, P]] = [
    # embeddings / lm head: vocab on TP
    (r"embed/e$", P(TP, None)),
    (r"lm_head/w$", P(None, TP)),
    # attention: heads (fused into the out feature dim) on TP
    (r"attn/wq/w$", P(None, TP)),
    (r"attn/wk/w$", P(None, TP)),
    (r"attn/wv/w$", P(None, TP)),
    (r"attn/wo/w$", P(TP, None)),
    (r"xattn/w[qkv]/w$", P(None, TP)),
    (r"xattn/wo/w$", P(TP, None)),
    # gated MLP: d_ff on TP
    (r"mlp/w[gu]/w$", P(None, TP)),
    (r"mlp/wd/w$", P(TP, None)),
    # MoE: experts on TP (EP reuses the TP axis), shared experts like MLP
    (r"moe/router/w$", P(None, None)),
    (r"moe/w[gu]$", P(TP, None, None)),
    (r"moe/wd$", P(TP, None, None)),
    (r"moe/shared/w[gu]/w$", P(None, TP)),
    (r"moe/shared/wd/w$", P(TP, None)),
    # Mamba2: inner channels on TP
    (r"ssm/in_proj/w$", P(None, TP)),
    (r"ssm/out_proj/w$", P(TP, None)),
    (r"ssm/conv_w$", P(None, TP)),
    (r"ssm/(A_log|D|dt_bias)$", P(TP)),
    # RWKV6: heads on TP via the feature dim
    (r"time/w[rkvgw]/w$", P(None, TP)),
    (r"time/wo/w$", P(TP, None)),
    (r"time/u$", P(TP, None)),
    (r"time/(mix|w_bias)$", P()),
    (r"chan/w[kr]/w$", P(None, TP)),
    (r"chan/wv/w$", P(TP, None)),
    (r"chan/mix$", P()),
    # norms replicated
    (r"(ln\d?|lnx|ln|final_norm|enc_norm)/(scale|bias)$", P()),
]


def flatten_with_paths(tree: dict, prefix: str = "") -> list:
    """(path, leaf) for every leaf of a nested-dict tree, in insertion
    order, the paths '/'-joined as the reference's
    ``_flatten_with_paths`` joins them."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += flatten_with_paths(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def leaf_at(tree: dict, path: str):
    """The leaf at ``path``, or None where the tree has none."""
    for key in path.split("/"):
        if not isinstance(tree, dict) or key not in tree:
            return None
        tree = tree[key]
    return tree


def map_with_paths(fn, tree: dict, prefix: str = "") -> dict:
    """The same nested-dict tree with every leaf replaced by
    fn('/'-joined path, leaf), the paths as the reference's
    ``_flatten_with_paths`` joins them; leaves are visited in insertion
    order."""
    return {k: map_with_paths(fn, v, f"{prefix}{k}/") if isinstance(v, dict)
            else fn(f"{prefix}{k}", v) for k, v in tree.items()}


def spec_for_param(path: str, ndim: int, *, strict: bool = False) -> P:
    """PartitionSpec for one parameter path by first-matching rule.

    ``strict=False`` (default) replicates a path that matches no rule;
    ``strict=True`` raises instead: a new model family added parameters
    the rule table has never seen, and replicating them silently would
    hide it."""
    for pat, spec in PARAM_RULES:
        if re.search(pat, path):
            extra = ndim - len(spec)
            if extra < 0:
                # rank-reduced edge case: replicate
                return P()
            # stacked layers: leading axes unsharded
            return P(*([None] * extra + list(spec)))
    if strict:
        raise ValueError(
            f"no sharding rule matches parameter {path!r} (ndim={ndim}); "
            f"add a PARAM_RULES pattern for it or call with strict=False "
            f"to replicate")
    return P()  # replicate by default


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _axis_size(mesh, entry) -> int:
    return math.prod(mesh.shape[a] for a in _axes(entry))


def sanitize_spec(spec: P, shape: tuple[int, ...], mesh) -> P:
    """Drop sharding entries whose dim does not divide the mesh axes —
    odd vocabs (49155), GQA kv-heads < TP, batch=1 decode all fall back to
    replication on that dim."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        size = _axis_size(mesh, entry)
        out.append(entry if size > 1 and dim % size == 0
                   else (entry if size == 1 else None))
    return P(*out)


def _fsdp_axes(mesh) -> tuple[tuple[str, ...], int]:
    axes = tuple(a for a in DP if a in mesh.axis_names)
    return axes, math.prod(mesh.shape[a] for a in axes)


def apply_fsdp(spec: P, shape: tuple[int, ...], mesh,
               *, min_size: int = 2 ** 16) -> P:
    """ZeRO/FSDP: additionally shard one free dim of every large
    parameter over the data axes.  Dims must divide the fsdp size; tensors
    below ``min_size`` elements stay replicated across data."""
    axes, size = _fsdp_axes(mesh)
    if not axes or size == 1:
        return spec
    if math.prod(shape) < min_size:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    fsdp = axes if len(axes) > 1 else axes[0]
    for i, (dim, cur) in enumerate(zip(shape, entries)):
        if cur is None and dim % size == 0:
            entries[i] = fsdp
            return P(*entries)
    return spec


def param_spec(path: str, shape: tuple[int, ...], mesh, *,
               mode: str = "fsdp", strict: bool = False) -> P:
    """One leaf's spec as ``param_shardings`` gives it."""
    spec = sanitize_spec(spec_for_param(path, len(shape), strict=strict),
                         shape, mesh)
    return apply_fsdp(spec, shape, mesh) if mode == "fsdp" else spec


def param_shardings(params: dict, mesh, *, mode: str = "fsdp",
                    strict: bool = False) -> dict:
    """Tree of PartitionSpecs matching ``params``' structure.

    mode="tp": Megatron TP + pure DP replication of params.
    mode="fsdp" (default): TP + params sharded over data too.
    strict=True: raise on any parameter path matching no rule."""
    return map_with_paths(
        lambda path, leaf: param_spec(path, tuple(leaf.shape), mesh,
                                      mode=mode, strict=strict), params)


def _block_index(shape, spec: P, mesh, coords: dict) -> tuple:
    """The index of the block at mesh ``coords`` of a tensor of ``shape``
    under ``spec``: along a split dim, the block at the index of the
    coordinates on the entry's axes (the first axis of a tuple entry the
    most significant, as jax lays a mesh out)."""
    index = []
    for dim, entry in zip(shape, spec):
        n = _axis_size(mesh, entry)
        if n == 1:
            index.append(slice(None))
            continue
        i = 0
        for a in _axes(entry):
            i = i * mesh.shape[a] + coords[a]
        step = dim // n
        index.append(slice(i * step, (i + 1) * step))
    return tuple(index)


def local_slice(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (at ``mesh.coords``).  A
    view; ``t`` itself when no dim is split."""
    index = _block_index(t.shape, spec, mesh, mesh.coords)
    if all(s == slice(None) for s in index):
        return t
    return t[index]


def assemble(blocks: dict, spec: P, mesh) -> torch.Tensor:
    """The inverse of ``local_slice``: the whole tensor from the blocks of
    the ranks that split it, keyed by each rank's coordinates (a dict of
    axis name -> index, or a tuple in ``mesh.axis_names`` order).  Every
    block the spec names must be there once at least; ranks that hold the
    same block may each give it."""
    first = next(iter(blocks.values()))
    entries = list(spec) + [None] * (first.ndim - len(spec))
    shape = tuple(d * _axis_size(mesh, e)
                  for d, e in zip(first.shape, entries))
    whole = first.new_empty(shape)
    for coords, block in blocks.items():
        if not isinstance(coords, dict):
            coords = dict(zip(mesh.axis_names, coords))
        whole[_block_index(shape, entries, mesh, coords)] = block
    return whole


def local_copy(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """``local_slice`` as a tensor of its own, so that ``t`` can be
    freed; ``t`` itself when no dim is split."""
    local = local_slice(t, spec, mesh)
    return local if local is t else local.clone(
        memory_format=torch.contiguous_format)


def shard_params(params: dict, mesh, *, mode: str = "fsdp",
                 strict: bool = True) -> dict:
    """This rank's local slice of every leaf of a materialized parameter
    tree under the rule table (each split leaf a copy of its own).
    Strict by default: any parameter path that no PARAM_RULES pattern
    covers raises before a tensor is sliced."""
    specs = param_shardings(params, mesh, mode=mode, strict=strict)
    return map_with_paths(
        lambda path, leaf: local_copy(leaf, leaf_at(specs, path), mesh),
        params)


def batch_spec(shape: tuple[int, ...], mesh) -> P:
    """Shard the leading (batch) dim over all data axes present."""
    axes = tuple(a for a in DP if a in mesh.axis_names)
    dp = axes if len(axes) > 1 else (axes[0] if axes else None)
    ndim = len(shape)
    spec = P(dp, *([None] * (ndim - 1))) if ndim else P()
    return sanitize_spec(spec, shape, mesh)


def data_shardings(batch: dict, mesh) -> dict:
    return map_with_paths(
        lambda path, x: batch_spec(tuple(x.shape), mesh), batch)


def cache_spec(path: str, shape: tuple[int, ...], mesh) -> P:
    """KV/state caches: batch over data axes, heads over model.

    Layouts (trailing dims; any leading layer/group axes stay unsharded):
      k/v:   (..., B, T, KV, hd)     -> (..., DP, None, TP, None)
      state: (..., B, H, hd, ns|hd)  -> (..., DP, TP, None, None)
      conv:  (..., B, K-1, C)        -> (..., DP, None, TP)
      shift: (..., B, 1, d)          -> (..., DP, None, TP)
      enc_out: (B, S, d)             -> (DP, None, TP)
    Every sharded dim must divide its mesh-axis size (GQA kv_heads may be
    smaller than TP: fall back to replicated heads, as real engines do).
    """
    axes = tuple(a for a in DP if a in mesh.axis_names)
    dp = axes if len(axes) > 1 else (axes[0] if axes else None)
    ndim = len(shape)
    leaf = path.split("/")[-1]
    trailing = {
        "k": [dp, None, TP, None],
        "v": [dp, None, TP, None],
        "state": [dp, TP, None, None],
        "conv": [dp, None, TP],
        "tshift": [dp, None, TP],
        "cshift": [dp, None, TP],
        "enc_out": [dp, None, TP],
    }.get(leaf, [dp] + [None] * (ndim - 1))
    trailing = trailing[-ndim:]
    spec = [None] * (ndim - len(trailing)) + trailing
    return sanitize_spec(P(*spec), shape, mesh)


def cache_shardings(cache_tree: dict, mesh) -> dict:
    return map_with_paths(
        lambda path, leaf: cache_spec(path, tuple(leaf.shape), mesh),
        cache_tree)
