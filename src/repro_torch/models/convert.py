"""Move the reference's parameters into the port.

``params_from_jax`` takes the pytree of the reference's
``Model.init_params``, already turned into numpy arrays (for example with
``jax.tree.map(np.asarray, params)``), and returns the port's parameter
tree with the same layout: the layer stack on axis 0, projection weights
as ``(d_in, d_out)``, so B1 reads them as ``(K, N)`` row-major.

The reference keeps the projection weights in the parameter dtype and
casts them to the compute dtype at every use (``layers.dense``); the
port casts them once here (``model.PROJECTIONS`` lists them by family:
attention and MLP weights (the VLM's are the dense ones; the
encoder-decoder's are its encoder's and its decoder's, cross-attention
included), RWKV time and channel weights, Mamba2 in and out projections,
the hybrid's shared block).  The values it multiplies
are the same.  The MoE family's expert banks ``(E, d_in, d_out)`` and
shared experts go to the compute dtype too, though the reference upcasts
them to fp32 at every use (``moe.py`` upcasts them per layer call): with
an fp32 compute dtype the values are the reference's, with bf16 they are
those of the reference run with ``param_dtype="bfloat16"``.  Everything
else keeps the reference's dtype: the embedding and an untied LM head
(gemma2-27b's: fp32), the MoE router (fp32), norms, mixes, the RWKV
bonus and decay bias, and Mamba2's A_log, D, dt_bias and conv taps.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from .layers import dtype_of
from .model import PROJECTIONS


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # numpy has no bfloat16 of its own
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def _convert(tree, device):
    return {k: _convert(v, device) if isinstance(v, dict)
            else _tensor(v, device) for k, v in tree.items()}


def params_from_jax(numpy_tree: dict, cfg: ArchConfig,
                    device: str | torch.device = "cuda", *,
                    masters: bool = False) -> dict:
    """The port's parameters from the reference's (numpy) pytree.  With
    ``masters`` (training) every leaf keeps the reference's dtype, as
    ``Model.init_params(masters=True)`` makes them, and the model casts
    at use, as the reference does."""
    params = _convert(numpy_tree, device)
    if masters:
        return params
    cdt = dtype_of(cfg.compute_dtype)
    for path in PROJECTIONS[cfg.family]:
        w = params
        for key in path:
            w = w[key]
        w["w"] = w["w"].to(cdt)
    moe = params["layers"].get("moe")
    if moe is not None:
        for name in ("wg", "wu", "wd"):
            moe[name] = moe[name].to(cdt)
        for w in moe.get("shared", {}).values():
            w["w"] = w["w"].to(cdt)
    return params
