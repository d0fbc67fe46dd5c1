"""Move the reference's parameters into the port.

``params_from_jax`` takes the pytree of the reference's
``Model.init_params``, already turned into numpy arrays (for example with
``jax.tree.map(np.asarray, params)``), and returns the port's parameter
tree with the same layout: the layer stack on axis 0, projection weights
as ``(d_in, d_out)``, so B1 reads them as ``(K, N)`` row-major.

The reference keeps the dense projection weights in the parameter dtype
and casts them to the compute dtype at every use (``layers.dense``); the
port casts them once here.  The values it multiplies are the same.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from .layers import dtype_of
from .model import DENSE_WEIGHTS


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
                    device: str | torch.device = "cuda") -> dict:
    """The port's parameters from the reference's (numpy) pytree."""
    params = _convert(numpy_tree, device)
    cdt = dtype_of(cfg.compute_dtype)
    for block, name in DENSE_WEIGHTS:
        w = params["layers"][block][name]
        w["w"] = w["w"].to(cdt)
    return params
