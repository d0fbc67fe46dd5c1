"""Serving scale-out: replica routing, KV prefix reuse, speculative
decoding — all on plan-prewarmed paths (DESIGN.md §Scale-out)."""
from .prefix import PrefixCache
from .router import ReplicaRouter, RouterConfig
from .spec import (DEFAULT_WIDTHS, ModelDrafter, NgramDrafter,
                   spec_generate)

__all__ = [
    "PrefixCache",
    "ReplicaRouter",
    "RouterConfig",
    "DEFAULT_WIDTHS",
    "ModelDrafter",
    "NgramDrafter",
    "spec_generate",
]
