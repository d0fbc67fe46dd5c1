"""Sharding rules for the (pod, data, model) production mesh (the
counterpart of the reference's ``sharding``)."""
from .rules import (apply_fsdp, batch_spec, cache_shardings, data_shardings,
                    param_shardings, shard_params, spec_for_param)

__all__ = ["apply_fsdp", "batch_spec", "cache_shardings", "data_shardings",
           "param_shardings", "shard_params", "spec_for_param"]
