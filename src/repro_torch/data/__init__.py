from .pipeline import DataConfig, RankRows, global_arrays, host_batch

__all__ = ["DataConfig", "RankRows", "global_arrays", "host_batch"]
