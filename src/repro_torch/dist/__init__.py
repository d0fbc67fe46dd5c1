"""Distributed mapping: the mesh as one more geometric level.

``mesh_solve`` co-solves the chip-mesh partition of a GEMM *jointly*
with the per-chip tiling: every divisor-respecting factorization
(cx, cy, cz) of the chip count is an outer spatial-axis candidate whose
branch cost is an exact single-chip GOMA solve of the sub-problem plus
the closed-form ring-collective energy (core.dist_mapping), priced
through the spec's ICI ERT entries.  Enumeration is exhaustive and each
branch is zero-gap, so the joint certificate is zero-gap too — and the
independently-recommended sharding (dist_mapping.recommend + per-chip
optimum) is one of the branches, so joint <= independent by
construction.

Only ``mesh_solve`` is re-exported here; ``dist.serve`` (jax mesh /
sharded-params helpers) imports jax and the serving stack and must be
imported explicitly to keep the core dependency graph acyclic.
"""
from .mesh_solve import (MeshSpec, ShardedCertificate, ShardedSolveResult,
                         enumerate_partitions, partition_specs,
                         solve_sharded, verify_sharded)

__all__ = [
    "MeshSpec", "ShardedCertificate", "ShardedSolveResult",
    "enumerate_partitions", "partition_specs", "solve_sharded",
    "verify_sharded",
]
