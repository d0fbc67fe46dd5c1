"""BEYOND-PAPER: GOMA's geometry lifted to the chip-mesh level.

The paper's abstraction stops at one accelerator.  The same three-
projection geometry applies one level up: a sharded GEMM on an N-chip
mesh axis is a spatial tiling of the compute grid where

  * sharding axis x (rows/batch)   -> B replicated, A/P sharded:
      data parallelism; weight-gradient all-reduce over the axis,
  * sharding axis y (cols/heads)   -> A replicated, B/P sharded:
      tensor parallelism; activation all-gather of the x-projection,
  * sharding axis z (reduction)    -> A/B sharded, P partial:
      reduction parallelism; P needs a reduce-scatter — exactly GOMA's
      reduction-axis boundary case (the "read old partial" becomes the
      cross-chip combine).

The collective bytes of each choice are the projection areas that change
when walking the mesh axis — the paper's update-counting argument with
ICI as the next memory level.  ``plan_shard_axis`` evaluates the three
choices in closed form and returns the per-axis traffic, which the
§Perf hillclimb uses to pick shardings that shrink the collective
roofline term (EXPERIMENTS.md).
"""
from __future__ import annotations

import dataclasses

from .geometry import Gemm


@dataclasses.dataclass(frozen=True)
class ShardChoice:
    axis: str                  # which GEMM axis the mesh axis walks
    collective: str            # collective implied for the output
    ici_bytes_per_chip: float  # ring-model bytes per chip per step
    note: str


def plan_shard_axis(gemm: Gemm, n_chips: int, *, dtype_bytes: int = 2,
                    with_backward: bool = False) -> list[ShardChoice]:
    """Rank the three mesh-walking choices by ICI traffic (ascending)."""
    f = (n_chips - 1) / n_chips
    words_A = gemm.Lx * gemm.Lz
    words_B = gemm.Ly * gemm.Lz
    words_P = gemm.Lx * gemm.Ly

    out = []
    # x-walk (DP): each chip owns Lx/n rows; B must be present everywhere
    # (all-gather once or replicated); backward all-reduces dB.
    fwd = words_B * f * dtype_bytes        # B broadcast/all-gather
    bwd = 2 * words_B * f * dtype_bytes if with_backward else 0.0
    out.append(ShardChoice("x", "all-gather(B)" +
                           ("+all-reduce(dB)" if with_backward else ""),
                           fwd + bwd,
                           "data parallel: P,A sharded by rows"))
    # y-walk (TP): A gathered, P sharded by cols; backward all-reduces dA.
    fwd = words_A * f * dtype_bytes
    bwd = 2 * words_A * f * dtype_bytes if with_backward else 0.0
    out.append(ShardChoice("y", "all-gather(A)" +
                           ("+all-reduce(dA)" if with_backward else ""),
                           fwd + bwd,
                           "tensor parallel: P,B sharded by cols"))
    # z-walk (reduction parallel): inputs fully sharded, P partial:
    # reduce-scatter(P) — GOMA's rho boundary at mesh scale.
    fwd = words_P * f * dtype_bytes
    bwd = 2 * words_P * f * dtype_bytes if with_backward else 0.0
    out.append(ShardChoice("z", "reduce-scatter(P)",
                           fwd + bwd,
                           "reduction parallel: A,B sharded by k"))
    out.sort(key=lambda c: c.ici_bytes_per_chip)
    return out


def recommend(gemm: Gemm, n_chips: int, *, dtype_bytes: int = 2,
              with_backward: bool = False) -> ShardChoice:
    return plan_shard_axis(gemm, n_chips, dtype_bytes=dtype_bytes,
                           with_backward=with_backward)[0]


# --- multi-axis ring-collective model (dist.mesh_solve's cost layer) -------
# A mesh factorization (cx, cy, cz), cx*cy*cz = n_chips, walks all three
# GEMM axes at once: each chip owns an (Lx/cx, Ly/cy, Lz/cz) sub-problem.
# Per chip, the ring collectives move exactly the *local shard* of each
# projection scaled by the ring factor (c-1)/c of its own axis — the
# single-axis rows of plan_shard_axis are the (n,1,1)/(1,n,1)/(1,1,n)
# special cases.  Mixed factorizations can strictly beat every single
# axis: for words_A == words_B == w, (2,2,1) moves w/2 vs 0.75*w for
# (4,1,1) — the joint solver exploits precisely this.

def _ring(c: int) -> float:
    return (c - 1) / c if c > 1 else 0.0


def collective_words(gemm: Gemm, counts: tuple[int, int, int]
                     ) -> dict[str, tuple[str, float]]:
    """Per-chip ICI words moved by partition ``counts`` = (cx, cy, cz).

    Returns {axis: (collective, words)} for each mesh axis with count > 1:
      x-ring all-gathers this chip's (y, z)-shard of B,
      y-ring all-gathers this chip's (x, z)-shard of A,
      z-ring reduce-scatters this chip's (x, y)-shard of partial P.
    """
    cx, cy, cz = counts
    out: dict[str, tuple[str, float]] = {}
    if cx > 1:
        out["x"] = ("all-gather(B)", _ring(cx) * gemm.words_B / (cy * cz))
    if cy > 1:
        out["y"] = ("all-gather(A)", _ring(cy) * gemm.words_A / (cx * cz))
    if cz > 1:
        out["z"] = ("reduce-scatter(P)", _ring(cz) * gemm.words_P / (cx * cy))
    return out


def collective_energy(gemm: Gemm, counts: tuple[int, int, int], hw, *,
                      dtype_bytes: int = 1) -> float:
    """Per-chip collective energy (pJ) of partition ``counts`` on ``hw``.

    Each moved word costs one link write (sender) + one link read
    (receiver) at the spec's ICI ERT entries, in the same pJ-per-8-bit-
    word currency as the on-chip objective (fusion.link_energy)."""
    per_word = hw.ert.ici_read + hw.ert.ici_write
    words = sum(w for _, w in collective_words(gemm, counts).values())
    return words * dtype_bytes * per_word


def describe_collectives(gemm: Gemm, counts: tuple[int, int, int]) -> str:
    """Human-readable collective summary, e.g. ``all-gather(B)@x4``."""
    parts = [f"{name}@{ax}{c}" for ax, (name, _) in
             collective_words(gemm, counts).items()
             for c in [counts["xyz".index(ax)]]]
    return " + ".join(parts) if parts else "none (single chip)"
