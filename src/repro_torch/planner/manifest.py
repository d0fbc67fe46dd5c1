"""ModelMappingManifest: the build artifact of one batch-planning run.

A manifest binds a model scenario (prefill seq sweep + decode shapes) to
the plan-store entries that cover it: one row per *distinct* GEMM shape
with its occurrence weight, store digest, objective and provenance
(cache hit vs fresh solve, warm-started or cold).  It is the unit a
deployment ships: given the manifest plus the store, every kernel tiling
decision for the model is a dictionary lookup — zero solver invocations
on the serving path.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time

MANIFEST_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class ManifestEntry:
    gemm_type: str
    dims: tuple[int, int, int]        # (M, N, K) = (Lx, Ly, Lz)
    weight: int                       # occurrence count (eq. 35 w_g)
    digest: str                       # plan-store key
    objective: float                  # certified pJ/MAC (or EDP scalar)
    feasible: bool
    solve_time_s: float
    cached: bool                      # served from the store (no solve)
    warm_started: bool = False
    gap: float = 0.0                  # certificate UB - LB (0 = exact)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["dims"] = list(self.dims)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ManifestEntry":
        d = dict(d)
        d["dims"] = tuple(d["dims"])
        return cls(**d)


@dataclasses.dataclass
class ModelMappingManifest:
    model: str
    hw_name: str
    objective: str
    prefill_seqs: tuple[int, ...]
    decode_batches: tuple[int, ...]
    cache_len: int
    entries: list[ManifestEntry]
    created_unix: float = dataclasses.field(default_factory=time.time)
    solver_version: str = ""

    # -- aggregates --------------------------------------------------------
    @property
    def hit_rate(self) -> float:
        if not self.entries:
            return 0.0
        return sum(e.cached for e in self.entries) / len(self.entries)

    @property
    def solved(self) -> int:
        return sum(not e.cached for e in self.entries)

    @property
    def total_solve_time_s(self) -> float:
        return sum(e.solve_time_s for e in self.entries if not e.cached)

    def weighted_objective(self) -> float:
        """Occurrence-weighted sum of per-GEMM objectives (eq. 35 shape)."""
        return sum(e.weight * e.objective
                   for e in self.entries if e.feasible)

    def lookup(self, dims: tuple[int, int, int]) -> ManifestEntry | None:
        for e in self.entries:
            if e.dims == tuple(dims):
                return e
        return None

    # -- persistence -------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "schema_version": MANIFEST_SCHEMA,
            "model": self.model,
            "hw_name": self.hw_name,
            "objective": self.objective,
            "prefill_seqs": list(self.prefill_seqs),
            "decode_batches": list(self.decode_batches),
            "cache_len": self.cache_len,
            "solver_version": self.solver_version,
            "created_unix": self.created_unix,
            "entries": [e.to_json() for e in self.entries],
        }

    def save(self, path: str | pathlib.Path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=1,
                                   sort_keys=True))
        return path

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "ModelMappingManifest":
        d = json.loads(pathlib.Path(path).read_text())
        return cls(
            model=d["model"], hw_name=d["hw_name"],
            objective=d["objective"],
            prefill_seqs=tuple(d["prefill_seqs"]),
            decode_batches=tuple(d["decode_batches"]),
            cache_len=d["cache_len"],
            entries=[ManifestEntry.from_json(e) for e in d["entries"]],
            created_unix=d["created_unix"],
            solver_version=d.get("solver_version", ""))

    def summary(self) -> str:
        n = len(self.entries)
        return (f"[manifest] {self.model}@{self.hw_name} obj={self.objective}"
                f"  gemms={n} hit_rate={self.hit_rate:.0%} "
                f"solved={self.solved} "
                f"solve_time={self.total_solve_time_s:.2f}s "
                f"weighted_obj={self.weighted_objective():.6g}")


# ---------------------------------------------------------------------------
# sharded manifests: the multi-chip deployment artifact
# ---------------------------------------------------------------------------

SHARDED_MANIFEST_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class ShardedManifestEntry:
    """One distinct GEMM of a program lowered to its joint mesh plan:
    the chosen factorization, the joint/independent objectives (absolute
    per-chip pJ) and the sharded-store digest that holds the per-chip
    mapping + PartitionSpecs."""

    gemm_type: str
    dims: tuple[int, int, int]
    weight: int
    digest: str                        # sharded-store key
    counts: tuple[int, int, int] | None
    collectives: str
    objective: float                   # joint optimum, per-chip pJ
    independent_objective: float
    feasible: bool
    gap: float
    cached: bool
    solve_time_s: float = 0.0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["dims"] = list(self.dims)
        d["counts"] = list(self.counts) if self.counts is not None else None
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ShardedManifestEntry":
        d = dict(d)
        d["dims"] = tuple(d["dims"])
        d["counts"] = (tuple(d["counts"])
                       if d["counts"] is not None else None)
        return cls(**d)


@dataclasses.dataclass
class ShardedModelManifest:
    """The multi-chip counterpart of ``ModelMappingManifest``: one row
    per distinct GEMM of a captured program, each bound to its joint
    (mesh partition, per-chip tiling) plan in the store's sharded
    section.  Ships with the store; a mesh deployment resolves every
    partition + tiling decision by digest lookup."""

    model: str
    hw_name: str
    n_chips: int
    dtype_bytes: int
    entries: list[ShardedManifestEntry]
    created_unix: float = dataclasses.field(default_factory=time.time)
    solver_version: str = ""

    @property
    def feasible(self) -> bool:
        return all(e.feasible for e in self.entries)

    @property
    def zero_gap(self) -> bool:
        return all(e.gap == 0.0 for e in self.entries if e.feasible)

    def weighted_objective(self) -> float:
        return sum(e.weight * e.objective
                   for e in self.entries if e.feasible)

    def weighted_independent(self) -> float:
        return sum(e.weight * e.independent_objective for e in self.entries
                   if e.feasible and e.independent_objective != float("inf"))

    def lookup(self, dims: tuple[int, int, int]
               ) -> ShardedManifestEntry | None:
        for e in self.entries:
            if e.dims == tuple(dims):
                return e
        return None

    def to_json(self) -> dict:
        return {
            "schema_version": SHARDED_MANIFEST_SCHEMA,
            "model": self.model,
            "hw_name": self.hw_name,
            "n_chips": self.n_chips,
            "dtype_bytes": self.dtype_bytes,
            "solver_version": self.solver_version,
            "created_unix": self.created_unix,
            "entries": [e.to_json() for e in self.entries],
        }

    def save(self, path: str | pathlib.Path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=1,
                                   sort_keys=True))
        return path

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "ShardedModelManifest":
        d = json.loads(pathlib.Path(path).read_text())
        return cls(
            model=d["model"], hw_name=d["hw_name"], n_chips=d["n_chips"],
            dtype_bytes=d["dtype_bytes"],
            entries=[ShardedManifestEntry.from_json(e)
                     for e in d["entries"]],
            created_unix=d["created_unix"],
            solver_version=d.get("solver_version", ""))

    def summary(self) -> str:
        n = len(self.entries)
        wj, wi = self.weighted_objective(), self.weighted_independent()
        save = (1.0 - wj / wi) if wi > 0 else 0.0
        return (f"[sharded-manifest] {self.model}@{self.hw_name} "
                f"x{self.n_chips} gemms={n} feasible={self.feasible} "
                f"zero_gap={self.zero_gap} joint={wj:.6g} "
                f"independent={wi:.6g} saves={100 * save:.1f}%")
