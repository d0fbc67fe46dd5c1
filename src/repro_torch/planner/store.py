"""Content-addressed, versioned on-disk store of solved mapping plans.

Every entry is one exact solve: the optimal ``Mapping`` plus its zero-gap
``Certificate``, serialized as a single JSON object.  Entries are keyed by
a stable SHA-256 of the *semantic* solve identity — GEMM extents, every
physical parameter of the ``AcceleratorSpec`` (names are metadata, not
identity), solver version, objective, spatial mode and walk restrictions —
so a store can be shared between processes, machines and sessions, and a
solver-semantics bump (``core.solver.SOLVER_VERSION``) invalidates stale
plans by construction rather than by migration.

Layout (git-friendly, no global index to corrupt):

    <root>/objects/<digest[:2]>/<digest>.json

Writes are atomic (temp file + ``os.replace``); concurrent writers of the
same key converge on identical bytes, so last-write-wins is benign.

Durability (DESIGN.md §Resilience): every stored object carries a
``checksum`` field — SHA-256 over the canonical JSON of the rest of the
object — verified on read.  A corrupt entry (torn write, bit rot,
checksum or digest mismatch, unparseable bytes) is moved to
``<root>/quarantine/`` and reported as a miss, so the read-through
caller re-solves cold instead of crashing; a transient read IO error is
a plain miss.  A failed write keeps the entry in the in-process cache
and returns False rather than raising.  All of these paths count under
``errors.store.*`` / ``degraded.store.*``.  ``lock()`` provides an
advisory ``flock`` over ``<root>/.lock`` for concurrent builders, and
``fsck()``/``repair()`` back the ``python -m repro.plan fsck|repair``
CLI.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import pathlib
import tempfile
import time
from typing import Iterator

try:
    import fcntl
except ImportError:          # non-POSIX: advisory locking degrades to no-op
    fcntl = None

from ..core.certificate import Certificate
from ..core.fusion import ChainCertificate, GemmChain
from ..core.geometry import Gemm, Mapping
from ..core.hardware import AcceleratorSpec, Bandwidth, Ert
from ..core.pareto import ParetoCertificate, ParetoPoint
from ..core.solver import SOLVER_VERSION
from ..dist.mesh_solve import ShardedCertificate
from ..faults import inject
from ..obs.registry import get_registry
from ..obs.tracing import span as _span, trace_event

_REG = get_registry()


class CorruptEntry(Exception):
    """A stored object failed integrity verification (parse, checksum,
    or digest-vs-filename)."""

SCHEMA_VERSION = 1
# Fused (chain) entries carry their own schema: the chain objective and
# compatibility-constraint semantics can evolve independently of the
# single-GEMM plan format.
CHAIN_SCHEMA_VERSION = 1
# Sharded (mesh-level) entries likewise: the collective cost model and
# joint-certificate semantics evolve independently of both formats above.
SHARDED_SCHEMA_VERSION = 1
# Pareto (frontier) entries: the epsilon-constraint sweep and latency
# model can evolve without re-keying the single-point plan formats.
PARETO_SCHEMA_VERSION = 1

# Environment variable consumed by read-through integration points
# (core/tpu_mapping, serving.Engine): points at a store root directory.
PLAN_DB_ENV = "GOMA_PLAN_DB"


def _hw_identity(hw: AcceleratorSpec) -> dict:
    """Physical identity of an accelerator — everything except its name."""
    d = dataclasses.asdict(hw)
    d.pop("name")
    d["fixed_spatial"] = (list(hw.fixed_spatial)
                         if hw.fixed_spatial is not None else None)
    return d


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """The semantic identity of one exact solve (pre-hash form)."""

    gemm_dims: tuple[int, int, int]
    hw: AcceleratorSpec
    objective: str = "energy"
    spatial_mode: str | None = None
    allowed_walk01: tuple[str, ...] | None = None
    solver_version: str = SOLVER_VERSION

    def payload(self) -> dict:
        return {
            "schema": SCHEMA_VERSION,
            "solver_version": self.solver_version,
            "gemm": list(self.gemm_dims),
            "hw": _hw_identity(self.hw),
            "objective": self.objective,
            "spatial_mode": self.spatial_mode,
            "allowed_walk01": (list(self.allowed_walk01)
                               if self.allowed_walk01 is not None else None),
        }

    @property
    def digest(self) -> str:
        return _digest_of(self.payload())

    @property
    def family_digest(self) -> str:
        """Identity minus the GEMM extents — the near-neighbor pool."""
        p = self.payload()
        p.pop("gemm")
        return _digest_of(p)


def _digest_of(payload: dict) -> str:
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def plan_key(gemm: Gemm, hw: AcceleratorSpec, *, objective: str = "energy",
             spatial_mode: str | None = None,
             allowed_walk01: tuple[str, ...] | None = None) -> PlanKey:
    return PlanKey(gemm_dims=gemm.dims, hw=hw, objective=objective,
                   spatial_mode=spatial_mode,
                   allowed_walk01=tuple(allowed_walk01)
                   if allowed_walk01 is not None else None)


@dataclasses.dataclass(frozen=True)
class ChainKey:
    """The semantic identity of one chain solve (chain-hash key)."""

    producer_dims: tuple[int, int, int]
    consumer_dims: tuple[int, int, int]
    producer_count: int
    elementwise: str
    hw: AcceleratorSpec
    objective: str = "energy"
    spatial_mode: str | None = None
    allowed_walk01: tuple[str, ...] | None = None
    solver_version: str = SOLVER_VERSION

    def payload(self) -> dict:
        return {
            "chain_schema": CHAIN_SCHEMA_VERSION,
            "solver_version": self.solver_version,
            "producer": list(self.producer_dims),
            "consumer": list(self.consumer_dims),
            "producer_count": self.producer_count,
            "elementwise": self.elementwise,
            "hw": _hw_identity(self.hw),
            "objective": self.objective,
            "spatial_mode": self.spatial_mode,
            "allowed_walk01": (list(self.allowed_walk01)
                               if self.allowed_walk01 is not None else None),
        }

    @property
    def digest(self) -> str:
        return _digest_of(self.payload())


def chain_plan_key(chain: GemmChain, hw: AcceleratorSpec, *,
                   objective: str = "energy",
                   spatial_mode: str | None = None,
                   allowed_walk01: tuple[str, ...] | None = None
                   ) -> ChainKey:
    return ChainKey(producer_dims=chain.producer.dims,
                    consumer_dims=chain.consumer.dims,
                    producer_count=chain.producer_count,
                    elementwise=chain.elementwise, hw=hw,
                    objective=objective, spatial_mode=spatial_mode,
                    allowed_walk01=tuple(allowed_walk01)
                    if allowed_walk01 is not None else None)


@dataclasses.dataclass(frozen=True)
class ShardedKey:
    """The semantic identity of one joint (mesh, tiling) solve."""

    gemm_dims: tuple[int, int, int]
    n_chips: int
    dtype_bytes: int
    hw: AcceleratorSpec
    objective: str = "energy"
    spatial_mode: str | None = None
    allowed_walk01: tuple[str, ...] | None = None
    solver_version: str = SOLVER_VERSION

    def payload(self) -> dict:
        return {
            "sharded_schema": SHARDED_SCHEMA_VERSION,
            "solver_version": self.solver_version,
            "gemm": list(self.gemm_dims),
            "n_chips": self.n_chips,
            "dtype_bytes": self.dtype_bytes,
            "hw": _hw_identity(self.hw),
            "objective": self.objective,
            "spatial_mode": self.spatial_mode,
            "allowed_walk01": (list(self.allowed_walk01)
                               if self.allowed_walk01 is not None else None),
        }

    @property
    def digest(self) -> str:
        return _digest_of(self.payload())


def sharded_plan_key(gemm: Gemm, hw: AcceleratorSpec, n_chips: int, *,
                     dtype_bytes: int = 1, objective: str = "energy",
                     spatial_mode: str | None = None,
                     allowed_walk01: tuple[str, ...] | None = None
                     ) -> ShardedKey:
    return ShardedKey(gemm_dims=gemm.dims, n_chips=n_chips,
                      dtype_bytes=dtype_bytes, hw=hw, objective=objective,
                      spatial_mode=spatial_mode,
                      allowed_walk01=tuple(allowed_walk01)
                      if allowed_walk01 is not None else None)


@dataclasses.dataclass(frozen=True)
class ParetoKey:
    """The semantic identity of one Pareto-frontier sweep.

    Includes the bandwidth triple (delay prices depend on it — a
    recalibration re-keys frontiers instead of silently serving stale
    delay estimates) and the level cap (it bounds which epsilon slices
    were swept).  Single-point plan identities are untouched: this key
    addresses only the ``pareto/`` section."""

    gemm_dims: tuple[int, int, int]
    hw: AcceleratorSpec
    bandwidth: tuple[float, float, float]
    objective: str = "energy"
    spatial_mode: str | None = None
    allowed_walk01: tuple[str, ...] | None = None
    max_points: int | None = 24
    solver_version: str = SOLVER_VERSION

    def payload(self) -> dict:
        return {
            "pareto_schema": PARETO_SCHEMA_VERSION,
            "solver_version": self.solver_version,
            "gemm": list(self.gemm_dims),
            "hw": _hw_identity(self.hw),
            "bandwidth": [_float_to_json(b) for b in self.bandwidth],
            "objective": self.objective,
            "spatial_mode": self.spatial_mode,
            "allowed_walk01": (list(self.allowed_walk01)
                               if self.allowed_walk01 is not None else None),
            "max_points": self.max_points,
        }

    @property
    def digest(self) -> str:
        return _digest_of(self.payload())


def pareto_plan_key(gemm: Gemm, hw: AcceleratorSpec, *,
                    bw: Bandwidth | None = None,
                    objective: str = "energy",
                    spatial_mode: str | None = None,
                    allowed_walk01: tuple[str, ...] | None = None,
                    max_points: int | None = 24) -> ParetoKey:
    from ..core.hardware import bandwidth_for
    if bw is None:
        bw = bandwidth_for(hw)
    return ParetoKey(gemm_dims=gemm.dims, hw=hw, bandwidth=bw.as_tuple(),
                     objective=objective, spatial_mode=spatial_mode,
                     allowed_walk01=tuple(allowed_walk01)
                     if allowed_walk01 is not None else None,
                     max_points=max_points)


# ---------------------------------------------------------------------------
# JSON (de)serialization of the solved artifacts
# ---------------------------------------------------------------------------

def spec_to_json(hw: AcceleratorSpec) -> dict:
    d = dataclasses.asdict(hw)
    d["fixed_spatial"] = (list(hw.fixed_spatial)
                          if hw.fixed_spatial is not None else None)
    return d


def spec_from_json(d: dict) -> AcceleratorSpec:
    d = dict(d)
    d["ert"] = Ert(**d["ert"])
    if d.get("fixed_spatial") is not None:
        d["fixed_spatial"] = tuple(d["fixed_spatial"])
    return AcceleratorSpec(**d)


def mapping_to_json(m: Mapping | None) -> dict | None:
    if m is None:
        return None
    return {"L1": list(m.L1), "L2": list(m.L2), "L3": list(m.L3),
            "alpha01": m.alpha01, "alpha12": m.alpha12,
            "res1": list(m.res1), "res3": list(m.res3)}


def mapping_from_json(d: dict | None) -> Mapping | None:
    if d is None:
        return None
    return Mapping(L1=tuple(d["L1"]), L2=tuple(d["L2"]), L3=tuple(d["L3"]),
                   alpha01=d["alpha01"], alpha12=d["alpha12"],
                   res1=tuple(bool(b) for b in d["res1"]),
                   res3=tuple(bool(b) for b in d["res3"]))


def certificate_to_json(c: Certificate) -> dict:
    return {
        "gemm": {"dims": list(c.gemm.dims), "name": c.gemm.name},
        "hw_name": c.hw_name,
        "mapping": mapping_to_json(c.mapping),
        "objective": c.objective,
        "upper_bound": c.upper_bound,
        "lower_bound": c.lower_bound,
        "nodes_explored": c.nodes_explored,
        "nodes_pruned": c.nodes_pruned,
        "combos_skipped": c.combos_skipped,
        "space_size": c.space_size,
        "solve_time_s": c.solve_time_s,
        "spatial_mode": c.spatial_mode,
        "feasible": c.feasible,
        "objective_kind": c.objective_kind,
        "warm_started": c.warm_started,
        "engine": c.engine,
        "bounded": c.bounded,
    }


def certificate_from_json(d: dict) -> Certificate:
    g = d["gemm"]
    return Certificate(
        gemm=Gemm(*g["dims"], name=g.get("name", "")),
        hw_name=d["hw_name"],
        mapping=mapping_from_json(d["mapping"]),
        objective=d["objective"], upper_bound=d["upper_bound"],
        lower_bound=d["lower_bound"], nodes_explored=d["nodes_explored"],
        nodes_pruned=d["nodes_pruned"], combos_skipped=d["combos_skipped"],
        space_size=d["space_size"], solve_time_s=d["solve_time_s"],
        spatial_mode=d["spatial_mode"], feasible=d["feasible"],
        objective_kind=d.get("objective_kind", "energy"),
        warm_started=d.get("warm_started", False),
        engine=d.get("engine", "reference"),
        bounded=d.get("bounded", False))


def chain_certificate_to_json(c: ChainCertificate) -> dict:
    return {
        "chain_name": c.chain_name,
        "producer_dims": list(c.producer_dims),
        "consumer_dims": list(c.consumer_dims),
        "producer_count": c.producer_count,
        "elementwise": c.elementwise,
        "hw_name": c.hw_name,
        "fused": c.fused,
        "bm": c.bm,
        "objective": c.objective,
        "upper_bound": c.upper_bound,
        "lower_bound": c.lower_bound,
        "unfused_objective": c.unfused_objective,
        "credit": c.credit,
        "feasible": c.feasible,
        "n_solves": c.n_solves,
        "bm_candidates": c.bm_candidates,
        "solve_time_s": c.solve_time_s,
        "engine": c.engine,
        "objective_kind": c.objective_kind,
        "producer_certificate": (certificate_to_json(c.producer_certificate)
                                 if c.producer_certificate else None),
        "consumer_certificate": (certificate_to_json(c.consumer_certificate)
                                 if c.consumer_certificate else None),
    }


def chain_certificate_from_json(d: dict) -> ChainCertificate:
    return ChainCertificate(
        chain_name=d["chain_name"],
        producer_dims=tuple(d["producer_dims"]),
        consumer_dims=tuple(d["consumer_dims"]),
        producer_count=d["producer_count"],
        elementwise=d["elementwise"], hw_name=d["hw_name"],
        fused=d["fused"], bm=d["bm"], objective=d["objective"],
        upper_bound=d["upper_bound"], lower_bound=d["lower_bound"],
        unfused_objective=d["unfused_objective"], credit=d["credit"],
        feasible=d["feasible"], n_solves=d["n_solves"],
        bm_candidates=d["bm_candidates"],
        solve_time_s=d["solve_time_s"], engine=d["engine"],
        objective_kind=d.get("objective_kind", "energy"),
        producer_certificate=(certificate_from_json(d["producer_certificate"])
                              if d.get("producer_certificate") else None),
        consumer_certificate=(certificate_from_json(d["consumer_certificate"])
                              if d.get("consumer_certificate") else None))


def sharded_certificate_to_json(c: ShardedCertificate) -> dict:
    return {
        "gemm_dims": list(c.gemm_dims),
        "gemm_name": c.gemm_name,
        "hw_name": c.hw_name,
        "n_chips": c.n_chips,
        "dtype_bytes": c.dtype_bytes,
        "counts": list(c.counts) if c.counts is not None else None,
        "collectives": c.collectives,
        "objective": c.objective,
        "upper_bound": c.upper_bound,
        "lower_bound": c.lower_bound,
        "chip_pj": c.chip_pj,
        "collective_pj": c.collective_pj,
        "independent_objective": c.independent_objective,
        "independent_counts": (list(c.independent_counts)
                               if c.independent_counts is not None else None),
        "feasible": c.feasible,
        "n_solves": c.n_solves,
        "n_partitions": c.n_partitions,
        "solve_time_s": c.solve_time_s,
        "engine": c.engine,
        "objective_kind": c.objective_kind,
        "chip_certificate": (certificate_to_json(c.chip_certificate)
                             if c.chip_certificate else None),
    }


def sharded_certificate_from_json(d: dict) -> ShardedCertificate:
    return ShardedCertificate(
        gemm_dims=tuple(d["gemm_dims"]), gemm_name=d["gemm_name"],
        hw_name=d["hw_name"], n_chips=d["n_chips"],
        dtype_bytes=d["dtype_bytes"],
        counts=tuple(d["counts"]) if d["counts"] is not None else None,
        collectives=d["collectives"], objective=d["objective"],
        upper_bound=d["upper_bound"], lower_bound=d["lower_bound"],
        chip_pj=d["chip_pj"], collective_pj=d["collective_pj"],
        independent_objective=d["independent_objective"],
        independent_counts=(tuple(d["independent_counts"])
                            if d["independent_counts"] is not None else None),
        feasible=d["feasible"], n_solves=d["n_solves"],
        n_partitions=d["n_partitions"], solve_time_s=d["solve_time_s"],
        engine=d["engine"],
        objective_kind=d.get("objective_kind", "energy"),
        chip_certificate=(certificate_from_json(d["chip_certificate"])
                          if d.get("chip_certificate") else None))


def _float_to_json(x: float) -> float | str:
    """Non-finite floats as strings (strict-JSON-safe round-trip)."""
    import math
    return x if math.isfinite(x) else repr(x)


def _float_from_json(x: float | str) -> float:
    return float(x)


def pareto_point_to_json(p: ParetoPoint) -> dict:
    return {
        "min_pe": p.min_pe,
        "mapping": mapping_to_json(p.mapping),
        "certificate": certificate_to_json(p.certificate),
        "energy_pj": p.energy_pj,
        "delay_ns": p.delay_ns,
        "edp": p.edp,
        "num_pe_used": p.num_pe_used,
    }


def pareto_point_from_json(d: dict) -> ParetoPoint:
    return ParetoPoint(
        min_pe=d["min_pe"], mapping=mapping_from_json(d["mapping"]),
        certificate=certificate_from_json(d["certificate"]),
        energy_pj=d["energy_pj"], delay_ns=d["delay_ns"], edp=d["edp"],
        num_pe_used=d["num_pe_used"])


def pareto_certificate_to_json(c: ParetoCertificate) -> dict:
    return {
        "gemm": {"dims": list(c.gemm.dims), "name": c.gemm.name},
        "hw_name": c.hw_name,
        "objective_kind": c.objective_kind,
        "spatial_mode": c.spatial_mode,
        "bandwidth": [_float_to_json(b) for b in c.bandwidth],
        "points": [pareto_point_to_json(p) for p in c.points],
        "feasible": c.feasible,
        "levels_total": c.levels_total,
        "levels_swept": c.levels_swept,
        "candidates_seen": c.candidates_seen,
        "solve_time_s": c.solve_time_s,
    }


def pareto_certificate_from_json(d: dict) -> ParetoCertificate:
    g = d["gemm"]
    return ParetoCertificate(
        gemm=Gemm(*g["dims"], name=g.get("name", "")),
        hw_name=d["hw_name"], objective_kind=d["objective_kind"],
        spatial_mode=d["spatial_mode"],
        bandwidth=tuple(_float_from_json(b) for b in d["bandwidth"]),
        points=tuple(pareto_point_from_json(p) for p in d["points"]),
        feasible=d["feasible"], levels_total=d["levels_total"],
        levels_swept=d["levels_swept"],
        candidates_seen=d["candidates_seen"],
        solve_time_s=d["solve_time_s"])


@dataclasses.dataclass(frozen=True)
class ParetoPlanEntry:
    """One stored frontier sweep: every certified (energy, delay) point
    with its zero-gap slice certificate.  Self-describing like the entry
    kinds above; lives under ``<root>/pareto/`` so single-point
    iteration never sees frontiers."""

    digest: str
    gemm_dims: tuple[int, int, int]
    hw: AcceleratorSpec
    bandwidth: tuple[float, float, float]
    certificate: ParetoCertificate
    created_unix: float

    @property
    def hw_name(self) -> str:
        return self.hw.name

    @property
    def feasible(self) -> bool:
        return self.certificate.feasible

    @property
    def points(self) -> tuple[ParetoPoint, ...]:
        return self.certificate.points

    def to_json(self) -> dict:
        return {
            "pareto_schema": PARETO_SCHEMA_VERSION,
            "kind": "pareto",
            "digest": self.digest,
            "gemm_dims": list(self.gemm_dims),
            "hw": spec_to_json(self.hw),
            "bandwidth": [_float_to_json(b) for b in self.bandwidth],
            "certificate": pareto_certificate_to_json(self.certificate),
            "created_unix": self.created_unix,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ParetoPlanEntry":
        return cls(digest=d["digest"], gemm_dims=tuple(d["gemm_dims"]),
                   hw=spec_from_json(d["hw"]),
                   bandwidth=tuple(_float_from_json(b)
                                   for b in d["bandwidth"]),
                   certificate=pareto_certificate_from_json(
                       d["certificate"]),
                   created_unix=d["created_unix"])

    @classmethod
    def from_solve(cls, key: ParetoKey, result,
                   hw: AcceleratorSpec) -> "ParetoPlanEntry":
        """``result`` is a core.solver.ParetoSolveResult."""
        return cls(digest=key.digest, gemm_dims=key.gemm_dims, hw=hw,
                   bandwidth=key.bandwidth,
                   certificate=result.certificate,
                   created_unix=time.time())


@dataclasses.dataclass(frozen=True)
class FusedPlanEntry:
    """One stored chain solve: both link mappings plus the zero-gap chain
    certificate, self-describing like ``PlanEntry`` (full spec embedded).
    Lives under ``<root>/fused/`` so single-GEMM iteration/indexing never
    sees chain entries."""

    digest: str
    producer_dims: tuple[int, int, int]
    consumer_dims: tuple[int, int, int]
    producer_count: int
    elementwise: str
    hw: AcceleratorSpec
    producer_mapping: Mapping | None
    consumer_mapping: Mapping | None
    certificate: ChainCertificate
    created_unix: float

    @property
    def fused(self) -> bool:
        return self.certificate.fused

    @property
    def feasible(self) -> bool:
        return self.certificate.feasible

    def to_json(self) -> dict:
        return {
            "chain_schema": CHAIN_SCHEMA_VERSION,
            "kind": "fused",
            "digest": self.digest,
            "producer_dims": list(self.producer_dims),
            "consumer_dims": list(self.consumer_dims),
            "producer_count": self.producer_count,
            "elementwise": self.elementwise,
            "hw": spec_to_json(self.hw),
            "producer_mapping": mapping_to_json(self.producer_mapping),
            "consumer_mapping": mapping_to_json(self.consumer_mapping),
            "certificate": chain_certificate_to_json(self.certificate),
            "created_unix": self.created_unix,
        }

    @classmethod
    def from_json(cls, d: dict) -> "FusedPlanEntry":
        return cls(digest=d["digest"],
                   producer_dims=tuple(d["producer_dims"]),
                   consumer_dims=tuple(d["consumer_dims"]),
                   producer_count=d["producer_count"],
                   elementwise=d["elementwise"],
                   hw=spec_from_json(d["hw"]),
                   producer_mapping=mapping_from_json(d["producer_mapping"]),
                   consumer_mapping=mapping_from_json(d["consumer_mapping"]),
                   certificate=chain_certificate_from_json(d["certificate"]),
                   created_unix=d["created_unix"])

    @classmethod
    def from_solve(cls, key: ChainKey, result,
                   hw: AcceleratorSpec) -> "FusedPlanEntry":
        return cls(digest=key.digest, producer_dims=key.producer_dims,
                   consumer_dims=key.consumer_dims,
                   producer_count=key.producer_count,
                   elementwise=key.elementwise, hw=hw,
                   producer_mapping=result.producer_mapping,
                   consumer_mapping=result.consumer_mapping,
                   certificate=result.certificate,
                   created_unix=time.time())


@dataclasses.dataclass(frozen=True)
class ShardedPlanEntry:
    """One stored joint (mesh partition, per-chip tiling) solve: the
    mesh factorization, the per-chip ``Mapping`` of the sub-problem, the
    operand PartitionSpec layouts, and the zero-gap joint certificate.
    Self-describing like the entry kinds above; lives under
    ``<root>/sharded/`` so single-chip iteration never sees mesh plans."""

    digest: str
    gemm_dims: tuple[int, int, int]
    n_chips: int
    dtype_bytes: int
    hw: AcceleratorSpec
    counts: tuple[int, int, int] | None    # mesh factorization (cx, cy, cz)
    mapping: Mapping | None                # per-chip mapping of the optimum
    partition_specs: dict                  # operand -> axis-name tuple
    certificate: ShardedCertificate
    created_unix: float

    @property
    def hw_name(self) -> str:
        return self.hw.name

    @property
    def feasible(self) -> bool:
        return self.certificate.feasible

    def to_json(self) -> dict:
        return {
            "sharded_schema": SHARDED_SCHEMA_VERSION,
            "kind": "sharded",
            "digest": self.digest,
            "gemm_dims": list(self.gemm_dims),
            "n_chips": self.n_chips,
            "dtype_bytes": self.dtype_bytes,
            "hw": spec_to_json(self.hw),
            "counts": list(self.counts) if self.counts is not None else None,
            "mapping": mapping_to_json(self.mapping),
            "partition_specs": {op: list(spec) for op, spec
                                in self.partition_specs.items()},
            "certificate": sharded_certificate_to_json(self.certificate),
            "created_unix": self.created_unix,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ShardedPlanEntry":
        return cls(digest=d["digest"], gemm_dims=tuple(d["gemm_dims"]),
                   n_chips=d["n_chips"], dtype_bytes=d["dtype_bytes"],
                   hw=spec_from_json(d["hw"]),
                   counts=(tuple(d["counts"])
                           if d["counts"] is not None else None),
                   mapping=mapping_from_json(d["mapping"]),
                   partition_specs={op: tuple(spec) for op, spec
                                    in d["partition_specs"].items()},
                   certificate=sharded_certificate_from_json(
                       d["certificate"]),
                   created_unix=d["created_unix"])

    @classmethod
    def from_solve(cls, key: ShardedKey, result,
                   hw: AcceleratorSpec) -> "ShardedPlanEntry":
        """``result`` is a dist.mesh_solve.ShardedSolveResult."""
        return cls(digest=key.digest, gemm_dims=key.gemm_dims,
                   n_chips=key.n_chips, dtype_bytes=key.dtype_bytes, hw=hw,
                   counts=result.certificate.counts,
                   mapping=result.mapping,
                   partition_specs=result.specs or {},
                   certificate=result.certificate,
                   created_unix=time.time())


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    """One stored solve — self-describing (full spec embedded) so a store
    can be inspected and its certificates re-verified without access to
    the code that built it."""

    digest: str
    family_digest: str
    gemm_dims: tuple[int, int, int]
    hw: AcceleratorSpec
    objective_kind: str
    mapping: Mapping | None
    certificate: Certificate
    created_unix: float
    # the *requested* solve-key parameters (the certificate records what
    # the solve fell back to, which can differ): with these a bounded
    # entry can be re-solved to zero gap under the same digest
    # (``BatchPlanner.upgrade_bounded``).  None on pre-resilience entries.
    key_objective: str | None = None
    key_spatial_mode: str | None = None
    key_allowed_walk01: tuple[str, ...] | None = None

    @property
    def hw_name(self) -> str:
        return self.hw.name

    @property
    def feasible(self) -> bool:
        return self.certificate.feasible

    def to_json(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "digest": self.digest,
            "family_digest": self.family_digest,
            "gemm_dims": list(self.gemm_dims),
            "hw": spec_to_json(self.hw),
            "objective_kind": self.objective_kind,
            "mapping": mapping_to_json(self.mapping),
            "certificate": certificate_to_json(self.certificate),
            "created_unix": self.created_unix,
            "key_objective": self.key_objective,
            "key_spatial_mode": self.key_spatial_mode,
            "key_allowed_walk01": (list(self.key_allowed_walk01)
                                   if self.key_allowed_walk01 is not None
                                   else None),
        }

    @classmethod
    def from_json(cls, d: dict) -> "PlanEntry":
        walk = d.get("key_allowed_walk01")
        return cls(digest=d["digest"], family_digest=d["family_digest"],
                   gemm_dims=tuple(d["gemm_dims"]),
                   hw=spec_from_json(d["hw"]),
                   objective_kind=d["objective_kind"],
                   mapping=mapping_from_json(d["mapping"]),
                   certificate=certificate_from_json(d["certificate"]),
                   created_unix=d["created_unix"],
                   key_objective=d.get("key_objective"),
                   key_spatial_mode=d.get("key_spatial_mode"),
                   key_allowed_walk01=tuple(walk) if walk is not None
                   else None)

    @classmethod
    def from_solve(cls, key: PlanKey, certificate: Certificate,
                   hw: AcceleratorSpec) -> "PlanEntry":
        return cls(digest=key.digest, family_digest=key.family_digest,
                   gemm_dims=key.gemm_dims, hw=hw,
                   objective_kind=certificate.objective_kind,
                   mapping=certificate.mapping, certificate=certificate,
                   created_unix=time.time(),
                   key_objective=key.objective,
                   key_spatial_mode=key.spatial_mode,
                   key_allowed_walk01=key.allowed_walk01)


class PlanStore:
    """Directory-backed plan database with an in-memory read cache.

    ``get``/``put`` are the hot interface; ``nearest_neighbor`` supports
    the batch planner's warm start; ``entries`` streams everything for
    inspection/verification.  Hit/miss counters make cache behavior
    observable (bench_planner, ``repro.plan inspect``).
    """

    def __init__(self, root: str | os.PathLike):
        self.root = pathlib.Path(root)
        (self.root / "objects").mkdir(parents=True, exist_ok=True)
        self._mem: dict[str, PlanEntry] = {}
        self._fused_mem: dict[str, FusedPlanEntry] = {}
        self._sharded_mem: dict[str, ShardedPlanEntry] = {}
        self._pareto_mem: dict[str, ParetoPlanEntry] = {}
        # family_digest -> [digest]; built lazily on the first
        # nearest_neighbor call, maintained by put()
        self._family_index: dict[str, list[str]] | None = None
        self._lock_depth = 0
        self.hits = 0
        self.misses = 0
        self.puts = 0

    # -- durability primitives ---------------------------------------------
    @contextlib.contextmanager
    def lock(self):
        """Advisory exclusive inter-process lock on ``<root>/.lock``
        (``flock``), for concurrent builders writing one store.
        Re-entrant within a process; a no-op where fcntl is missing."""
        if fcntl is None or self._lock_depth > 0:
            self._lock_depth += 1
            try:
                yield
            finally:
                self._lock_depth -= 1
            return
        with open(self.root / ".lock", "a+") as fh:
            fcntl.flock(fh.fileno(), fcntl.LOCK_EX)
            self._lock_depth = 1
            try:
                yield
            finally:
                self._lock_depth = 0
                fcntl.flock(fh.fileno(), fcntl.LOCK_UN)

    def _quarantine(self, path: pathlib.Path, reason: str) -> None:
        """Move a corrupt object out of the store (best-effort) and log
        it to ``quarantine/log.jsonl``; the read that found it still
        reports a miss either way."""
        qdir = self.root / "quarantine"
        try:
            qdir.mkdir(parents=True, exist_ok=True)
            dest = qdir / path.name
            i = 0
            while dest.exists():
                i += 1
                dest = qdir / f"{path.stem}.{i}{path.suffix}"
            os.replace(path, dest)
            with open(qdir / "log.jsonl", "a") as f:
                f.write(json.dumps({"file": path.name, "reason": reason,
                                    "unix": time.time()}) + "\n")
        except OSError:
            pass
        _REG.inc("errors.store.corrupt")
        _REG.inc("degraded.store.quarantined")
        trace_event("store.quarantine", file=path.name, reason=reason)

    @staticmethod
    def _read_verified(path: pathlib.Path) -> dict:
        """Read one stored object; raises OSError on IO faults and
        CorruptEntry on parse/checksum failures.  Injection sites:
        ``store.read_io`` (raise) and ``store.corrupt`` (mangle)."""
        if inject("store.read_io") is not None:
            raise OSError(f"injected read fault: {path.name}")
        text = path.read_text()
        if inject("store.corrupt") is not None:
            text = text[: len(text) // 2] + "\x00"
        try:
            d = json.loads(text)
        except json.JSONDecodeError as e:
            raise CorruptEntry(f"bad json: {e}") from e
        if not isinstance(d, dict):
            raise CorruptEntry("not a JSON object")
        given = d.pop("checksum", None)
        # entries written before checksums existed carry none: accepted
        # here, surfaced by fsck(), rewritten by repair()
        if given is not None and given != _digest_of(d):
            raise CorruptEntry("checksum mismatch")
        return d

    def _write_object(self, path: pathlib.Path, payload: dict) -> bool:
        """Checksummed atomic write (tmp + rename under the advisory
        lock).  Returns False — counted, never raising — on an injected
        or real IO failure, so a full disk degrades to an unpersisted
        in-memory entry instead of a serving crash."""
        payload = dict(payload)
        payload["checksum"] = _digest_of(payload)
        blob = json.dumps(payload, sort_keys=True, indent=1)
        tmp = None
        try:
            if inject("store.write_io") is not None:
                raise OSError(f"injected write fault: {path.name}")
            path.parent.mkdir(parents=True, exist_ok=True)
            with self.lock():
                fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
                with os.fdopen(fd, "w") as f:
                    f.write(blob)
                os.replace(tmp, path)
                tmp = None
        except OSError:
            _REG.inc("errors.store.write_io")
            if tmp and os.path.exists(tmp):
                os.unlink(tmp)
            return False
        except BaseException:
            if tmp and os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return True

    # -- paths -------------------------------------------------------------
    def _path(self, digest: str) -> pathlib.Path:
        return self.root / "objects" / digest[:2] / f"{digest}.json"

    def _load(self, digest: str) -> PlanEntry | None:
        """Fetch without touching the hit/miss counters (internal reads:
        index builds, neighbor lookups, entry iteration)."""
        entry = self._mem.get(digest)
        if entry is not None:
            return entry
        path = self._path(digest)
        if not path.exists():
            return None
        try:
            entry = PlanEntry.from_json(self._read_verified(path))
            if entry.digest != digest:
                raise CorruptEntry("digest != filename")
        except OSError:
            # transient IO: a miss, not a crash — caller re-solves cold
            _REG.inc("errors.store.read_io")
            _REG.inc("degraded.store.cold_resolves")
            return None
        except (CorruptEntry, KeyError, TypeError, ValueError) as e:
            self._quarantine(path, reason=f"{type(e).__name__}: {e}")
            _REG.inc("degraded.store.cold_resolves")
            return None
        self._mem[digest] = entry
        return entry

    # -- core interface ----------------------------------------------------
    def get(self, key: PlanKey | str) -> PlanEntry | None:
        digest = key if isinstance(key, str) else key.digest
        with _span("store.get", digest=digest[:12]) as sp:
            entry = self._load(digest)
            if entry is None:
                self.misses += 1
                _REG.inc("plan_store.misses")
            else:
                self.hits += 1
                _REG.inc("plan_store.hits")
            if sp:
                sp.attrs["hit"] = entry is not None
        return entry

    def contains(self, key: PlanKey | str) -> bool:
        digest = key if isinstance(key, str) else key.digest
        return digest in self._mem or self._path(digest).exists()

    def contains_sharded(self, key: "ShardedKey | str") -> bool:
        digest = key if isinstance(key, str) else key.digest
        return (digest in self._sharded_mem
                or self._sharded_path(digest).exists())

    def put(self, entry: PlanEntry) -> bool:
        """Persist one solve.  Returns False when the disk write failed
        (counted ``errors.store.write_io``) — the entry still enters the
        in-process cache so this process keeps serving it."""
        persisted = self._write_object(self._path(entry.digest),
                                       entry.to_json())
        self._mem[entry.digest] = entry
        if self._family_index is not None:
            fam = self._family_index.setdefault(entry.family_digest, [])
            if entry.digest not in fam:
                fam.append(entry.digest)
        self.puts += 1
        _REG.inc("plan_store.puts")
        return persisted

    # -- fused (chain) entries ---------------------------------------------
    def _fused_path(self, digest: str) -> pathlib.Path:
        return self.root / "fused" / digest[:2] / f"{digest}.json"

    def _load_fused(self, digest: str) -> FusedPlanEntry | None:
        entry = self._fused_mem.get(digest)
        if entry is not None:
            return entry
        path = self._fused_path(digest)
        if not path.exists():
            return None
        try:
            entry = FusedPlanEntry.from_json(self._read_verified(path))
            if entry.digest != digest:
                raise CorruptEntry("digest != filename")
        except OSError:
            _REG.inc("errors.store.read_io")
            _REG.inc("degraded.store.cold_resolves")
            return None
        except (CorruptEntry, KeyError, TypeError, ValueError) as e:
            self._quarantine(path, reason=f"{type(e).__name__}: {e}")
            _REG.inc("degraded.store.cold_resolves")
            return None
        self._fused_mem[digest] = entry
        return entry

    def get_fused(self, key: "ChainKey | str") -> FusedPlanEntry | None:
        digest = key if isinstance(key, str) else key.digest
        with _span("store.get_fused", digest=digest[:12]) as sp:
            entry = self._load_fused(digest)
            if entry is None:
                self.misses += 1
                _REG.inc("plan_store.misses")
            else:
                self.hits += 1
                _REG.inc("plan_store.hits")
            if sp:
                sp.attrs["hit"] = entry is not None
        return entry

    def put_fused(self, entry: FusedPlanEntry) -> bool:
        persisted = self._write_object(self._fused_path(entry.digest),
                                       entry.to_json())
        self._fused_mem[entry.digest] = entry
        self.puts += 1
        _REG.inc("plan_store.puts")
        return persisted

    def fused_entries(self) -> Iterator[FusedPlanEntry]:
        for path in sorted((self.root / "fused").glob("*/*.json")):
            entry = self.get_fused(path.stem)
            if entry is not None:
                yield entry

    def num_fused(self) -> int:
        fused = self.root / "fused"
        return sum(1 for _ in fused.glob("*/*.json")) if fused.exists() \
            else 0

    # -- sharded (mesh-level) entries --------------------------------------
    def _sharded_path(self, digest: str) -> pathlib.Path:
        return self.root / "sharded" / digest[:2] / f"{digest}.json"

    def _load_sharded(self, digest: str) -> ShardedPlanEntry | None:
        entry = self._sharded_mem.get(digest)
        if entry is not None:
            return entry
        path = self._sharded_path(digest)
        if not path.exists():
            return None
        try:
            entry = ShardedPlanEntry.from_json(self._read_verified(path))
            if entry.digest != digest:
                raise CorruptEntry("digest != filename")
        except OSError:
            _REG.inc("errors.store.read_io")
            _REG.inc("degraded.store.cold_resolves")
            return None
        except (CorruptEntry, KeyError, TypeError, ValueError) as e:
            self._quarantine(path, reason=f"{type(e).__name__}: {e}")
            _REG.inc("degraded.store.cold_resolves")
            return None
        self._sharded_mem[digest] = entry
        return entry

    def get_sharded(self, key: "ShardedKey | str") -> ShardedPlanEntry | None:
        digest = key if isinstance(key, str) else key.digest
        with _span("store.get_sharded", digest=digest[:12]) as sp:
            entry = self._load_sharded(digest)
            if entry is None:
                self.misses += 1
                _REG.inc("plan_store.misses")
            else:
                self.hits += 1
                _REG.inc("plan_store.hits")
            if sp:
                sp.attrs["hit"] = entry is not None
        return entry

    def put_sharded(self, entry: ShardedPlanEntry) -> bool:
        persisted = self._write_object(self._sharded_path(entry.digest),
                                       entry.to_json())
        self._sharded_mem[entry.digest] = entry
        self.puts += 1
        _REG.inc("plan_store.puts")
        return persisted

    def sharded_entries(self) -> Iterator[ShardedPlanEntry]:
        for path in sorted((self.root / "sharded").glob("*/*.json")):
            entry = self.get_sharded(path.stem)
            if entry is not None:
                yield entry

    def num_sharded(self) -> int:
        sharded = self.root / "sharded"
        return sum(1 for _ in sharded.glob("*/*.json")) if sharded.exists() \
            else 0

    # -- pareto (frontier) entries -----------------------------------------
    def _pareto_path(self, digest: str) -> pathlib.Path:
        return self.root / "pareto" / digest[:2] / f"{digest}.json"

    def _load_pareto(self, digest: str) -> ParetoPlanEntry | None:
        entry = self._pareto_mem.get(digest)
        if entry is not None:
            return entry
        path = self._pareto_path(digest)
        if not path.exists():
            return None
        try:
            entry = ParetoPlanEntry.from_json(self._read_verified(path))
            if entry.digest != digest:
                raise CorruptEntry("digest != filename")
        except OSError:
            _REG.inc("errors.store.read_io")
            _REG.inc("degraded.store.cold_resolves")
            return None
        except (CorruptEntry, KeyError, TypeError, ValueError) as e:
            self._quarantine(path, reason=f"{type(e).__name__}: {e}")
            _REG.inc("degraded.store.cold_resolves")
            return None
        self._pareto_mem[digest] = entry
        return entry

    def get_pareto(self, key: "ParetoKey | str") -> ParetoPlanEntry | None:
        digest = key if isinstance(key, str) else key.digest
        with _span("store.get_pareto", digest=digest[:12]) as sp:
            entry = self._load_pareto(digest)
            if entry is None:
                self.misses += 1
                _REG.inc("plan_store.misses")
            else:
                self.hits += 1
                _REG.inc("plan_store.hits")
            if sp:
                sp.attrs["hit"] = entry is not None
        return entry

    def put_pareto(self, entry: ParetoPlanEntry) -> bool:
        persisted = self._write_object(self._pareto_path(entry.digest),
                                       entry.to_json())
        self._pareto_mem[entry.digest] = entry
        self.puts += 1
        _REG.inc("plan_store.puts")
        return persisted

    def contains_pareto(self, key: "ParetoKey | str") -> bool:
        digest = key if isinstance(key, str) else key.digest
        return (digest in self._pareto_mem
                or self._pareto_path(digest).exists())

    def pareto_entries(self) -> Iterator[ParetoPlanEntry]:
        for path in sorted((self.root / "pareto").glob("*/*.json")):
            entry = self.get_pareto(path.stem)
            if entry is not None:
                yield entry

    def num_pareto(self) -> int:
        pareto = self.root / "pareto"
        return sum(1 for _ in pareto.glob("*/*.json")) if pareto.exists() \
            else 0

    # -- inspection --------------------------------------------------------
    def entries(self) -> Iterator[PlanEntry]:
        for path in sorted((self.root / "objects").glob("*/*.json")):
            entry = self._load(path.stem)
            if entry is not None:
                yield entry

    def __len__(self) -> int:
        return sum(1 for _ in (self.root / "objects").glob("*/*.json"))

    def __bool__(self) -> bool:
        # an *empty* store is still a store — never truth-test to None
        return True

    def num_quarantined(self) -> int:
        qdir = self.root / "quarantine"
        return sum(1 for _ in qdir.glob("*.json")) if qdir.exists() else 0

    def stats(self) -> dict:
        return {"root": str(self.root), "entries": len(self),
                "fused_entries": self.num_fused(),
                "sharded_entries": self.num_sharded(),
                "pareto_entries": self.num_pareto(),
                "quarantined": self.num_quarantined(),
                "hits": self.hits, "misses": self.misses, "puts": self.puts}

    # -- integrity ---------------------------------------------------------
    def _object_files(self) -> Iterator[tuple[pathlib.Path, type]]:
        for base, loader in ((self.root / "objects", PlanEntry),
                             (self.root / "fused", FusedPlanEntry),
                             (self.root / "sharded", ShardedPlanEntry),
                             (self.root / "pareto", ParetoPlanEntry)):
            if not base.exists():
                continue
            for path in sorted(base.glob("*/*.json")):
                yield path, loader

    def fsck(self) -> dict:
        """Integrity scan of every stored object: JSON parse, checksum,
        schema round-trip, digest-vs-filename.  Read-only, and reads the
        raw bytes directly so injection sites never fire — fsck reports
        what is actually on disk."""
        report: dict = {"checked": 0, "ok": 0, "legacy": 0, "corrupt": [],
                        "quarantined": self.num_quarantined()}
        for path, loader in self._object_files():
            report["checked"] += 1
            try:
                d = json.loads(path.read_text())
                if not isinstance(d, dict):
                    raise CorruptEntry("not a JSON object")
                given = d.pop("checksum", None)
                if given is None:
                    report["legacy"] += 1
                elif given != _digest_of(d):
                    raise CorruptEntry("checksum mismatch")
                entry = loader.from_json(d)
                if entry.digest != path.stem:
                    raise CorruptEntry("digest != filename")
            except (OSError, CorruptEntry, json.JSONDecodeError, KeyError,
                    TypeError, ValueError) as e:
                report["corrupt"].append(
                    {"path": str(path.relative_to(self.root)),
                     "reason": f"{type(e).__name__}: {e}"})
                continue
            report["ok"] += 1
        return report

    def repair(self) -> dict:
        """Quarantine every corrupt object and rewrite legacy
        (un-checksummed) entries with checksums, under the advisory
        lock.  Quarantined plans re-enter the store through the normal
        cold re-solve path; nothing is deleted."""
        report = self.fsck()
        rewritten = 0
        with self.lock():
            for item in report["corrupt"]:
                path = self.root / item["path"]
                if path.exists():
                    self._quarantine(path, reason=item["reason"])
            for path, _loader in self._object_files():
                try:
                    d = json.loads(path.read_text())
                except (OSError, json.JSONDecodeError):
                    continue
                if isinstance(d, dict) and "checksum" not in d:
                    if self._write_object(path, d):
                        rewritten += 1
        report["rewritten"] = rewritten
        report["quarantined"] = self.num_quarantined()
        return report

    # -- warm-start support ------------------------------------------------
    def _families(self) -> dict[str, list[str]]:
        """Per-family digest index: one full scan on first use, then
        maintained incrementally by put().  Entries written by *other*
        processes after the scan are not candidates until a fresh
        PlanStore is opened — acceptable for a warm-start heuristic."""
        if self._family_index is None:
            idx: dict[str, list[str]] = {}
            for e in self.entries():
                idx.setdefault(e.family_digest, []).append(e.digest)
            self._family_index = idx
        return self._family_index

    def nearest_neighbor(self, key: PlanKey) -> PlanEntry | None:
        """Closest stored solve of the same family (hw/objective/version),
        by log-space distance over the GEMM extents."""
        import math
        tgt = [math.log(max(1, d)) for d in key.gemm_dims]
        best, best_d = None, float("inf")
        for digest in self._families().get(key.family_digest, ()):
            if digest == key.digest:
                continue
            e = self._load(digest)
            if e is None or not e.feasible or e.mapping is None:
                continue
            d = sum((math.log(max(1, x)) - t) ** 2
                    for x, t in zip(e.gemm_dims, tgt))
            if d < best_d:
                best, best_d = e, d
        return best


def resolve_default_store() -> PlanStore | None:
    """The process-default store: ``$GOMA_PLAN_DB`` if set, else None."""
    root = os.environ.get(PLAN_DB_ENV, "").strip()
    return PlanStore(root) if root else None


# Ert is re-exported so batch workers can rebuild specs without importing
# core.hardware directly (keeps the subprocess import surface small).
__all__ = [
    "CHAIN_SCHEMA_VERSION", "ChainKey", "CorruptEntry", "Ert",
    "FusedPlanEntry",
    "PARETO_SCHEMA_VERSION", "PLAN_DB_ENV", "ParetoKey",
    "ParetoPlanEntry", "PlanEntry", "PlanKey", "PlanStore",
    "SCHEMA_VERSION", "SHARDED_SCHEMA_VERSION", "ShardedKey",
    "ShardedPlanEntry", "certificate_from_json", "certificate_to_json",
    "chain_certificate_from_json", "chain_certificate_to_json",
    "chain_plan_key", "mapping_from_json", "mapping_to_json",
    "pareto_certificate_from_json", "pareto_certificate_to_json",
    "pareto_plan_key", "plan_key",
    "resolve_default_store", "sharded_certificate_from_json",
    "sharded_certificate_to_json", "sharded_plan_key",
]
