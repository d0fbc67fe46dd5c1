"""PlanProgram: the unified planning IR between extraction and solving.

A :class:`PlanProgram` is a weighted multiset of GEMM mapping instances
plus a weighted multiset of fusable chains — the one representation every
planning front end lowers to and every planning consumer reads from:

  * **capture** (``capture.trace``): jaxpr-traced programs dedupe their
    harvested sites into a PlanProgram (`from_capture`);
  * **hand enumeration** (``core.workloads``): the paper's extraction
    tables wrap their (type, Gemm, weight) rows into the same IR
    (`from_rows`) and serve as the differential oracle for capture;
  * **the plan pass** (``capture.plan``): lowers any PlanProgram through
    ``planner.batch`` into a populated store + manifest in one deduped
    ``solve_many`` + ``cached_solve_chain`` pass.

Identity in the IR is *shape-level*: two sites with the same (m, n, k)
are the same mapping instance (the solver plans shapes, not names), so
dedup merges their repeat weights and keeps the first label plus the
merged provenance.  Chains dedupe on (producer dims, consumer dims,
producer count, elementwise op).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from ..core.fusion import GemmChain
from ..core.geometry import Gemm
from .trace import CaptureResult, ChainSite, GemmSite

# Provenance lists are capped so a 96-layer capture doesn't drag
# thousands of path strings around; the count is always exact.
_MAX_PROVENANCE = 4


@dataclasses.dataclass(frozen=True)
class ProgramGemm:
    """One deduped GEMM mapping instance of a program."""

    gemm: Gemm
    weight: int
    label: str
    provenance: tuple[str, ...] = ()

    @property
    def dims(self) -> tuple[int, int, int]:
        return self.gemm.dims


@dataclasses.dataclass(frozen=True)
class ProgramChain:
    """One deduped fusable chain of a program."""

    chain: GemmChain
    weight: int
    label: str = ""
    provenance: tuple[str, ...] = ()

    @property
    def key(self) -> tuple:
        c = self.chain
        return (c.producer.dims, c.consumer.dims, c.producer_count,
                c.elementwise)


@dataclasses.dataclass
class PlanProgram:
    """Weighted GEMM + chain multisets of one program (the planning IR)."""

    name: str
    gemms: list[ProgramGemm]
    chains: list[ProgramChain] = dataclasses.field(default_factory=list)
    source: str = "capture"        # "capture" | "enumerated"

    # ------------------------------------------------------ constructors
    @classmethod
    def from_capture(cls, result: CaptureResult, *,
                     name: str | None = None) -> "PlanProgram":
        """Dedupe a raw jaxpr harvest into the IR."""
        prog = cls(name=name or result.name, gemms=[], chains=[],
                   source="capture")
        prog._merge_sites(result.sites)
        prog._merge_chain_sites(result.chains)
        return prog

    @classmethod
    def from_rows(cls, name: str,
                  rows: Iterable[tuple[str, Gemm, int]],
                  chain_rows: Iterable[tuple[str, GemmChain, int]] = (),
                  *, source: str = "enumerated") -> "PlanProgram":
        """Wrap hand-enumerated (type, Gemm/GemmChain, weight) rows."""
        prog = cls(name=name, gemms=[], chains=[], source=source)
        for gtype, gemm, w in rows:
            prog._add_gemm(gemm, w, gtype, ())
        for ctype, chain, w in chain_rows:
            prog._add_chain(chain, w, ctype, ())
        return prog

    # ---------------------------------------------------------- builders
    def _add_gemm(self, gemm: Gemm, weight: int, label: str,
                  provenance: tuple[str, ...]) -> None:
        for i, pg in enumerate(self.gemms):
            if pg.dims == gemm.dims:
                prov = pg.provenance
                if len(prov) < _MAX_PROVENANCE:
                    prov = prov + provenance[:_MAX_PROVENANCE - len(prov)]
                self.gemms[i] = dataclasses.replace(
                    pg, weight=pg.weight + weight, provenance=prov)
                return
        self.gemms.append(ProgramGemm(
            gemm=gemm, weight=weight, label=label,
            provenance=provenance[:_MAX_PROVENANCE]))

    def _add_chain(self, chain: GemmChain, weight: int, label: str,
                   provenance: tuple[str, ...]) -> None:
        key = (chain.producer.dims, chain.consumer.dims,
               chain.producer_count, chain.elementwise)
        for i, pc in enumerate(self.chains):
            if pc.key == key:
                prov = pc.provenance
                if len(prov) < _MAX_PROVENANCE:
                    prov = prov + provenance[:_MAX_PROVENANCE - len(prov)]
                self.chains[i] = dataclasses.replace(
                    pc, weight=pc.weight + weight, provenance=prov)
                return
        self.chains.append(ProgramChain(
            chain=chain, weight=weight, label=label,
            provenance=provenance[:_MAX_PROVENANCE]))

    def _merge_sites(self, sites: Sequence[GemmSite]) -> None:
        for idx, s in enumerate(sites):
            label = s.path.rsplit("/", 1)[-1] or f"dot{idx}"
            self._add_gemm(Gemm(*s.dims, name=label), s.weight, label,
                           (s.path,))

    def _merge_chain_sites(self, sites: Sequence[ChainSite]) -> None:
        for idx, s in enumerate(sites):
            label = s.path.rsplit("/", 1)[-1] or f"chain{idx}"
            chain = GemmChain(
                producer=Gemm(*s.producer_dims, name=f"{label}_producer"),
                consumer=Gemm(*s.consumer_dims, name=f"{label}_consumer"),
                producer_count=s.producer_count,
                elementwise=s.elementwise,
                name=f"{self.name}/{label}")
            self._add_chain(chain, s.weight, label, (s.path,))

    def merged(self, other: "PlanProgram",
               name: str | None = None) -> "PlanProgram":
        """Union of two programs with weights summed (e.g. prefill +
        decode phases of one deployment)."""
        out = PlanProgram(
            name=name or f"{self.name}+{other.name}",
            gemms=list(self.gemms), chains=list(self.chains),
            source=self.source if self.source == other.source else "mixed")
        for pg in other.gemms:
            out._add_gemm(pg.gemm, pg.weight, pg.label, pg.provenance)
        for pc in other.chains:
            out._add_chain(pc.chain, pc.weight, pc.label, pc.provenance)
        return out

    # ------------------------------------------------------------- views
    def gemm_rows(self) -> list[tuple[str, Gemm, int]]:
        """(type, Gemm, weight) rows — the planner.batch input protocol."""
        return [(pg.label, pg.gemm, pg.weight) for pg in self.gemms]

    def chain_rows(self) -> list[tuple[str, GemmChain, int]]:
        return [(pc.label, pc.chain, pc.weight) for pc in self.chains]

    def shapes(self) -> list[tuple[int, int, int]]:
        """Distinct (M, N, K) shapes, first-seen order (prewarm sets)."""
        return [pg.dims for pg in self.gemms]

    def chain_shapes(self) -> list[tuple[int, int, int, int]]:
        """Distinct (M, FF, K, N2) fused-chain shapes (prewarm sets)."""
        out, seen = [], set()
        for pc in self.chains:
            c = pc.chain
            dims = (c.M, c.inter_width, c.producer.Lz, c.consumer.Ly)
            if dims not in seen:
                seen.add(dims)
                out.append(dims)
        return out

    def gemm_multiset(self) -> dict[tuple[int, int, int], int]:
        """{dims: total weight} — the differential-test currency."""
        out: dict[tuple[int, int, int], int] = {}
        for pg in self.gemms:
            out[pg.dims] = out.get(pg.dims, 0) + pg.weight
        return out

    def chain_multiset(self) -> dict[tuple, int]:
        out: dict[tuple, int] = {}
        for pc in self.chains:
            out[pc.key] = out.get(pc.key, 0) + pc.weight
        return out

    def total_macs(self) -> int:
        """Weighted MAC volume of the whole program."""
        return sum(pg.weight * pg.gemm.volume for pg in self.gemms)

    def summary(self) -> str:
        return (f"[program] {self.name} ({self.source}): "
                f"{len(self.gemms)} unique GEMMs "
                f"(total weight {sum(g.weight for g in self.gemms)}), "
                f"{len(self.chains)} chains, "
                f"{self.total_macs():.3e} weighted MACs")


def captured_program(fn, *example_args, name: str = "program",
                     weight: int = 1, **example_kwargs) -> PlanProgram:
    """Trace ``fn`` and dedupe the harvest into a :class:`PlanProgram`
    — the one-call front door of the capture subsystem."""
    from .trace import capture
    result = capture(fn, *example_args, name=name, weight=weight,
                     **example_kwargs)
    return PlanProgram.from_capture(result, name=name)


def programs_equal(a: PlanProgram, b: PlanProgram) -> bool:
    """Exact weighted-multiset equality over GEMMs and chains."""
    return (a.gemm_multiset() == b.gemm_multiset()
            and a.chain_multiset() == b.chain_multiset())


def diff_programs(a: PlanProgram, b: PlanProgram) -> str:
    """Human-readable multiset diff (test failure messages)."""
    lines = []
    ga, gb = a.gemm_multiset(), b.gemm_multiset()
    for dims in sorted(set(ga) | set(gb)):
        if ga.get(dims) != gb.get(dims):
            lines.append(f"  gemm {dims}: {a.name}={ga.get(dims)} "
                         f"{b.name}={gb.get(dims)}")
    ca, cb = a.chain_multiset(), b.chain_multiset()
    for key in sorted(set(ca) | set(cb)):
        if ca.get(key) != cb.get(key):
            lines.append(f"  chain {key}: {a.name}={ca.get(key)} "
                         f"{b.name}={cb.get(key)}")
    return "\n".join(lines) if lines else "  (identical)"
