"""Fusion-aware chained-GEMM planning (beyond-paper extension).

GOMA's objective prices each GEMM in isolation, but LLM layers execute
*chains* of dependent GEMMs — gate/up -> (silu*) -> down in the MLP block —
where the intermediate tensor's DRAM round-trip dominates energy at
prefill scale.  This module extends the exact solver to two-link chains:

  * ``GemmChain``: ``producer_count`` producers ``(M, N1, K1)`` whose
    outputs combine elementwise into one intermediate ``(M, N1)``,
    consumed as the A operand of a consumer ``(M, N2, K2=N1)`` — the
    producer's N extent ties to the consumer's K extent.
  * ``solve_chain``: exact fused optimum under the *tiling-compatibility
    constraint* — producer and consumer share an SRAM m-strip of height
    ``bm``; the producer's N-tile and the consumer's K-tile both pin to
    the full intermediate width, so the strip ``(bm, N1)`` is produced
    whole, stays SRAM-resident, and is consumed whole, never touching
    DRAM.  Implemented by enumerating ``bm`` over the divisors of M and
    reusing ``core.solver.solve`` per link with ``fixed_l1`` /
    ``require_res1`` pins (both engines, bit-identical); each per-bm
    branch is an exact zero-gap solve, the enumeration is exhaustive,
    and the unfused pair is always a fallback branch — so the chain
    certificate is zero-gap and the fused optimum is provably <= the sum
    of the independent per-GEMM optima.

Residency-credit soundness (DESIGN.md §Fusion): with the intermediate's
SRAM residency *forced* (``require_res1``) and its full footprint pinned
into the capacity constraint (``fixed_l1``), the per-link closed form
charges the producer at least one DRAM write and the consumer at least
one DRAM read per intermediate word.  The fused schedule performs
neither, so crediting exactly ``words_inter * (producer_count *
dram_write + dram_read)`` never exceeds the traffic actually elided —
the fused objective is a *conservative* (never underpriced) model of the
fused execution.  All other traffic is priced identically by the
per-link model.  The elementwise combine is unmodeled on both sides of
the comparison (GOMA prices GEMMs only).
"""
from __future__ import annotations

import dataclasses
import time

from ..obs.registry import get_registry
from ..obs.tracing import get_tracer
from .certificate import (Certificate, check_constraints,
                          effective_spatial_mode, objective_value)
from .geometry import Gemm, Mapping, divisors
from .hardware import AcceleratorSpec
from .solver import DEFAULT_ENGINE, SolveResult, solve

_REG = get_registry()

# Elementwise combines the fused kernel can realize between the links.
ELEMENTWISE_OPS = ("silu_mul", "gelu_mul", "sqrelu_mul", "identity")


@dataclasses.dataclass(frozen=True)
class GemmChain:
    """A two-link dependent-GEMM chain with an elementwise combine.

    ``producer_count`` identical-shape producers (gate and up projections
    are two) each compute ``(M, N1) = (M, K1) @ (K1, N1)``; their outputs
    combine elementwise into the intermediate ``(M, N1)``, which is the
    consumer's A operand: ``(M, N2) = (M, K2) @ (K2, N2)`` with
    ``K2 == N1`` (the producer-N / consumer-K tie).
    """

    producer: Gemm
    consumer: Gemm
    producer_count: int = 1
    elementwise: str = "silu_mul"
    name: str = ""

    def __post_init__(self):
        if self.producer.Lx != self.consumer.Lx:
            raise ValueError(
                f"chain links must share M: producer Lx={self.producer.Lx} "
                f"!= consumer Lx={self.consumer.Lx}")
        if self.producer.Ly != self.consumer.Lz:
            raise ValueError(
                f"producer N must tie to consumer K: N1={self.producer.Ly} "
                f"!= K2={self.consumer.Lz}")
        if self.producer_count < 1:
            raise ValueError("producer_count must be >= 1")
        if self.elementwise not in ELEMENTWISE_OPS:
            raise ValueError(f"unknown elementwise {self.elementwise!r}; "
                             f"expected one of {ELEMENTWISE_OPS}")

    @property
    def M(self) -> int:
        return self.producer.Lx

    @property
    def inter_width(self) -> int:
        """N1 == K2: the intermediate tensor's column extent."""
        return self.producer.Ly

    @property
    def inter_words(self) -> int:
        """Word count of the intermediate tensor (M x N1)."""
        return self.M * self.inter_width

    @property
    def total_volume(self) -> int:
        return (self.producer_count * self.producer.volume
                + self.consumer.volume)

    def describe(self) -> str:
        p, c = self.producer, self.consumer
        return (f"chain {self.name or ''} {self.producer_count}x"
                f"({p.Lx},{p.Ly},{p.Lz}) -[{self.elementwise}]-> "
                f"({c.Lx},{c.Ly},{c.Lz})")


def dram_roundtrip_credit(chain: GemmChain, hw: AcceleratorSpec) -> float:
    """Absolute pJ elided when the intermediate never touches DRAM: one
    DRAM write per producer output word plus one DRAM read by the
    consumer — the *minimum* intermediate traffic any unfused mapping
    pair incurs, hence a sound credit (module docstring)."""
    return chain.inter_words * (
        chain.producer_count * hw.ert.dram_write + hw.ert.dram_read)


def link_energy(gemm: Gemm, m: Mapping, hw: AcceleratorSpec) -> float:
    """Absolute chain-accounting energy of one solved link (pJ): the
    solver's per-MAC "energy" objective (eq. 33 + leakage eq. 30) times
    the link volume.  Recomputed from the mapping so links solved under
    an edp/le equality-fallback still sum in consistent units."""
    return objective_value(gemm, m, hw, "energy") * gemm.volume


@dataclasses.dataclass
class ChainCertificate:
    """Zero-gap optimality certificate for one chain solve.

    ``objective`` is absolute pJ over the whole chain (producer_count *
    E1 + E2, minus the residency credit when fused).  The search space is
    the union of (a) the unfused pair of independent per-GEMM optima and
    (b) for every strip height bm | M, the compatibility-constrained
    fused pair; every branch is an exact zero-gap ``solve`` and the
    enumeration is exhaustive, so UB == LB at termination.
    """

    chain_name: str
    producer_dims: tuple[int, int, int]
    consumer_dims: tuple[int, int, int]
    producer_count: int
    elementwise: str
    hw_name: str
    fused: bool
    bm: int | None                # shared SRAM m-strip height when fused
    objective: float              # chain optimum, absolute pJ
    upper_bound: float
    lower_bound: float
    unfused_objective: float      # sum of independent optima, absolute pJ
    credit: float                 # DRAM round-trip credit (pJ) when fused
    feasible: bool
    n_solves: int                 # link solves performed
    bm_candidates: int            # strip heights enumerated
    solve_time_s: float
    engine: str
    objective_kind: str = "energy"
    producer_certificate: Certificate | None = None
    consumer_certificate: Certificate | None = None

    @property
    def gap(self) -> float:
        if self.upper_bound == float("inf"):
            return float("inf")
        return self.upper_bound - self.lower_bound

    @property
    def savings(self) -> float:
        """Fraction of the unfused energy saved by the chain optimum."""
        if not self.feasible or self.unfused_objective == 0:
            return 0.0
        return 1.0 - self.objective / self.unfused_objective

    def summary(self) -> str:
        tag = f"fused(bm={self.bm})" if self.fused else "unfused"
        return (f"[chain-certificate] {self.hw_name} x "
                f"{self.chain_name or (self.producer_dims, self.consumer_dims)}: "
                f"{tag} obj={self.objective:.6g} pJ "
                f"unfused={self.unfused_objective:.6g} pJ "
                f"savings={100 * self.savings:.2f}% gap={self.gap:.3g} "
                f"solves={self.n_solves} t={self.solve_time_s:.3f}s")


@dataclasses.dataclass
class ChainSolveResult:
    producer_mapping: Mapping | None
    consumer_mapping: Mapping | None
    certificate: ChainCertificate
    producer_result: SolveResult | None = None
    consumer_result: SolveResult | None = None


def _strip_reserved_spec(chain: GemmChain, hw: AcceleratorSpec,
                         bm: int) -> AcceleratorSpec | None:
    """Producer-side spec with the *sibling* strips' SRAM words reserved.

    With ``producer_count`` producers, all strips co-reside until the
    elementwise combine; the producer solve's own capacity constraint
    charges one strip (its P footprint, res1 forced), so the remaining
    ``producer_count - 1`` are carved out of the budget here.  Returns
    None when nothing fits."""
    reserve = (chain.producer_count - 1) * bm * chain.inter_width
    if reserve == 0:
        return hw
    remaining = hw.sram_words - reserve
    if remaining <= 0:
        return None
    return dataclasses.replace(hw, sram_words=remaining)


def compatible_residency(chain: GemmChain, m1: Mapping, m2: Mapping,
                         hw: AcceleratorSpec) -> bool:
    """Independent re-check of the fused pair's compatibility constraint
    (certificate verification; mirrors what solve_chain enforces via
    fixed_l1/require_res1):

      * shared m-strip:        m1.L1[x] == m2.L1[x]
      * producer N-tile full:  m1.L1[y] == N1, P SRAM-resident
      * consumer K-tile full:  m2.L1[z] == K2, A SRAM-resident
      * capacity with all producer strips co-resident
    """
    bm = m1.L1[0]
    if m2.L1[0] != bm:
        return False
    if m1.L1[1] != chain.inter_width or not m1.res1[2]:
        return False
    if m2.L1[2] != chain.inter_width or not m2.res1[1]:
        return False
    hw1 = _strip_reserved_spec(chain, hw, bm)
    if hw1 is None:
        return False
    mode = effective_spatial_mode(hw)
    # the solved links may have fallen back to le (recorded on their
    # certificates); accept either mode here — capacity is what matters
    ok1 = (check_constraints(chain.producer, m1, hw1, spatial_mode=mode)
           or check_constraints(chain.producer, m1, hw1, spatial_mode="le"))
    ok2 = (check_constraints(chain.consumer, m2, hw, spatial_mode=mode)
           or check_constraints(chain.consumer, m2, hw, spatial_mode="le"))
    return ok1 and ok2


def solve_chain(chain: GemmChain, hw: AcceleratorSpec, *,
                objective: str = "energy",
                spatial_mode: str | None = None,
                allowed_walk01: tuple[str, ...] | None = None,
                engine: str | None = None) -> ChainSolveResult:
    """Observability wrapper over the chain search: counts the call
    (``solver.chain.calls``) and opens a ``solver.solve_chain`` span
    enclosing the per-link ``solver.solve`` spans.  See
    ``_solve_chain_impl`` for the algorithm documentation."""
    _REG.inc("solver.chain.calls")
    tr = get_tracer()
    if tr is None:
        return _solve_chain_impl(chain, hw, objective=objective,
                                 spatial_mode=spatial_mode,
                                 allowed_walk01=allowed_walk01,
                                 engine=engine)
    with tr.span("solver.solve_chain", chain=chain.name,
                 producer=list(chain.producer.dims),
                 consumer=list(chain.consumer.dims)) as sp:
        res = _solve_chain_impl(chain, hw, objective=objective,
                                spatial_mode=spatial_mode,
                                allowed_walk01=allowed_walk01,
                                engine=engine)
        sp.attrs.update(fused=res.certificate.fused,
                        feasible=res.certificate.feasible,
                        n_solves=res.certificate.n_solves)
        return res


def _solve_chain_impl(chain: GemmChain, hw: AcceleratorSpec, *,
                      objective: str = "energy",
                      spatial_mode: str | None = None,
                      allowed_walk01: tuple[str, ...] | None = None,
                      engine: str | None = None) -> ChainSolveResult:
    """Exact fused-vs-unfused chain optimum with zero-gap certificate.

    Enumerates every strip height ``bm | M``; for each, solves producer
    and consumer exactly under the compatibility pins (producer: L1 =
    (bm, N1, free) with P SRAM-resident against a sibling-strip-reduced
    budget; consumer: L1 = (bm, free, K2) with A SRAM-resident) and
    credits the intermediate's DRAM round-trip.  The unfused pair of
    independent optima is always a candidate, so the returned optimum is
    provably <= the sum of per-GEMM optima; when no strip height is
    residency-feasible the result *is* the unfused pair.

    ``allowed_walk01`` restricts the *fused* producer links' stage 0-1
    walk (the TPU adapter's Pallas-realizability constraint: strip
    accumulators cannot round-trip HBM mid-strip); the consumer's K-tile
    is pinned full, so its reduction never leaves SRAM regardless of
    walk.  The unfused baseline is deliberately NOT restricted: it is
    the sum of unconstrained per-GEMM optima, a lower bound on any
    realizable unfused execution — so when the fused branch wins it
    beats every unfused realization, never just a handicapped one.
    """
    if objective != "energy":
        raise ValueError(
            "solve_chain prices the residency credit in absolute energy; "
            "objective='edp' is not defined for chains (compute EDP from "
            "the returned mappings instead)")
    t0 = time.perf_counter()
    eng = engine if engine is not None else DEFAULT_ENGINE
    kw = dict(spatial_mode=spatial_mode, engine=eng)

    # --- unfused baseline: independent per-GEMM optima (unrestricted) -----
    n_solves = 2
    r1u = solve(chain.producer, hw, objective=objective, **kw)
    r2u = solve(chain.consumer, hw, objective=objective, **kw)
    if r1u.mapping is None or r2u.mapping is None:
        cert = ChainCertificate(
            chain_name=chain.name, producer_dims=chain.producer.dims,
            consumer_dims=chain.consumer.dims,
            producer_count=chain.producer_count,
            elementwise=chain.elementwise, hw_name=hw.name, fused=False,
            bm=None, objective=float("inf"), upper_bound=float("inf"),
            lower_bound=float("inf"), unfused_objective=float("inf"),
            credit=0.0, feasible=False, n_solves=n_solves,
            bm_candidates=0, solve_time_s=time.perf_counter() - t0,
            engine=eng)
        return ChainSolveResult(None, None, cert, r1u, r2u)

    unfused = (chain.producer_count * link_energy(chain.producer,
                                                 r1u.mapping, hw)
               + link_energy(chain.consumer, r2u.mapping, hw))
    credit = dram_roundtrip_credit(chain, hw)
    N1 = chain.inter_width

    best = unfused
    best_state: tuple | None = None     # (bm, r1, r2) when fused wins
    bm_candidates = 0
    for bm in divisors(chain.M):
        # all producer strips must fit before anything else does
        if chain.producer_count * bm * N1 > hw.sram_words:
            continue
        hw1 = _strip_reserved_spec(chain, hw, bm)
        if hw1 is None:
            continue
        bm_candidates += 1
        n_solves += 2
        r1 = solve(chain.producer, hw1, objective=objective,
                   allowed_walk01=allowed_walk01,
                   fixed_l1=(bm, N1, None),
                   require_res1=(False, False, True), **kw)
        if r1.mapping is None:
            continue
        r2 = solve(chain.consumer, hw, objective=objective,
                   fixed_l1=(bm, None, N1),
                   require_res1=(False, True, False), **kw)
        if r2.mapping is None:
            continue
        fused = (chain.producer_count * link_energy(chain.producer,
                                                    r1.mapping, hw)
                 + link_energy(chain.consumer, r2.mapping, hw)
                 - credit)
        if fused < best:
            best = fused
            best_state = (bm, r1, r2)

    elapsed = time.perf_counter() - t0
    if best_state is not None:
        bm, r1, r2 = best_state
        cert = ChainCertificate(
            chain_name=chain.name, producer_dims=chain.producer.dims,
            consumer_dims=chain.consumer.dims,
            producer_count=chain.producer_count,
            elementwise=chain.elementwise, hw_name=hw.name, fused=True,
            bm=bm, objective=best, upper_bound=best, lower_bound=best,
            unfused_objective=unfused, credit=credit, feasible=True,
            n_solves=n_solves, bm_candidates=bm_candidates,
            solve_time_s=elapsed, engine=eng,
            producer_certificate=r1.certificate,
            consumer_certificate=r2.certificate)
        return ChainSolveResult(r1.mapping, r2.mapping, cert, r1, r2)
    cert = ChainCertificate(
        chain_name=chain.name, producer_dims=chain.producer.dims,
        consumer_dims=chain.consumer.dims,
        producer_count=chain.producer_count,
        elementwise=chain.elementwise, hw_name=hw.name, fused=False,
        bm=None, objective=unfused, upper_bound=unfused,
        lower_bound=unfused, unfused_objective=unfused, credit=credit,
        feasible=True, n_solves=n_solves, bm_candidates=bm_candidates,
        solve_time_s=elapsed, engine=eng,
        producer_certificate=r1u.certificate,
        consumer_certificate=r2u.certificate)
    return ChainSolveResult(r1u.mapping, r2u.mapping, cert, r1u, r2u)


def chain_from_certificate(cert: ChainCertificate) -> GemmChain:
    """Rebuild the GemmChain a certificate describes (store verify)."""
    return GemmChain(
        producer=Gemm(*cert.producer_dims, name="producer"),
        consumer=Gemm(*cert.consumer_dims, name="consumer"),
        producer_count=cert.producer_count,
        elementwise=cert.elementwise, name=cert.chain_name)


def verify_chain(cert: ChainCertificate, hw: AcceleratorSpec,
                 producer_mapping: Mapping | None,
                 consumer_mapping: Mapping | None, *,
                 tol: float = 1e-9) -> bool:
    """Independently re-verify one stored chain solve: both link
    mappings feasible (fused: the full compatibility/residency pins via
    ``compatible_residency``), the chain objective re-derivable from the
    mappings (link energies +/- the residency credit), UB == LB, and the
    headline claim — chain optimum <= sum of independent per-GEMM
    optima.  Mirrors ``core.certificate.verify`` for single GEMMs."""
    if not cert.feasible:
        return producer_mapping is None or consumer_mapping is None
    if producer_mapping is None or consumer_mapping is None:
        return False
    chain = chain_from_certificate(cert)
    m1, m2 = producer_mapping, consumer_mapping
    if cert.fused:
        if not compatible_residency(chain, m1, m2, hw):
            return False
        if cert.bm is None or m1.L1[0] != cert.bm:
            return False
    else:
        mode = effective_spatial_mode(hw)
        for gemm, m in ((chain.producer, m1), (chain.consumer, m2)):
            if not (check_constraints(gemm, m, hw, spatial_mode=mode)
                    or check_constraints(gemm, m, hw, spatial_mode="le")):
                return False
    energy = (chain.producer_count * link_energy(chain.producer, m1, hw)
              + link_energy(chain.consumer, m2, hw))
    if cert.fused:
        energy -= dram_roundtrip_credit(chain, hw)
    scale = max(1.0, abs(cert.objective))
    if abs(energy - cert.objective) > tol * scale:
        return False
    if cert.gap != 0.0:
        return False
    return cert.objective <= cert.unfused_objective * (1 + 1e-12)


def mlp_chain(m: int, d_ff: int, d_model: int, *,
              elementwise: str = "silu_mul", name: str = "") -> GemmChain:
    """The gated-MLP chain: gate+up ``(m, d_ff, d_model)`` twice ->
    elementwise -> down ``(m, d_model, d_ff)``."""
    return GemmChain(
        producer=Gemm(m, d_ff, d_model, f"{name}_gate_up" if name else
                      "mlp_gate_up"),
        consumer=Gemm(m, d_model, d_ff, f"{name}_down" if name else
                      "mlp_down"),
        producer_count=2, elementwise=elementwise, name=name or "mlp")
