"""GOMA -> Hopper adaptation: plan the port's GEMM kernels with the exact
solver.  The counterpart of the reference's ``core/tpu_mapping.py``.

The H100 instantiates GOMA's template per plan block: HBM≙DRAM, one
CTA's shared memory≙SRAM, the 64-row register-resident compute tile
(bf16: a warpgroup's wgmma m64 accumulators; fp32: 256 threads x 4x4
accumulators, both in ``kernels/csrc/goma_tile.cuh``)≙the PE array with a
hard-wired spatial tile (``fixed_spatial = (64, 64, 1)``),
registers≙regfile.  Bypass degenerates as on the TPU (operands always
stage through shared memory), so what the solver chooses is the tile
shape under the shared-memory capacity and the walking axis.  The bf16
GEMM kernel cuts each plan block into 64-row column slices, one CTA each
(``kernels/goma_gemm.py:cta_slices``), so that wide blocks still cover
the card; the slices keep the block's k walk and its place in the walk
order.

The spec and the padding unit are parameters of every planning function,
so the same code reproduces the reference's TPU plans field for field
(``spec=TPUV5E_LIKE, pad=128``) — a free differential check — and plans
for Hopper by default (``spec=H100_LIKE, pad=HOPPER_PAD``).

Realizability constraints, as in the reference:

  * z-walk re-solve: a non-z outer walk with a partial reduction would
    need partial sums to round-trip HBM; the GEMM kernel keeps the whole
    k loop of every output inside one CTA (no split-K), so such a plan is
    re-solved restricted to ``alpha01 = z``.
  * fused strips: the fused kernel holds its two (bm, FF) strips in fp32
    shared memory while the solver counts SRAM in I/O-dtype words; a
    fused plan whose strips do not fit one CTA's shared memory on Hopper
    is recorded as unfused (the three-GEMM composition runs instead).

Plan-store read-through, as in the reference: when a store is installed
(``set_plan_store``, or lazily from ``$GOMA_PLAN_DB``), every tiling and
chain solve first consults it (``planner.batch.cached_solve`` /
``cached_solve_chain``); misses are solved once and written back, so a
fleet of processes sharing one store converges to zero inline solves.
Both realizability checks above run on the plan read from the store, as
on a fresh solve; the z-walk re-solve goes through the store too.  The
store's keys are the padded problem and the spec's physical parameters,
so TPU plans (``spec=TPUV5E_LIKE, pad=MXU``) are the reference's own
entries and Hopper plans sit beside them under keys of their own.
"""
from __future__ import annotations

import dataclasses
import functools
import os

from .fusion import ChainSolveResult, GemmChain, solve_chain
from .geometry import Gemm, Mapping
from .hardware import TPUV5E_LIKE, AcceleratorSpec, Ert
from .solver import SolveResult, solve

# The TPU's padding unit (its 128x128 MXU), for the differential check.
MXU = 128

# --- H100 (SXM) hierarchy ----------------------------------------------------
# Shared memory one CTA may use after opting in with
# cudaFuncSetAttribute: 227 KB (232,448 bytes).  The mapper may budget
# three quarters of it for its operand tiles; the rest is left for the
# kernels' k-chunk staging buffers and alignment.
SMEM_BYTES = 232448
SMEM_BUDGET = 0.75
# The CTA's compute tile: 64x64 outputs held in registers.  Plan blocks
# are multiples of it, so M and N pad to this unit.
CTA_TILE = 64
HOPPER_PAD = CTA_TILE
# Bytes the fused kernel keeps beside its two fp32 (bm, FF) strips
# (goma_fused_stage_bytes in kernels/csrc/goma_fused.cu): the larger of
# the fp32 path's k-chunk staging (goma::Stage: a transposed A chunk of
# KC x (64 + 1) and a B chunk of KC x 64, fp32, KC = 32) and the bf16
# path's TMA ring (3 stages of a 64 x 64 A tile and two 64 x 32 weight
# slices, bf16, six 8-byte mbarriers, 1 KB of alignment slack).  The bf16
# path's own strip, 64 x FF bf16, fits inside the fp32 strips.
STAGE_BYTES = max(32 * (CTA_TILE + 1) * 4 + 32 * CTA_TILE * 4,
                  3 * (64 * 64 * 2 + 2 * 64 * 32 * 2) + 6 * 8 + 1024)

# The energy table (ERT) below is a model input, not a measurement of the
# H100: Accelergy-style per-access estimates in the spirit of the
# reference's templates (HBM3 at about 3 pJ/bit, SRAM and register
# accesses and a MAC at 4 nm-class orders of magnitude).  Absolute values
# only scale the objective; tile selection depends on their ratios.  The
# cycle time is the H100 SXM's 1.98 GHz boost clock, also only a model
# input (it enters the delay model, not the energy objective).
H100_LIKE = AcceleratorSpec(
    name="h100-like",
    sram_words=int(SMEM_BYTES * SMEM_BUDGET),   # shared-memory words (int8)
    rf_words=256,                               # per-PE register budget
    num_pe=CTA_TILE * CTA_TILE,
    ert=Ert(dram_read=24.0, dram_write=24.0,    # HBM3-class (model input)
            sram_read=0.8, sram_write=0.9,
            rf_read=0.03, rf_write=0.03, macc=0.06,
            ici_read=40.0, ici_write=40.0),     # NVLink-class (model input)
    cycle_ns=1.0 / 1.98,
    allow_bypass=False,        # operands always stage through shared memory
    fixed_spatial=(CTA_TILE, CTA_TILE, 1),
)


# --- plan-store read-through ------------------------------------------------
_PLAN_STORE = None
_PLAN_STORE_RESOLVED = False


def set_plan_store(store) -> None:
    """Install (or clear, with None) the process-wide plan store.

    Changing to a *different* store flushes both in-process plan caches,
    so later lookups are served through (and recorded in) the new store;
    re-installing the current store keeps the warm caches."""
    global _PLAN_STORE, _PLAN_STORE_RESOLVED
    changed = store is not _PLAN_STORE
    _PLAN_STORE = store
    _PLAN_STORE_RESOLVED = True
    if changed:
        plan_gemm_tiling.cache_clear()
        _plan_fused_mlp.cache_clear()


def get_plan_store():
    """The installed store, lazily resolved from $GOMA_PLAN_DB once."""
    global _PLAN_STORE, _PLAN_STORE_RESOLVED
    if not _PLAN_STORE_RESOLVED:
        _PLAN_STORE_RESOLVED = True
        if os.environ.get("GOMA_PLAN_DB", "").strip():
            from ..planner.store import resolve_default_store
            _PLAN_STORE = resolve_default_store()
    return _PLAN_STORE


def _solve(gemm: Gemm, hw: AcceleratorSpec,
           allowed_walk01: tuple[str, ...] | None) -> SolveResult:
    store = get_plan_store()
    if store is not None:
        from ..planner.batch import cached_solve
        return cached_solve(gemm, hw, objective="energy",
                            allowed_walk01=allowed_walk01, store=store,
                            warm_start=True)
    return solve(gemm, hw, objective="energy",
                 allowed_walk01=allowed_walk01)


def _solve_chain(chain: GemmChain, hw: AcceleratorSpec) -> ChainSolveResult:
    store = get_plan_store()
    if store is not None:
        from ..planner.batch import cached_solve_chain
        return cached_solve_chain(chain, hw, objective="energy",
                                  allowed_walk01=("z",), store=store)
    return solve_chain(chain, hw, objective="energy", allowed_walk01=("z",))


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class TpuTilePlan:
    """A GOMA-solved tiling for C[M,N] = A[M,K] @ B[K,N] (the reference's
    name is kept so the two packages' plans compare field for field)."""

    M: int
    N: int
    K: int
    padded: tuple[int, int, int]
    block: tuple[int, int, int]       # (bm, bn, bk) = SRAM (L1) tile
    grid_order: tuple[str, ...]       # outer -> inner grid dims
    walk: str                         # GOMA's alpha_{0-1}
    objective: float                  # modeled pJ / MAC
    solve_time_s: float

    @property
    def grid(self) -> tuple[int, ...]:
        pm, pn, pk = self.padded
        bm, bn, bk = self.block
        sizes = {"m": pm // bm, "n": pn // bn, "k": pk // bk}
        return tuple(sizes[g] for g in self.grid_order)


def scaled_spec(dtype_bytes: int = 2,
                base: AcceleratorSpec = H100_LIKE) -> AcceleratorSpec:
    """Rescale a spec's SRAM word capacity to the compute dtype (the
    reference's ``tpu_spec`` with the base spec as a parameter)."""
    return dataclasses.replace(
        base,
        name=f"{base.name}-{dtype_bytes}B",
        sram_words=base.sram_words // dtype_bytes,
        rf_words=base.rf_words,
    )


def gemm_problem(M: int, N: int, K: int, *, dtype_bytes: int = 2,
                 spec: AcceleratorSpec = H100_LIKE, pad: int = HOPPER_PAD
                 ) -> tuple[Gemm, AcceleratorSpec, tuple[int, int, int]]:
    """The (padded Gemm, spec, padded dims) GOMA instance of one GEMM —
    the counterpart of the reference's ``tpu_problem``."""
    pm, pn = _pad_to(M, pad), _pad_to(N, pad)
    pk = _pad_to(K, pad) if K >= pad else K
    hw = scaled_spec(dtype_bytes, spec)
    return Gemm(pm, pn, pk, f"gemm_{M}x{N}x{K}"), hw, (pm, pn, pk)


def plan_from_mapping(M: int, N: int, K: int,
                      padded: tuple[int, int, int], m: Mapping, *,
                      objective: float = float("nan"),
                      solve_time_s: float = 0.0) -> TpuTilePlan:
    """Materialize a TpuTilePlan from a solved mapping: GOMA's walking
    axis is the innermost grid dim."""
    bm, bn, bk = m.L1
    axis_of = {"x": "m", "y": "n", "z": "k"}
    inner = axis_of[m.alpha01]
    order = [g for g in ("m", "n", "k") if g != inner] + [inner]
    return TpuTilePlan(M=M, N=N, K=K, padded=padded,
                       block=(bm, bn, bk), grid_order=tuple(order),
                       walk=m.alpha01, objective=objective,
                       solve_time_s=solve_time_s)


@dataclasses.dataclass(frozen=True)
class FusedTilePlan:
    """A GOMA-chain-solved tiling for the fused gated-MLP op:
    ``out[M,N2] = act(A@Wg, A@Wu) @ Wd`` with A ``(M,K)``, Wg/Wu
    ``(K,FF)``, Wd ``(FF,N2)`` and the ``(bm, FF)`` intermediate strips
    held on chip.

    ``fused=False`` records that no strip height was realizable (or the
    chain solver kept the unfused pair): callers run the three-GEMM
    composition instead.
    """

    M: int
    FF: int
    K: int
    N2: int
    padded: tuple[int, int, int, int]     # (pm, pff, pk, pn2)
    fused: bool
    bm: int                               # shared m-strip height
    bk: int                               # producer reduction tile
    objective: float                      # chain objective, absolute pJ
    unfused_objective: float
    solve_time_s: float

    @property
    def grid(self) -> tuple[int, int]:
        pm, pff, pk, pn2 = self.padded
        return (pm // self.bm, pk // self.bk)

    def producer_plan(self) -> TpuTilePlan:
        """The single-GEMM tiling of one producer link that the fused
        kernel must bit-match (full-width N block, same bm/bk, k-walk)."""
        pm, pff, pk, pn2 = self.padded
        return TpuTilePlan(M=self.M, N=self.FF, K=self.K,
                           padded=(pm, pff, pk),
                           block=(self.bm, pff, self.bk),
                           grid_order=("m", "n", "k"), walk="z",
                           objective=float("nan"), solve_time_s=0.0)

    def consumer_plan(self) -> TpuTilePlan:
        """The consumer link's tiling: the K tile is the full intermediate
        width (nk == 1), one dot per block as in the fused kernel."""
        pm, pff, pk, pn2 = self.padded
        return TpuTilePlan(M=self.M, N=self.N2, K=self.FF,
                           padded=(pm, pn2, pff),
                           block=(self.bm, pn2, pff),
                           grid_order=("m", "n", "k"), walk="z",
                           objective=float("nan"), solve_time_s=0.0)


def fused_smem_bytes(bm: int, pff: int) -> int:
    """Shared memory the fused kernel needs for one m-strip: two (bm, pff)
    fp32 strips plus the k-chunk staging buffers."""
    return 2 * bm * pff * 4 + STAGE_BYTES


def fused_mlp_problem(M: int, FF: int, K: int, N2: int | None = None, *,
                      dtype_bytes: int = 2,
                      spec: AcceleratorSpec = H100_LIKE,
                      pad: int = HOPPER_PAD):
    """The (padded GemmChain, spec, padded dims) chain instance of a fused
    MLP.  FF is both the producer's N and the consumer's K, so it always
    pads to the unit (the intermediate is a GEMM output)."""
    if N2 is None:
        N2 = K
    pm, pff, pn2 = _pad_to(M, pad), _pad_to(FF, pad), _pad_to(N2, pad)
    pk = _pad_to(K, pad) if K >= pad else K
    hw = scaled_spec(dtype_bytes, spec)
    chain = GemmChain(
        producer=Gemm(pm, pff, pk, f"fused_{M}x{FF}x{K}_gate_up"),
        consumer=Gemm(pm, pn2, pff, f"fused_{M}x{FF}x{K}_down"),
        producer_count=2, elementwise="silu_mul",
        name=f"fused_mlp_{M}x{FF}x{K}x{N2}")
    return chain, hw, (pm, pff, pk, pn2)


def plan_fused_mlp(M: int, FF: int, K: int, N2: int | None = None, *,
                   dtype_bytes: int = 2,
                   spec: AcceleratorSpec = H100_LIKE,
                   pad: int = HOPPER_PAD) -> FusedTilePlan:
    """GOMA-chain-optimal fused-MLP tiling (bm, bk).

    The fused producer links are solved under ``allowed_walk01=("z",)``:
    the strips accumulate on chip across the k walk, so a non-z outer
    walk is not expressible.  On Hopper a fused plan whose fp32 strips
    exceed one CTA's shared memory is recorded as unfused, whether the
    chain plan was solved here or read from the plan store."""
    return _plan_fused_mlp(M, FF, K, K if N2 is None else N2,
                           dtype_bytes=dtype_bytes, spec=spec, pad=pad)


@functools.lru_cache(maxsize=512)
def _plan_fused_mlp(M: int, FF: int, K: int, N2: int, *, dtype_bytes: int,
                    spec: AcceleratorSpec, pad: int) -> FusedTilePlan:
    chain, hw, padded = fused_mlp_problem(M, FF, K, N2,
                                          dtype_bytes=dtype_bytes,
                                          spec=spec, pad=pad)
    res = _solve_chain(chain, hw)
    cert = res.certificate
    fused = bool(cert.fused) and res.producer_mapping is not None
    bm = int(res.producer_mapping.L1[0]) if fused else 0
    bk = int(res.producer_mapping.L1[2]) if fused else 0
    objective = cert.objective
    if fused and spec.name == H100_LIKE.name and \
            fused_smem_bytes(bm, padded[1]) > SMEM_BYTES:
        fused, bm, bk = False, 0, 0
        objective = cert.unfused_objective
    return FusedTilePlan(M=M, FF=FF, K=K, N2=N2, padded=padded,
                         fused=fused, bm=bm, bk=bk,
                         objective=objective,
                         unfused_objective=cert.unfused_objective,
                         solve_time_s=cert.solve_time_s)


@functools.lru_cache(maxsize=512)
def plan_gemm_tiling(M: int, N: int, K: int, *, dtype_bytes: int = 2,
                     spec: AcceleratorSpec = H100_LIKE,
                     pad: int = HOPPER_PAD) -> TpuTilePlan:
    """GOMA-optimal (bm, bn, bk) and grid order for a padded GEMM.

    M and N pad to ``pad`` (a multiple of the spec's spatial tile); K pads
    too once it reaches the unit.  Every tile is a divisor of its padded
    dim, so the kernels never mask.  With a plan store installed the solve
    is read through it (see set_plan_store)."""
    gemm, hw, padded = gemm_problem(M, N, K, dtype_bytes=dtype_bytes,
                                    spec=spec, pad=pad)
    pk = padded[2]
    res = _solve(gemm, hw, None)
    m = res.mapping
    if m is None:
        raise ValueError(f"no feasible {spec.name} mapping for {gemm}")
    if m.alpha01 != "z" and m.L1[2] < pk:
        # partial sums would round-trip HBM: not expressible in one launch
        res = _solve(gemm, hw, ("z",))
        m = res.mapping
    return plan_from_mapping(M, N, K, padded, m,
                             objective=res.certificate.objective,
                             solve_time_s=res.certificate.solve_time_s)


__all__ = ["CTA_TILE", "FusedTilePlan", "H100_LIKE", "HOPPER_PAD", "MXU",
           "SMEM_BUDGET", "SMEM_BYTES", "STAGE_BYTES", "TPUV5E_LIKE",
           "TpuTilePlan", "fused_mlp_problem", "fused_smem_bytes",
           "gemm_problem", "get_plan_store", "plan_from_mapping",
           "plan_fused_mlp", "plan_gemm_tiling", "scaled_spec",
           "set_plan_store"]
