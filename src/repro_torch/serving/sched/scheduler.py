"""Continuous-batching scheduler over the step-level serving engine (the
counterpart of the reference's ``serving/sched/scheduler.py``).

One ``ContinuousScheduler`` owns a fixed pool of decode slots backed by
a single static slot-batched KV cache.  Each tick interleaves three
phases — admission, chunked prefill, batched decode — so new requests
join a running batch without draining it:

  1. **Admission**: the oldest queued request claims a free slot (free
     list, LIFO recycling) and becomes the in-flight prefill.
  2. **Chunked prefill**: up to ``prefill_chunks_per_step`` bucketed
     chunks (see ``buckets.BucketSpec``) of the in-flight request run
     against a private B=1 cache.  When the last chunk completes, the
     first token is sampled from its logits, the cache row is copied
     into the slot cache, and the slot joins the decode batch.
  3. **Decode**: one slot-indexed decode step over all slots (inactive
     rows compute garbage that per-row valid-length masking keeps
     unreadable); each active slot samples its next token, streams it,
     and is evicted on its stop token or token budget.  With a drafter
     (``serving.router.spec``) the decode is a batched verify step over
     (slots, ``spec_width``) windows instead, emitting each row's
     accepted draft tokens and one more.

With a KV prefix cache (``serving.router.prefix``) admission grafts the
cached rows of a shared prompt prefix into the prefill cache and skips
the chunks that would have computed them; every finished prefill offers
its prefix to the cache.

Outputs are token-identical to running each request alone through the
static ``Engine.generate`` oracle: chunk padding is causally masked,
slot rows are batch-independent, and the decode recurrence visits the
same (token, position) sequence — see tests/test_torch_sched.py.

Where the port differs from the reference:

- Caches are updated in place (one slot cache, one B=1 prefill cache; a
  prefix graft writes into the latter).
- Host transfers: a decode reads back the sampled tokens and the rows'
  finite flags in one device-to-host copy (an activation does the same
  for its first token, a verify step for its (slots, width) greedy
  tokens and flags).  The chaos poison (``kernel.nan_row``) is written
  into the logits on the device before that copy; in a verify step it
  clears the row's flag, as in the reference.  A prefix-cache insert
  copies the prefix rows to the host once per stored entry.
- Temperature sampling draws each (request, token) from its own
  ``torch.Generator``, seeded from ``(rng_seed, req_id, token_idx)``, so
  a stream does not depend on what else is scheduled; it follows the
  reference's distribution but not its ``jax.random`` bits.
- Planning: with a plan store (or an ``arch_id``), construction prewarms
  every bucketed GEMM tiling and fused chain through the store, and each
  phase resolves its plans once at first dispatch, so steady-state
  traffic makes zero solver calls.  With the default source, "capture",
  the GEMM groups are read off the engine model's own traced programs
  (``capture.plan.captured_serving_plan_shape_groups``), as in the
  reference; the capture installs the engine's store before it traces,
  so the plans the trace resolves as it passes the kernel wrappers land
  in the store.  ``prewarm_source="enumerated"`` reads them off the hand
  extraction tables of ``arch_id``.  With a drafter, the capture source
  takes the verify windows' groups, and a draft model's own
  ``draft.decode`` / ``draft.chunk{W}`` groups, from the traced programs
  (``captured_spec_plan_shape_groups``), as the reference does; the
  enumerated source takes the verify groups from the extraction tables
  (``planner.batch.bucketed_spec_plan_shape_groups``), where a draft
  model's programs are not.  With the fused MLP, either source adds each
  window's chain group (the chains of a ``slots * spec_width``-row
  decode), so the verify steps resolve every plan from the prewarm.  A
  replica built with the router's ``plan_groups`` / ``chain_groups``
  skips the prewarm and resolves from the donor's.  ``mesh_chips > 1``
  prewarms the store's sharded section, as in the reference.  Every
  ``SchedConfig`` field is kept with its default, and every setting is
  taken (``UNPORTED`` is empty).
- A tensor-parallel engine (``dist.serve.shard_engine``): every rank runs
  a scheduler over its own shard, and the collectives inside each pass
  need every rank to run the same pass in the same tick.  The reference
  is one controller; here the model axis's first rank ("rank 0")
  decides.  Once a tick it broadcasts its orders (``TickOrders``): its
  clock reading, which the deadline sweep of every rank reads, the
  request it admits and the slot it gives it, and its queue's and
  slots' state.  The other ranks apply them, and raise where their
  state does not match rank 0's (the run then exits non-zero on every
  rank, at the next collective at the latest).  Chunks, decode rows
  and evictions follow from that state and from the sampled tokens,
  which every decode, verify and activation checks across the ranks
  (``TensorParallel.tokens_agree``, finite flags included).  Trace time
  comes from ``tp.RankClock``, which folds rank 0's measured tick time
  into every rank's clock.  The prewarm runs on rank 0 before the other
  ranks, which then read its plans from the store
  (``Engine.rank_zero_first``).
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import struct
import time
from typing import Callable

import numpy as np
import torch

from ...faults import inject
from ...obs.registry import get_registry
from ...obs.tracing import get_tracer
from ...obs.tracing import span as _span
from ...obs.tracing import trace_event
from ..engine import Engine, gumbel_argmax
from .buckets import BucketSpec, Chunk
from .metrics import ServingMetrics
from .requests import Request, RequestResult, RequestState
from .slots import Slot, SlotManager

_REG = get_registry()
_LOG = logging.getLogger(__name__)

# Families whose cache is a pure per-layer KV tensor with batch on axis 1
# (slot grafting + slot-indexed writes assume that layout).  Recurrent
# families (rwkv/ssm/hybrid) carry cross-step state that chunked prefill
# cannot replay position-independently; encdec/vlm need frontend
# prefixes the chunk loop does not thread through.
SUPPORTED_FAMILIES = ("dense", "moe")


def ensure_supported_family(model_cfg) -> None:
    """Raise a clear ValueError at construction time when a model's
    family cannot be continuously batched, instead of failing deep in
    slot grafting."""
    fam = model_cfg.family
    if fam not in SUPPORTED_FAMILIES:
        raise ValueError(
            f"continuous batching supports families "
            f"{SUPPORTED_FAMILIES}, not {fam!r} (recurrent state / "
            f"frontend prefixes are not slot-graftable)")
    if fam == "moe" and \
            getattr(model_cfg, "moe_dispatch", "dense") == "gathered":
        # gathered dispatch computes expert capacity over the whole
        # batch: garbage rows in free slots would compete with
        # active rows for capacity, breaking row independence (and
        # with it the token-identity-to-oracle guarantee)
        raise ValueError(
            "continuous batching requires row-independent compute; "
            "moe_dispatch='gathered' couples rows through expert "
            "capacity — use moe_dispatch='dense'")


@dataclasses.dataclass
class SchedConfig:
    """The reference's fields and defaults."""

    slots: int = 8
    chunk_widths: tuple[int, ...] = (8, 32, 128)
    prefill_chunks_per_step: int = 1
    max_queue: int | None = None        # admission control; None = unbounded
    temperature: float = 0.0
    stop_token: int | None = None       # default; requests may override
    rng_seed: int = 0                   # per-request sampling streams
    resolve_plans: bool = True          # resolve tile plans per phase when
    #                                     a plan store is installed
    prewarm_source: str = "capture"     # "capture": the bucketed GEMM
    #                                     groups read off the engine
    #                                     model's traced programs;
    #                                     "enumerated": off the hand
    #                                     extraction tables (arch_id)
    mesh_chips: int = 1                 # > 1: prewarm also fills the
    #                                     store's sharded section with
    #                                     joint (partition, tiling) plans
    #                                     for every bucketed GEMM shape
    latency_slo_ns: float | None = None  # per-GEMM latency SLO: prewarm
    #                                     also builds every bucketed
    #                                     shape's certified (energy,
    #                                     delay) frontier and picks the
    #                                     cheapest point meeting the SLO
    #                                     into ``slo_points``; None keeps
    #                                     the energy-optimal plan
    # --- degradation knobs ---
    shed_on_full: bool = False          # queue full: return a terminal
    #                                     REJECTED result instead of
    #                                     raising (load shedding)
    default_deadline_s: float | None = None   # per-request deadline
    #                                     relative to arrival, applied
    #                                     when Request.deadline_s is None;
    #                                     requests still queued past it
    #                                     are EXPIRED at the next tick
    watchdog_tick_s: float | None = None      # wall-clock budget for one
    #                                     tick; slower ticks trip
    #                                     sched.watchdog_trips (detection
    #                                     only — the tick still completes)
    spec_width: int | None = None       # with a drafter installed, the
    #                                     decode phase becomes a batched
    #                                     verify step over windows of
    #                                     this width (1 committed token
    #                                     + spec_width - 1 draft tokens
    #                                     per row); accepted tokens are
    #                                     the target model's own greedy
    #                                     continuations.  Requires greedy
    #                                     sampling (temperature == 0).


# what a caller may set whose machinery is not ported yet: its name, a
# test of (config, constructor arguments and the engine's plan store),
# and the ROADMAP item that ports it.  Empty: every setting is ported.
UNPORTED = ()


@dataclasses.dataclass
class _Prefill:
    """The in-flight chunked prefill (at most one at a time); it runs
    against the scheduler's persistent B=1 prefill cache."""

    slot: Slot
    chunks: collections.deque            # of Chunk
    padded: np.ndarray                   # (1, padded_len) prompt buffer


@dataclasses.dataclass(frozen=True)
class TickOrders:
    """What rank 0 of a tensor-parallel engine decides for one tick, as
    it broadcasts it (one int64 tensor, ``now`` as its float64 bits):
    the clock reading of the tick's deadline sweep, the state it decided
    from (the queue's length and request ids' sum, the in-flight
    prefill's request, a checksum of the busy slots and their requests),
    and the request it admits (-1: none) into which slot."""

    now: float
    queued: int
    queue_ids: int
    prefill: int
    busy: int
    admit: int
    slot: int

    def encode(self) -> torch.Tensor:
        now, *rest = dataclasses.astuple(self)
        return torch.tensor(
            [struct.unpack("<q", struct.pack("<d", now))[0], *rest],
            dtype=torch.int64)

    @classmethod
    def decode(cls, t: torch.Tensor) -> "TickOrders":
        v = [int(x) for x in t.tolist()]
        return cls(struct.unpack("<d", struct.pack("<q", v[0]))[0], *v[1:])


class ContinuousScheduler:
    def __init__(self, engine: Engine, cfg: SchedConfig, *,
                 arch_id: str | None = None,
                 on_token: Callable[[Request, int], None] | None = None,
                 on_finish: Callable[[RequestResult], None] | None = None,
                 on_tick: Callable[["ContinuousScheduler"], None]
                 | None = None,
                 clock: Callable[[], float] | None = None,
                 prefix_cache=None, drafter=None,
                 plan_groups: dict | None = None,
                 chain_groups: dict | None = None):
        ensure_supported_family(engine.model.cfg)
        kw = dict(arch_id=arch_id, plan_groups=plan_groups,
                  plan_store=engine.plan_store)
        for what, is_set, item in UNPORTED:
            if is_set(cfg, kw):
                raise NotImplementedError(
                    f"{what} is not ported yet: ROADMAP {item}")
        self.engine = engine
        self.cfg = cfg
        # the tensor-parallel layout of a sharded engine: its rank 0
        # decides each tick (TickOrders)
        self._tp = engine.model.tp
        # optional KV prefix cache (serving.router.prefix): admission
        # grafts cached rows for a shared prompt prefix instead of
        # re-prefilling them
        self.prefix_cache = prefix_cache
        # optional speculative-decoding drafter (serving.router.spec)
        self.drafter = drafter
        if drafter is not None:
            if cfg.temperature > 0.0:
                raise ValueError(
                    "speculative decoding requires greedy sampling "
                    "(temperature == 0): acceptance compares drafts "
                    "against the target's greedy continuation")
            if cfg.spec_width is None or cfg.spec_width < 2:
                raise ValueError(
                    f"a drafter needs spec_width >= 2 (1 committed + "
                    f">= 1 draft token per window), got "
                    f"{cfg.spec_width!r}")
        self._lookahead = (cfg.spec_width - 1) if drafter is not None \
            else 0
        self.buckets = BucketSpec(cfg.chunk_widths)
        self.slots = SlotManager(cfg.slots)
        self.queue: collections.deque[Request] = collections.deque()
        self.metrics = ServingMetrics()
        self.results: list[RequestResult] = []
        self.on_token = on_token
        self.on_finish = on_finish
        self.on_tick = on_tick
        # per-request lifecycle spans (admit -> first token -> finish),
        # keyed by req_id; detached because they straddle many ticks
        self._req_spans: dict[int, object] = {}
        if clock is None:
            t0 = time.perf_counter()
            clock = lambda: time.perf_counter() - t0  # noqa: E731
        self.clock = clock
        self._prefill: _Prefill | None = None
        # one persistent B=1 prefill cache, reused across admissions:
        # stale content from earlier occupants is invisible (causal +
        # valid-length masking) and overwritten chunk by chunk — the
        # same invariant that lets slot rows go uncleared
        self._prefill_cache = engine.new_cache(1)
        self.rejected = 0               # admission-control rejections
        # decode state: next input token and write position per slot
        self._cur = np.zeros(cfg.slots, np.int64)
        self._pos = np.zeros(cfg.slots, np.int64)
        self.slot_cache = engine.new_cache(cfg.slots)
        # plan-store integration: prewarm every bucketed GEMM tiling now
        # so steady-state traffic never invokes the solver
        self.arch_id = arch_id
        self._plan_groups: dict[str, list[tuple[int, int, int]]] = {}
        self._chain_groups: dict[str, list[tuple[int, int, int, int]]] = {}
        self._resolved_groups: set[str] = set()
        self.prewarmed_plans = 0
        self.prewarmed_chains = 0
        self.prewarmed_sharded = 0
        self.prewarmed_pareto = 0
        # SLO-selected frontier point per bucketed GEMM shape (filled at
        # prewarm when cfg.latency_slo_ns is set; selection is fixed at
        # construction, so steady-state traffic never re-solves).  The
        # H100 spec's spatial tile is fixed, so the frontier is
        # single-point and the selected mapping IS the energy-optimal one
        # — token streams and stored plan identities are unchanged.
        self.slo_points: dict[tuple[int, int, int], object] = {}
        # a replica constructed with explicit ``plan_groups`` (the
        # router's shared one-pass prewarm) skips both derivation and
        # planning: the donor replica already pushed every group through
        # the store / in-process plan cache, so this replica only needs
        # the group dicts for its per-phase ``_resolve_plans`` calls
        # capture-source prewarm reads everything off the engine's own
        # model, so a plan-store deployment prewarms even without an
        # arch_id; enumerated prewarm needs the arch extraction tables
        if plan_groups is not None:
            self._plan_groups = dict(plan_groups)
            self._chain_groups = dict(chain_groups or {})
        elif arch_id is not None or (cfg.prewarm_source == "capture"
                                     and engine.plan_store is not None):
            with engine.rank_zero_first():
                self.prewarmed_plans = self._prewarm(arch_id)

    # ------------------------------------------------------------ plan DB
    def _prewarm(self, arch_id: str | None) -> int:
        """Best-effort bucketed prewarm: any one group failing to plan
        must not take down scheduler construction — the serving loop
        still works (those shapes just solve cold at first dispatch), so
        each failure is logged, counted (``sched.prewarm_failures``) and
        skipped."""
        from ...planner.batch import (bucketed_serving_fused_chain_groups,
                                      bucketed_serving_plan_shape_groups,
                                      bucketed_spec_plan_shape_groups)
        spec = self.drafter is not None and self.cfg.spec_width is not None
        if getattr(self.engine.model.cfg, "fused_mlp", False):
            # a fused-MLP model dispatches one chain plan per bucket
            # group instead of the per-GEMM gate/up/down tilings; chains
            # derive from the engine's *own* model config so prewarm
            # matches dispatch even for smoke/reduced variants.  A verify
            # window of width W runs the chains of a slots * W-row decode
            try:
                self._chain_groups = bucketed_serving_fused_chain_groups(
                    arch_id, slots=self.cfg.slots,
                    chunk_widths=self.buckets.chunk_widths,
                    cache_len=self.engine.cfg.cache_len,
                    cfg=self.engine.model.cfg)
                if spec:
                    w = self.cfg.spec_width
                    self._chain_groups[f"verify{w}"] = \
                        bucketed_serving_fused_chain_groups(
                            arch_id, slots=self.cfg.slots * w,
                            chunk_widths=(),
                            cache_len=self.engine.cfg.cache_len,
                            cfg=self.engine.model.cfg)["decode"]
            except Exception as e:
                self._chain_groups = {}
                _REG.inc("sched.prewarm_failures")
                _LOG.warning("fused chain-group derivation failed "
                             "(%s: %s); chains will solve at dispatch",
                             type(e).__name__, e)
            seen_chains: set[tuple[int, ...]] = set()
            for group, chains in self._chain_groups.items():
                fresh_chains = [c for c in chains
                                if c not in seen_chains]
                seen_chains.update(fresh_chains)
                if not fresh_chains:
                    continue
                try:
                    self.prewarmed_chains += \
                        self.engine.prewarm_chains(fresh_chains)
                except Exception as e:
                    _REG.inc("sched.prewarm_failures")
                    _LOG.warning("chain prewarm failed for group %r "
                                 "(%s: %s); continuing", group,
                                 type(e).__name__, e)
        capture = self.cfg.prewarm_source == "capture"
        try:
            if capture:
                # per-bucket GEMM groups read off the engine model's own
                # traced decode-step programs (chunked-prefill
                # continuations at each width + the slot-batched decode):
                # prewarmed plans match actual dispatch by construction
                from ...capture.plan import \
                    captured_serving_plan_shape_groups
                self.engine._install_store()
                self._plan_groups = captured_serving_plan_shape_groups(
                    self.engine.model, slots=self.cfg.slots,
                    chunk_widths=self.buckets.chunk_widths,
                    cache_len=self.engine.cfg.cache_len)
            else:
                self._plan_groups = bucketed_serving_plan_shape_groups(
                    arch_id, slots=self.cfg.slots,
                    chunk_widths=self.buckets.chunk_widths,
                    cache_len=self.engine.cfg.cache_len)
        except Exception as e:
            self._plan_groups = {}
            _REG.inc("sched.prewarm_failures")
            _LOG.warning("plan-group derivation failed (%s: %s); GEMMs "
                         "will solve at dispatch", type(e).__name__, e)
        if spec:
            # speculative decoding dispatches the batched verify program
            # (and, with a model drafter, the draft model's own decode
            # programs) — same bounded-group treatment and failure policy
            # as the chunk widths
            try:
                if capture:
                    from ...capture.plan import \
                        captured_spec_plan_shape_groups
                    self._plan_groups.update(
                        captured_spec_plan_shape_groups(
                            self.engine.model, batch=self.cfg.slots,
                            cache_len=self.engine.cfg.cache_len,
                            spec_widths=(self.cfg.spec_width,),
                            draft_model=getattr(self.drafter, "model",
                                                None)))
                else:
                    self._plan_groups.update(
                        bucketed_spec_plan_shape_groups(
                            arch_id, batch=self.cfg.slots,
                            spec_widths=(self.cfg.spec_width,),
                            cache_len=self.engine.cfg.cache_len))
            except Exception as e:
                _REG.inc("sched.prewarm_failures")
                _LOG.warning("spec plan-group derivation failed (%s: %s)"
                             "; verify GEMMs will solve at dispatch",
                             type(e).__name__, e)
        planned = 0
        seen: set[tuple[int, int, int]] = set()
        for group, shapes in self._plan_groups.items():
            fresh = [s for s in shapes if s not in seen]
            seen.update(fresh)
            if not fresh:
                continue
            try:
                planned += self.engine.prewarm_shapes(fresh)
            except Exception as e:
                _REG.inc("sched.prewarm_failures")
                _LOG.warning("plan prewarm failed for group %r (%s: %s); "
                             "continuing", group, type(e).__name__, e)
        if self.cfg.mesh_chips > 1 and self.engine.plan_store is not None:
            # mesh deployment: the same deduped shape union also gets
            # joint (mesh partition, per-chip tiling) plans in the
            # store's sharded section
            try:
                self.prewarmed_sharded = self.engine.prewarm_sharded_shapes(
                    sorted(seen), n_chips=self.cfg.mesh_chips)
            except Exception as e:
                _REG.inc("sched.prewarm_failures")
                _LOG.warning("sharded prewarm failed (%s: %s); partitions "
                             "will co-solve at first use",
                             type(e).__name__, e)
        if self.cfg.latency_slo_ns is not None:
            # latency-SLO deployment: build every bucketed shape's
            # certified (energy, delay) frontier and fix the per-shape
            # point selection now
            from ...core.pareto import select_frontier_point
            if self.engine.plan_store is not None:
                self.prewarmed_pareto = self.engine.prewarm_pareto_shapes(
                    sorted(seen))
            for s in sorted(seen):
                try:
                    res = self.engine.pareto_frontier(*s)
                    p = select_frontier_point(res.points,
                                              self.cfg.latency_slo_ns)
                except Exception as e:
                    _REG.inc("sched.prewarm_failures")
                    _LOG.warning("frontier selection failed for %s "
                                 "(%s: %s); energy-optimal plan kept",
                                 s, type(e).__name__, e)
                    continue
                if p is not None:
                    self.slo_points[s] = p
            _REG.inc("sched.slo_points", len(self.slo_points))
        return planned

    def _resolve_plans(self, group: str) -> None:
        """Resolve the tile plans one phase dispatches, once per group
        (first dispatch).  After the constructor's prewarm these are all
        in-process cache hits — the zero-solve steady state."""
        if group in self._resolved_groups or \
                not (self.cfg.resolve_plans and self._plan_groups):
            return
        from ...core.hopper_mapping import plan_fused_mlp, plan_gemm_tiling
        for (M, N, K) in self._plan_groups.get(group, ()):
            plan_gemm_tiling(M, N, K,
                             dtype_bytes=self.engine.dispatch_dtype_bytes)
        for (M, FF, K, N2) in self._chain_groups.get(group, ()):
            plan_fused_mlp(M, FF, K, N2,
                           dtype_bytes=self.engine.dispatch_dtype_bytes)
        self._resolved_groups.add(group)

    # ---------------------------------------------------------- admission
    def submit(self, req: Request) -> RequestResult | None:
        """Validate and enqueue.  Raises ValueError when the request can
        never fit the static cache (clear error instead of a silent
        overflow).  A full queue raises RuntimeError, unless
        ``shed_on_full`` is set — then the request is shed with an
        explicit terminal REJECTED result (returned, recorded, and
        streamed through ``on_finish`` like any other completion)."""
        self.engine.validate_capacity(req.prompt_len, req.max_new_tokens,
                                      lookahead=self._lookahead)
        padded = self.buckets.padded_len(req.prompt_len)
        if padded > self.engine.cfg.cache_len:
            raise ValueError(
                f"request {req.req_id}: bucket-padded prompt needs "
                f"{padded} cache positions but cache_len="
                f"{self.engine.cfg.cache_len}")
        if self.cfg.max_queue is not None and \
                len(self.queue) >= self.cfg.max_queue:
            self.rejected += 1
            if self.cfg.shed_on_full:
                _REG.inc("degraded.sched.shed")
                return self._finish_unstarted(
                    req, RequestState.REJECTED, self.clock())
            raise RuntimeError(
                f"admission queue full ({self.cfg.max_queue}); request "
                f"{req.req_id} rejected")
        self.queue.append(req)
        trace_event("sched.queued", req_id=req.req_id)
        return None

    def _deadline_of(self, req: Request) -> float | None:
        if req.deadline_s is not None:
            return req.deadline_s
        if self.cfg.default_deadline_s is not None:
            return req.arrival_s + self.cfg.default_deadline_s
        return None

    def _expired(self, req: Request, now: float) -> bool:
        dl = self._deadline_of(req)
        return dl is not None and now > dl

    def _expire_queue(self, now: float) -> None:
        """Drop queued requests whose deadline already passed — serving
        them would waste prefill on an answer nobody is waiting for.
        In-flight requests are never expired: once a slot is claimed the
        work is sunk and the token stream stays oracle-identical."""
        if not self.queue:
            return
        keep: collections.deque[Request] = collections.deque()
        for req in self.queue:
            if self._expired(req, now):
                _REG.inc("degraded.sched.expired")
                self._finish_unstarted(req, RequestState.EXPIRED, now)
            else:
                keep.append(req)
        self.queue = keep

    def _finish_unstarted(self, req: Request, state: RequestState,
                          now: float) -> RequestResult:
        """Terminal result for a request shed before its first token."""
        res = RequestResult(
            req_id=req.req_id, tokens=[], finish_reason=state.value,
            prompt_len=req.prompt_len, arrival_s=req.arrival_s,
            first_token_s=float("nan"), finish_s=now)
        self.results.append(res)
        self.metrics.record_result(res)
        if self.on_finish is not None:
            self.on_finish(res)
        return res

    @property
    def busy(self) -> bool:
        return bool(self.queue) or self._prefill is not None or \
            self.slots.n_busy > 0

    def state_of(self, slot: Slot) -> RequestState:
        if slot.free:
            return RequestState.FINISHED
        if self._prefill is not None and self._prefill.slot is slot:
            return RequestState.PREFILLING
        return RequestState.ACTIVE

    # ---------------------------------------------- tensor-parallel ticks
    def _orders(self, now: float) -> TickOrders:
        """This rank's decision for the tick at clock reading ``now``, from
        its state: the admission (the oldest request that survives the
        deadline sweep, into the slot the free list gives next)."""
        admit = slot = -1
        if self._prefill is None and self.slots.n_free:
            req = next((r for r in self.queue
                        if not self._expired(r, now)), None)
            if req is not None:
                admit, slot = req.req_id, self.slots._free[-1]
        return TickOrders(
            now=now, queued=len(self.queue),
            queue_ids=sum(r.req_id for r in self.queue),
            prefill=(-1 if self._prefill is None
                     else self._prefill.slot.req.req_id),
            busy=sum((s.idx + 1) * (s.req.req_id + 2)
                     for s in self.slots.busy()),
            admit=admit, slot=slot)

    def _rank0_orders(self, now: float) -> TickOrders:
        """The tick's orders of the model axis's first rank, broadcast to
        every rank of the axis (one int64 tensor), after checking that
        this rank's state is the one rank 0 decided from (so that its
        deadline sweep at rank 0's reading drops the same requests)."""
        orders = TickOrders.decode(
            self._tp.broadcast(self._orders(now).encode()))
        mine = self._orders(orders.now)
        state = ("queued", "queue_ids", "prefill", "busy")
        if any(getattr(mine, f) != getattr(orders, f) for f in state):
            raise RuntimeError(
                f"a tensor-parallel rank's scheduler state "
                f"{ {f: getattr(mine, f) for f in state} } is not rank "
                f"0's { {f: getattr(orders, f) for f in state} }")
        return orders

    def _admit(self, orders: TickOrders | None) -> tuple | None:
        """The (request, slot) this tick admits: the oldest queued request
        into the free list's next slot, or, on a tensor-parallel engine,
        rank 0's request into rank 0's slot; None when nothing is
        admitted."""
        if orders is None:
            if self._prefill is None and self.queue and self.slots.n_free:
                req = self.queue.popleft()
                return req, self.slots.acquire(req)
            return None
        if orders.admit < 0:
            return None
        req = next(r for r in self.queue if r.req_id == orders.admit)
        self.queue.remove(req)
        free = self.slots._free
        free.append(free.pop(free.index(orders.slot)))
        return req, self.slots.acquire(req)

    # ------------------------------------------------------------ stepping
    def step(self) -> None:
        """One scheduler tick: admit -> prefill chunk(s) -> decode.

        Observability: the tick is one ``sched.tick`` span with
        ``sched.admit``, ``sched.prefill_chunk``, ``sched.decode_batch``
        (or ``sched.verify_batch``) and ``sched.emit`` children, the
        decode batch's wait for its tokens in ``sched.sample``;
        ``submit`` marks a ``sched.queued`` event, admission opens a
        detached per-request ``sched.request`` span (child of the tick,
        the same ``req_id``) that ``_emit`` closes at finish.  Registry
        counters mirror the ``ServingMetrics`` tick accounting under
        ``sched.*``."""
        wall0 = time.perf_counter()
        with _span("sched.tick", tick=self.metrics.steps) as tick_sp, \
                torch.inference_mode():
            self._step_inner(tick_sp)
        wall = time.perf_counter() - wall0
        if self.cfg.watchdog_tick_s is not None and \
                wall > self.cfg.watchdog_tick_s:
            # stuck-tick watchdog: detection only — the tick already ran
            # to completion, so state is consistent
            _REG.inc("sched.watchdog_trips")
        if self.on_tick is not None:
            self.on_tick(self)

    def _step_inner(self, tick_sp) -> None:
        if not self.metrics.steps:
            self.metrics.started_s = self.clock()
        chunks_run = 0
        padded_tokens = 0
        _REG.inc("sched.ticks")
        hit = inject("sched.slow_tick")
        if hit is not None:             # chaos: stall this tick so the
            time.sleep(float(hit.payload.get("stall_s", 0.02)))  # watchdog
        #                                 has something real to catch

        # 0. deadline sweep over the queue (before admission, so a
        # request that expired while waiting never claims a slot); on a
        # tensor-parallel engine at rank 0's clock reading
        now = self.clock()
        orders = None if self._tp is None else self._rank0_orders(now)
        self._expire_queue(now if orders is None else orders.now)

        # 1. admission: start prefilling the oldest queued request (rank
        # 0's choice on a tensor-parallel engine)
        with _span("sched.admit"):
            self._admission(orders, tick_sp)

        # 2. chunked prefill of the in-flight request
        budget = max(1, self.cfg.prefill_chunks_per_step)
        while self._prefill is not None and budget > 0:
            chunk: Chunk = self._prefill.chunks.popleft()
            toks = self._prefill.padded[:, chunk.start:chunk.start
                                        + chunk.width]
            with _span("sched.prefill_chunk", width=chunk.width,
                       start=chunk.start, real=chunk.n_real):
                logits, _ = self.engine.prefill_chunk(
                    self._prefill_cache, toks, chunk.start)
            chunks_run += 1
            padded_tokens += chunk.width - chunk.n_real
            _REG.inc("sched.prefill_chunks")
            _REG.inc("sched.padded_prefill_tokens",
                     chunk.width - chunk.n_real)
            budget -= 1
            if not self._prefill.chunks:
                self._activate(self._prefill.slot, logits, chunk)
                self._prefill = None
            self._resolve_plans(f"chunk{chunk.width}")

        # 3. slot-indexed decode over the whole pool
        active = [s for s in self.slots.busy()
                  if self._prefill is None or s is not self._prefill.slot]
        decoded = False
        if active and self.drafter is not None:
            decoded = True
            active = self._decode_spec(active)
        elif active:
            decoded = True
            with _span("sched.decode_batch", rows=len(active),
                       slots=len(self.slots)):
                io = torch.as_tensor(np.stack([self._cur, self._pos]),
                                     device=self.engine.device)
                logits, _ = self.engine.decode_slots(
                    self.slot_cache, io[0][:, None], io[1])
                last = logits[:, -1]
                hit = inject("kernel.nan_row")
                if hit is not None:     # chaos: poison one active row's
                    victim = active[hit.index % len(active)].idx
                    last[victim] = float(hit.payload.get("value",
                                                         float("nan")))
                with _span("sched.sample"):
                    nxt, finite = self._sample_rows(
                        last, {s.idx: self._step_key(s.req, s.emitted)
                               for s in active})
                active = self._guard_rows(finite, active)
            now = self.clock()
            with _span("sched.emit", rows=len(active)):
                for slot in active:
                    tok = int(nxt[slot.idx])
                    self._pos[slot.idx] += 1
                    self._cur[slot.idx] = tok
                    slot.next_token = tok
                    self._emit(slot, tok, now)
            _REG.inc("sched.decode_steps")
            _REG.inc("sched.padded_decode_rows",
                     len(self.slots) - len(active))
            self._resolve_plans("decode")

        padded_rows = len(self.slots) - len(active) if decoded else 0
        if tick_sp:
            tick_sp.attrs.update(active=len(active), chunks=chunks_run,
                                 decoded=decoded)
        self.metrics.record_tick(
            active=len(active), slots=len(self.slots), decoded=decoded,
            chunks=chunks_run, padded_tokens=padded_tokens,
            padded_rows=padded_rows)
        self.metrics.finished_s = self.clock()

    def _admission(self, orders: TickOrders | None, tick_sp) -> None:
        """Step 1 of a tick: start prefilling the admitted request, if
        any, and open its ``sched.request`` span under the tick."""
        admitted = self._admit(orders)
        if admitted is None:
            return
        req, slot = admitted
        if slot.stop_token is None:     # scheduler default, resolved
            slot.stop_token = self.cfg.stop_token   # on the slot —
        #                                 the Request is never mutated
        padded_len = self.buckets.padded_len(req.prompt_len)
        buf = np.zeros((1, padded_len), np.int32)
        buf[0, :req.prompt_len] = req.tokens
        chunks = self.buckets.plan_chunks(req.prompt_len)
        if self.prefix_cache is not None:
            # KV prefix reuse: a cached prefix of P tokens (always a
            # full-chunk boundary, always < prompt_len) is grafted
            # into the prefill cache and its chunks are skipped —
            # the remaining chunks read the grafted rows through
            # attention exactly as if they had just been prefilled
            # (KV at position i depends only on tokens <= i)
            hit = self.prefix_cache.lookup(req.tokens)
            if hit is not None:
                p, entry = hit
                self.prefix_cache.graft(self._prefill_cache, entry)
                chunks = [c for c in chunks
                          if c.start + c.width > p]
                _REG.inc("sched.prefix_tokens_reused", p)
        self._prefill = _Prefill(
            slot=slot, chunks=collections.deque(chunks), padded=buf)
        _REG.inc("sched.admitted")
        tr = get_tracer()
        if tr is not None:
            self._req_spans[req.req_id] = tr.start(
                "sched.request", detached=True, parent=tick_sp,
                req_id=req.req_id, prompt_len=req.prompt_len,
                max_new_tokens=req.max_new_tokens)

    # ------------------------------------------------- speculative decode
    def _decode_spec(self, active: list[Slot]) -> list[Slot]:
        """One speculative decode round: a batched verify step over a
        (slots, spec_width) window — per active row the committed next
        token followed by spec_width - 1 drafted tokens — then per-row
        greedy acceptance.  The emitted tokens are the *target* model's
        own greedy continuations (greedy token j of the verify output is
        what width-1 decoding would produce after consuming window tokens
        0..j); drafts only decide how many of them commit this round.
        Rejected draft positions hold stale KV that per-row valid-length
        masking hides until the write frontier reclaims them — the same
        invariant that keeps recycled slot rows and bucket padding
        invisible.  Returns the surviving rows."""
        w = self.cfg.spec_width
        k = w - 1
        tokens = np.zeros((len(self.slots), w), np.int64)
        drafts: dict[int, list[int]] = {}
        for slot in active:
            ctx = list(slot.req.tokens) + slot.tokens
            d = [int(t) for t in self.drafter.propose(ctx, k)][:k]
            while len(d) < k:                 # short proposals padded —
                d.append(d[-1] if d else      # a wrong draft just stops
                         int(self._cur[slot.idx]))    # acceptance early
            drafts[slot.idx] = d
            tokens[slot.idx, 0] = self._cur[slot.idx]
            tokens[slot.idx, 1:] = d
        with _span("sched.verify_batch", rows=len(active), width=w,
                   slots=len(self.slots)):
            greedy, finite, _ = self.engine.verify_step(
                self.slot_cache, tokens, self._pos)
            hit = inject("kernel.nan_row")
            if hit is not None:     # chaos: poison one active row — the
                finite[active[hit.index % len(active)].idx] = False
        now = self.clock()          # guard below must evict it
        for slot in [s for s in active if not finite[s.idx]]:
            self._evict_errored(slot, now)
        active = [s for s in active if finite[s.idx]]
        now = self.clock()
        with _span("sched.emit", rows=len(active)):
            for slot in active:
                idx = slot.idx
                m = 0
                while m < k and drafts[idx][m] == int(greedy[idx, m]):
                    m += 1
                _REG.inc("sched.spec.rounds")
                _REG.inc("sched.spec.drafted", k)
                _REG.inc("sched.spec.accepted", m)
                for tok in greedy[idx, :m + 1]:
                    self._pos[idx] += 1
                    self._cur[idx] = int(tok)
                    slot.next_token = int(tok)
                    self._emit(slot, int(tok), now)
                    if slot.free:
                        break       # stop token / budget hit mid-window
        _REG.inc("sched.decode_steps")
        _REG.inc("sched.padded_decode_rows",
                 len(self.slots) - len(active))
        self._resolve_plans(f"verify{w}")
        return active

    # ------------------------------------------------------ fault isolation
    def _guard_rows(self, finite: np.ndarray,
                    active: list[Slot]) -> list[Slot]:
        """Evict active slots whose logits row went NaN/Inf — a poisoned
        row must never be emitted (its sample was taken over -inf-masked
        logits and is discarded here).  Only the poisoned rows pay: slot
        rows are batch-independent, so the survivors' streams are
        untouched and stay token-identical to the fault-free oracle."""
        bad = [s for s in active if not finite[s.idx]]
        if not bad:
            return active
        now = self.clock()
        for slot in bad:
            self._evict_errored(slot, now)
        return [s for s in active if finite[s.idx]]

    def _evict_errored(self, slot: Slot, now: float, *,
                       counter: str = "errors.sched.nan_row") -> None:
        """Terminal ERRORED eviction of one in-flight slot: the tokens
        streamed so far are kept, the slot is freed, the rest of the
        batch keeps decoding."""
        req = slot.req
        _REG.inc(counter)
        _REG.inc("sched.errored")
        res = RequestResult(
            req_id=req.req_id, tokens=list(slot.tokens),
            finish_reason=RequestState.ERRORED.value,
            prompt_len=req.prompt_len, arrival_s=req.arrival_s,
            first_token_s=slot.first_token_s if slot.emitted
            else float("nan"), finish_s=now)
        self.results.append(res)
        self.metrics.record_result(res)
        tr = get_tracer()
        rsp = self._req_spans.pop(req.req_id, None)
        if tr is not None and rsp is not None:
            tr.end(rsp, n_generated=res.n_generated,
                   finish_reason=res.finish_reason)
        if self.on_finish is not None:
            self.on_finish(res)
        self.slots.release(slot)

    def _activate(self, slot: Slot, logits, last_chunk: Chunk) -> None:
        """Last chunk done: sample the first token, copy the row into the
        slot cache, and join the decode batch."""
        req = slot.req
        row = logits[0, last_chunk.n_real - 1][None]
        tok, finite = self._sample_rows(row, {0: self._step_key(req, 0)})
        if not finite[0]:
            # poisoned prefill output: evict before the row ever joins
            # the decode batch (no token was emitted for it yet)
            self._evict_errored(slot, self.clock())
            return
        tok = int(tok[0])
        self.engine.insert_row(self.slot_cache, self._prefill_cache,
                               slot.idx)
        if self.prefix_cache is not None:
            # the completed prefill's rows are exact KV for this prompt:
            # offer its full-chunk prefix to future shared-prefix
            # admissions (the cache dedups / LRU-evicts internally)
            self.prefix_cache.insert(req.tokens, self._prefill_cache)
        self._pos[slot.idx] = req.prompt_len
        self._cur[slot.idx] = tok
        slot.next_token = tok
        self._emit(slot, tok, self.clock(), first=True)

    def _emit(self, slot: Slot, tok: int, now: float,
              first: bool = False) -> None:
        req = slot.req
        tr = get_tracer()
        if first:
            slot.first_token_s = now
            if tr is not None:
                rsp = self._req_spans.get(req.req_id)
                if rsp is not None:
                    tr.event("sched.first_token", parent=rsp,
                             req_id=req.req_id)
        slot.emitted += 1
        slot.tokens.append(tok)
        _REG.inc("sched.tokens")
        if self.on_token is not None:
            self.on_token(req, tok)
        stopped = slot.stop_token is not None and tok == slot.stop_token
        if stopped or slot.emitted >= req.max_new_tokens:
            res = RequestResult(
                req_id=req.req_id, tokens=list(slot.tokens),
                finish_reason="stop" if stopped else "length",
                prompt_len=req.prompt_len, arrival_s=req.arrival_s,
                first_token_s=slot.first_token_s, finish_s=now)
            self.results.append(res)
            self.metrics.record_result(res)
            _REG.inc("sched.finished")
            rsp = self._req_spans.pop(req.req_id, None)
            if tr is not None and rsp is not None:
                tr.end(rsp, n_generated=res.n_generated,
                       finish_reason=res.finish_reason)
            if self.on_finish is not None:
                self.on_finish(res)
            self.slots.release(slot)

    # ----------------------------------------------------------- failover
    def evacuate(self) -> list[Request]:
        """Replica-failure drain (the router's failover): every *queued*
        request — nothing user-visible happened for those — is handed
        back for re-routing,
        the in-flight prefill (no token emitted either) likewise, and
        decode slots that already streamed tokens are evicted as ERRORED
        with their streamed prefix kept (still oracle-identical —
        truncation, never divergence).  The scheduler is empty
        afterwards."""
        requeue = list(self.queue)
        self.queue.clear()
        if self._prefill is not None:
            pf, self._prefill = self._prefill, None
            req = pf.slot.req
            requeue.append(req)
            tr = get_tracer()
            rsp = self._req_spans.pop(req.req_id, None)
            if tr is not None and rsp is not None:
                tr.end(rsp, finish_reason="evacuated")
            self.slots.release(pf.slot)
        now = self.clock()
        for slot in self.slots.busy():
            self._evict_errored(slot, now,
                                counter="errors.sched.replica_down")
        _REG.inc("sched.evacuated", len(requeue))
        return requeue

    # ------------------------------------------------------------ sampling
    def _step_key(self, req: Request,
                  token_idx: int) -> torch.Generator | None:
        """The sampling stream of one (request, token index): a generator
        on the engine's device seeded from (rng_seed, req_id, token_idx)
        alone; None when greedy."""
        if self.cfg.temperature <= 0.0:
            return None
        seed = np.random.SeedSequence(
            [self.cfg.rng_seed, req.req_id, token_idx]).generate_state(
                1, np.uint64)[0]
        return torch.Generator(device=self.engine.device).manual_seed(
            int(seed))

    def _sample_rows(self, logits: torch.Tensor,
                     keys: dict[int, torch.Generator | None]
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Sample the rows of (R, V) logits under the scheduler's own
        temperature (the engine's knob is not consulted on this path) and
        return (tokens (R,), finite (R,)) on the host, in one transfer.

        Greedy is batch-wide argmax (bit-identical to the oracle's).
        Temperature samples each row of ``keys`` by Gumbel-max from its
        own generator; the other rows are discarded by the caller.

        Non-finite entries are masked to -inf first: argmax over NaNs
        returns an arbitrary token, and a poisoned row must never turn
        into a plausible-looking sample.  Rows that are not entirely
        finite come back flagged, and the caller evicts them."""
        ok = torch.isfinite(logits)
        masked = torch.where(ok, logits, -torch.inf)
        tokens = torch.argmax(masked, dim=-1)
        for row, gen in keys.items():
            if gen is not None:
                tokens[row] = gumbel_argmax(masked[row],
                                            self.cfg.temperature, gen)
        both = torch.stack([tokens, ok.all(dim=-1).to(torch.int64)])
        if self._tp is not None and \
                not bool(self._tp.tokens_agree(both.flatten())):
            raise RuntimeError("the tensor-parallel ranks sampled different "
                               "tokens")
        both = both.cpu().numpy()
        return both[0], both[1].astype(bool)

    # ------------------------------------------------------------- driving
    def run(self, requests=None, *, max_steps: int = 1_000_000
            ) -> list[RequestResult]:
        """Submit `requests` (optional) and tick until fully drained."""
        for req in requests or ():
            self.submit(req)
        steps = 0
        while self.busy:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"scheduler not draining after "
                                   f"{max_steps} steps")
        return self.results
