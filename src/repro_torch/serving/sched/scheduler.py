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
     and is evicted on its stop token or token budget.

Outputs are token-identical to running each request alone through the
static ``Engine.generate`` oracle: chunk padding is causally masked,
slot rows are batch-independent, and the decode recurrence visits the
same (token, position) sequence — see tests/test_torch_sched.py.

Where the port differs from the reference:

- Caches are updated in place (one slot cache, one B=1 prefill cache).
- Host transfers: a decode reads back the sampled tokens and the rows'
  finite flags in one device-to-host copy (an activation does the same
  for its first token).  The chaos poison (``kernel.nan_row``) is
  written into the logits on the device before that copy.
- Temperature sampling draws each (request, token) from its own
  ``torch.Generator``, seeded from ``(rng_seed, req_id, token_idx)``, so
  a stream does not depend on what else is scheduled; it follows the
  reference's distribution but not its ``jax.random`` bits.
- Planning: with a plan store and an ``arch_id``, construction prewarms
  every bucketed GEMM tiling and fused chain through the store from the
  hand extraction tables (``prewarm_source="enumerated"``), and each
  phase resolves its plans once at first dispatch, so steady-state
  traffic makes zero solver calls.  The reference's default source,
  "capture", reads the shapes off traced programs; program capture is not
  ported yet (ROADMAP A10), so a deployment that would prewarm through it
  is refused.  ``mesh_chips > 1`` prewarms the store's sharded section;
  serving itself runs on one device (a mesh is ROADMAP A13).  Every
  ``SchedConfig`` field is kept with its default; setting one whose
  machinery is not ported raises NotImplementedError (``UNPORTED``).
"""
from __future__ import annotations

import collections
import dataclasses
import logging
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
    """The reference's fields and defaults; see UNPORTED for the ones the
    port refuses to take yet."""

    slots: int = 8
    chunk_widths: tuple[int, ...] = (8, 32, 128)
    prefill_chunks_per_step: int = 1
    max_queue: int | None = None        # admission control; None = unbounded
    temperature: float = 0.0
    stop_token: int | None = None       # default; requests may override
    rng_seed: int = 0                   # per-request sampling streams
    resolve_plans: bool = True          # resolve tile plans per phase when
    #                                     a plan store is installed
    prewarm_source: str = "capture"     # "enumerated": the bucketed GEMM
    #                                     groups from the hand extraction
    #                                     tables (arch_id); "capture" (the
    #                                     reference's traced programs) is
    #                                     refused: UNPORTED
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
    spec_width: int | None = None       # speculative decoding's window


# what a caller may set whose machinery is not ported yet: its name, a
# test of (config, constructor arguments and the engine's plan store),
# and the ROADMAP item that ports it
UNPORTED = (
    ("SchedConfig.prewarm_source='capture'",
     lambda cfg, kw: cfg.prewarm_source == "capture"
     and (kw["arch_id"] is not None or kw["plan_store"] is not None),
     "A10 (program capture); pass prewarm_source='enumerated' and an "
     "arch_id"),
    ("SchedConfig.spec_width", lambda cfg, kw: cfg.spec_width is not None,
     "A8 (speculative decoding)"),
    ("prefix_cache", lambda cfg, kw: kw["prefix_cache"] is not None,
     "A8 (the KV prefix cache)"),
    ("drafter", lambda cfg, kw: kw["drafter"] is not None,
     "A8 (speculative decoding)"),
    ("plan_groups / chain_groups",
     lambda cfg, kw: kw["plan_groups"] is not None
     or kw["chain_groups"] is not None,
     "A8 (the router's shared prewarm)"),
)


@dataclasses.dataclass
class _Prefill:
    """The in-flight chunked prefill (at most one at a time); it runs
    against the scheduler's persistent B=1 prefill cache."""

    slot: Slot
    chunks: collections.deque            # of Chunk
    padded: np.ndarray                   # (1, padded_len) prompt buffer


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
        kw = dict(prefix_cache=prefix_cache, drafter=drafter,
                  arch_id=arch_id, plan_groups=plan_groups,
                  chain_groups=chain_groups, plan_store=engine.plan_store)
        for what, is_set, item in UNPORTED:
            if is_set(cfg, kw):
                raise NotImplementedError(
                    f"{what} is not ported yet: ROADMAP {item}")
        self.engine = engine
        self.cfg = cfg
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
        if arch_id is not None:
            self.prewarmed_plans = self._prewarm(arch_id)

    # ------------------------------------------------------------ plan DB
    def _prewarm(self, arch_id: str) -> int:
        """Best-effort bucketed prewarm from the extraction tables: any
        one group failing to plan must not take down scheduler
        construction — the serving loop still works (those shapes just
        solve cold at first dispatch), so each failure is logged, counted
        (``sched.prewarm_failures``) and skipped."""
        from ...planner.batch import (bucketed_serving_fused_chain_groups,
                                      bucketed_serving_plan_shape_groups)
        if getattr(self.engine.model.cfg, "fused_mlp", False):
            # a fused-MLP model dispatches one chain plan per bucket
            # group instead of the per-GEMM gate/up/down tilings; chains
            # derive from the engine's *own* model config so prewarm
            # matches dispatch even for smoke/reduced variants
            try:
                self._chain_groups = bucketed_serving_fused_chain_groups(
                    arch_id, slots=self.cfg.slots,
                    chunk_widths=self.buckets.chunk_widths,
                    cache_len=self.engine.cfg.cache_len,
                    cfg=self.engine.model.cfg)
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
        try:
            self._plan_groups = bucketed_serving_plan_shape_groups(
                arch_id, slots=self.cfg.slots,
                chunk_widths=self.buckets.chunk_widths,
                cache_len=self.engine.cfg.cache_len)
        except Exception as e:
            self._plan_groups = {}
            _REG.inc("sched.prewarm_failures")
            _LOG.warning("plan-group derivation failed (%s: %s); GEMMs "
                         "will solve at dispatch", type(e).__name__, e)
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
        self.engine.validate_capacity(req.prompt_len, req.max_new_tokens)
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
        return None

    def _deadline_of(self, req: Request) -> float | None:
        if req.deadline_s is not None:
            return req.deadline_s
        if self.cfg.default_deadline_s is not None:
            return req.arrival_s + self.cfg.default_deadline_s
        return None

    def _expire_queue(self, now: float) -> None:
        """Drop queued requests whose deadline already passed — serving
        them would waste prefill on an answer nobody is waiting for.
        In-flight requests are never expired: once a slot is claimed the
        work is sunk and the token stream stays oracle-identical."""
        if not self.queue:
            return
        keep: collections.deque[Request] = collections.deque()
        for req in self.queue:
            dl = self._deadline_of(req)
            if dl is not None and now > dl:
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
        trace_event(f"sched.{state.value}", req_id=req.req_id)
        if self.on_finish is not None:
            self.on_finish(res)
        return res

    @property
    def busy(self) -> bool:
        return bool(self.queue) or self._prefill is not None or \
            self.slots.n_busy > 0

    # ------------------------------------------------------------ stepping
    def step(self) -> None:
        """One scheduler tick: admit -> prefill chunk(s) -> decode.

        Observability: the tick is one ``sched.tick`` span with
        ``sched.prefill_chunk`` / ``sched.decode_batch`` children;
        admission opens a detached per-request ``sched.request`` span
        that ``_emit`` closes at finish.  Registry counters mirror the
        ``ServingMetrics`` tick accounting under ``sched.*``."""
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
            trace_event("sched.watchdog", duration_s=wall,
                        budget_s=self.cfg.watchdog_tick_s)
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
        # request that expired while waiting never claims a slot)
        self._expire_queue(self.clock())

        # 1. admission: start prefilling the oldest queued request
        if self._prefill is None and self.queue and self.slots.n_free:
            req = self.queue.popleft()
            slot = self.slots.acquire(req)
            if slot.stop_token is None:     # scheduler default, resolved
                slot.stop_token = self.cfg.stop_token   # on the slot —
            #                                 the Request is never mutated
            padded_len = self.buckets.padded_len(req.prompt_len)
            buf = np.zeros((1, padded_len), np.int32)
            buf[0, :req.prompt_len] = req.tokens
            self._prefill = _Prefill(
                slot=slot,
                chunks=collections.deque(
                    self.buckets.plan_chunks(req.prompt_len)),
                padded=buf)
            _REG.inc("sched.admitted")
            tr = get_tracer()
            if tr is not None:
                self._req_spans[req.req_id] = tr.start(
                    "sched.request", detached=True, req_id=req.req_id,
                    prompt_len=req.prompt_len,
                    max_new_tokens=req.max_new_tokens)

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
        if active:
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
                nxt, finite = self._sample_rows(
                    last, {s.idx: self._step_key(s.req, s.emitted)
                           for s in active})
                active = self._guard_rows(finite, active)
            now = self.clock()
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
        trace_event("sched.errored", req_id=req.req_id,
                    n_generated=res.n_generated)
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
        """Replica-failure drain (the router's failover, ROADMAP A8):
        every *queued* request — nothing
        user-visible happened for those — is handed back for re-routing,
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
