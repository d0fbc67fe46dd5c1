"""Batched serving engine: prefill + greedy/temperature decode loop (the
counterpart of the reference's ``serving/engine.py``).

Static-shape KV caches, batched requests, and a stop-token / max-token
policy.  Beyond the static ``generate`` loop, the engine exposes its
step-level primitives — ``new_cache`` / ``prefill_chunk`` /
``decode_slots`` / ``insert_row`` / ``sample`` — which the
continuous-batching scheduler (``serving.sched``) composes into an
admission / prefill / decode loop.  PyTorch runs eagerly, so there is
nothing to compile; caches are updated in place, and the decode loop
keeps its bookkeeping on the device and synchronises with the host only
for the sparse stop-token check and the final transfer.

With a GOMA plan store (``planner.PlanStore``) the ``prewarm_*`` entry
points plan every tiling a deployment will dispatch ahead of traffic,
through the store, for the H100 (``core.hopper_mapping``); serving then
resolves every kernel plan with zero solver calls.

Not ported yet: ``verify_step`` (speculative decoding, with the router),
and ``prewarm_plans(source="capture")`` (program capture, ROADMAP A10).
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from ..models.layers import dtype_of
from ..models.model import Model
from ..obs.registry import get_registry

_REG = get_registry()
_LOG = logging.getLogger(__name__)


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 = greedy
    stop_token: int | None = None
    cache_len: int = 512


def gumbel_noise(shape, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` in fp32, drawn from
    ``generator`` (which lives on ``device``)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def gumbel_argmax(logits: torch.Tensor, temperature: float,
                  generator: torch.Generator) -> torch.Tensor:
    """Temperature sampling as Gumbel-max over the last axis.  The noise
    comes from a torch.Generator, so it cannot equal the reference's
    jax.random draws; it follows the same distribution."""
    g = gumbel_noise(logits.shape, generator, logits.device)
    return torch.argmax(logits / temperature + g, dim=-1).to(torch.int32)


def _insert_row(slot_cache: dict, row_cache: dict, slot: int) -> None:
    """Copy a B=1 cache row into slot ``slot`` of the slot-batched cache,
    in place (batch is axis 1 of every KV leaf)."""
    for key, big in slot_cache.items():
        small = row_cache[key]
        if isinstance(big, dict):
            _insert_row(big, small, slot)
        else:
            big[:, slot].copy_(small[:, 0])


class Engine:
    def __init__(self, model: Model, params: dict, cfg: ServeConfig, *,
                 plan_store=None):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = params["embed"]["e"].device
        # optional GOMA plan database (planner.PlanStore): serving
        # traffic consumes cached kernel tilings instead of solving inline
        self.plan_store = plan_store

    # ----------------------------------------------------- step-level API
    def new_cache(self, batch: int) -> dict:
        """Fresh static cache for `batch` rows at cfg.cache_len."""
        return self.model.init_cache(batch, self.cfg.cache_len,
                                     device=self.device)

    def prefill_chunk(self, cache, tokens, index: int):
        """Run one prefill chunk (B, W) at scalar write position `index`
        against an existing cache; returns (logits (B, W, V), cache)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        return self.model.decode_step(self.params, cache, tokens, index)

    def decode_slots(self, cache, tokens, positions):
        """One decode step with per-row write positions (B,); rows are
        fully independent — inactive slots may carry garbage, their
        writes land at their own (clamped) positions only.  Returns
        (logits (B, S, V), cache), the cache updated in place."""
        tokens = torch.as_tensor(tokens, device=self.device)
        positions = torch.as_tensor(positions, device=self.device)
        return self.model.decode_step(self.params, cache, tokens, positions)

    def insert_row(self, slot_cache, row_cache, slot: int):
        """Graft a B=1 prefill cache into row ``slot`` of the slot cache,
        in place; returns the slot cache."""
        _insert_row(slot_cache, row_cache, slot)
        return slot_cache

    # ------------------------------------------------------ plan prewarm
    def _store(self):
        from ..planner.store import resolve_default_store
        return (self.plan_store if self.plan_store is not None
                else resolve_default_store())

    def prewarm_plans(self, arch_id: str | None, batch: int,
                      prompt_len: int, *,
                      dtype_bytes: int | None = None,
                      source: str = "capture") -> int:
        """Pre-plan every GEMM tiling this deployment will hit (prefill at
        prompt_len + batched decode against the KV cache), through the
        plan database when one is installed.  After this, the serving loop
        never invokes the GOMA solver.  Returns #shapes planned.

        ``source="enumerated"`` reads the shape set off the hand-enumerated
        ``arch_id`` extraction tables.  ``source="capture"``, the
        reference's default, reads it off the engine's own traced
        programs; program capture is not ported yet (ROADMAP A10), so it
        raises.

        dtype_bytes defaults to the model's compute dtype — plan identity
        includes the dtype-rescaled shared-memory capacity, so prewarming
        bf16 plans for an fp32 engine would all miss at dispatch time."""
        if source == "capture":
            raise NotImplementedError(
                "prewarm_plans(source='capture') is not ported yet: "
                "ROADMAP A10 (program capture); pass source='enumerated' "
                "and an arch_id")
        if arch_id is None:
            raise ValueError(
                "prewarm_plans(source='enumerated') needs an arch_id "
                "to look up the extraction tables")
        from ..planner.batch import serving_plan_shapes
        shapes = serving_plan_shapes(arch_id, batch=batch,
                                     prompt_len=prompt_len,
                                     cache_len=self.cfg.cache_len)
        return self.prewarm_shapes(shapes, dtype_bytes=dtype_bytes)

    def prewarm_shapes(self, shapes, *,
                       dtype_bytes: int | None = None) -> int:
        """Plan an explicit (M, N, K) shape list through the installed
        store (or the in-process cache when none is).  Shared by
        ``prewarm_plans`` and the scheduler's bucketed prewarm.

        Best-effort: one unplannable shape is logged, counted under
        ``sched.prewarm_failures`` and skipped — it will solve cold at
        first dispatch instead of failing the whole prewarm.  Returns
        #shapes actually planned."""
        from ..core.hopper_mapping import plan_gemm_tiling
        from ..planner.batch import prewarm_tpu_plans
        if dtype_bytes is None:
            dtype_bytes = self.dispatch_dtype_bytes
        store = self._store()
        planned = 0
        for s in list(shapes):
            try:
                if store is None:
                    plan_gemm_tiling(*s, dtype_bytes=dtype_bytes)
                    planned += 1
                else:
                    planned += prewarm_tpu_plans(
                        [s], store, dtype_bytes=dtype_bytes)
            except Exception as e:
                _REG.inc("sched.prewarm_failures")
                _LOG.warning("prewarm failed for GEMM shape %s (%s: %s); "
                             "it will solve at dispatch", s,
                             type(e).__name__, e)
        return planned

    def prewarm_chains(self, chains, *,
                       dtype_bytes: int | None = None) -> int:
        """Plan an explicit fused-MLP chain list ((M, FF, K, N2) shapes)
        through the installed store's fused section (or the in-process
        cache).  The fused counterpart of ``prewarm_shapes``: after this,
        a ``fused_mlp``-routed model resolves every chain plan from
        cache — zero chain solves in steady state.  Best-effort, like
        ``prewarm_shapes``."""
        from ..core.hopper_mapping import plan_fused_mlp
        from ..planner.batch import prewarm_fused_plans
        if dtype_bytes is None:
            dtype_bytes = self.dispatch_dtype_bytes
        store = self._store()
        planned = 0
        for c in list(chains):
            try:
                if store is None:
                    plan_fused_mlp(*c, dtype_bytes=dtype_bytes)
                    planned += 1
                else:
                    planned += prewarm_fused_plans(
                        [c], store, dtype_bytes=dtype_bytes)
            except Exception as e:
                _REG.inc("sched.prewarm_failures")
                _LOG.warning("prewarm failed for fused chain %s (%s: %s); "
                             "it will solve at dispatch", c,
                             type(e).__name__, e)
        return planned

    def prewarm_sharded_shapes(self, shapes, *, n_chips: int,
                               dtype_bytes: int | None = None) -> int:
        """Plan an explicit (M, N, K) shape list through the installed
        store's *sharded* section: each shape gets a joint (mesh
        partition, per-chip tiling) plan for an ``n_chips`` mesh (see
        dist.mesh_solve), under the H100 dispatch identity.  Serving on a
        mesh is not ported yet (ROADMAP A13); the plans are the
        deployment artifact it will read.

        Requires a store: with none installed this is a counted no-op.
        Best-effort per shape; failures count under
        ``dist.prewarm_failures``.  Returns #shapes planned."""
        from ..planner.batch import prewarm_sharded_plans
        if dtype_bytes is None:
            dtype_bytes = self.dispatch_dtype_bytes
        store = self._store()
        if store is None:
            _LOG.warning("prewarm_sharded_shapes needs a plan store; "
                         "skipping (install one via Engine(plan_store=...) "
                         "or $GOMA_PLAN_DB)")
            _REG.inc("dist.prewarm_skipped")
            return 0
        planned = 0
        for s in list(shapes):
            try:
                planned += prewarm_sharded_plans(
                    [s], store, n_chips=n_chips, dtype_bytes=dtype_bytes)
            except Exception as e:
                _REG.inc("dist.prewarm_failures")
                _LOG.warning("sharded prewarm failed for GEMM shape %s "
                             "(%s: %s); it will co-solve at first use", s,
                             type(e).__name__, e)
        _REG.inc("dist.prewarmed", planned)
        return planned

    def prewarm_pareto_shapes(self, shapes, *,
                              dtype_bytes: int | None = None,
                              max_points: int | None = 24) -> int:
        """Build certified (energy, delay) frontiers for an explicit
        (M, N, K) shape list into the installed store's pareto section
        (under the H100 dispatch identity).  After this, latency-SLO point
        selection (``pareto_frontier`` +
        ``core.pareto.select_frontier_point``) never invokes the solver.

        Requires a store: with none installed this is a counted no-op.
        Best-effort per shape; failures count under
        ``sched.prewarm_failures``."""
        from ..planner.batch import prewarm_pareto_plans
        if dtype_bytes is None:
            dtype_bytes = self.dispatch_dtype_bytes
        store = self._store()
        if store is None:
            _LOG.warning("prewarm_pareto_shapes needs a plan store; "
                         "skipping (install one via Engine(plan_store=...) "
                         "or $GOMA_PLAN_DB)")
            _REG.inc("pareto.prewarm_skipped")
            return 0
        planned = 0
        for s in list(shapes):
            try:
                planned += prewarm_pareto_plans(
                    [s], store, dtype_bytes=dtype_bytes,
                    max_points=max_points)
            except Exception as e:
                _REG.inc("sched.prewarm_failures")
                _LOG.warning("pareto prewarm failed for GEMM shape %s "
                             "(%s: %s); skipping", s, type(e).__name__, e)
        _REG.inc("pareto.prewarmed", planned)
        return planned

    def pareto_frontier(self, M: int, N: int, K: int, *,
                        dtype_bytes: int | None = None,
                        max_points: int | None = 24):
        """The certified (energy, delay) frontier of one GEMM under its
        H100 dispatch identity, read through the installed store
        (``planner.batch.cached_solve_pareto``); a hit rehydrates the
        whole frontier with zero solver invocations."""
        from ..core.hopper_mapping import gemm_problem
        from ..planner.batch import cached_solve_pareto
        if dtype_bytes is None:
            dtype_bytes = self.dispatch_dtype_bytes
        gemm, hw, _ = gemm_problem(M, N, K, dtype_bytes=dtype_bytes)
        return cached_solve_pareto(gemm, hw, store=self._store(),
                                   max_points=max_points)

    @property
    def dispatch_dtype_bytes(self) -> int:
        """The element size of the model's compute dtype, under which its
        GEMMs dispatch (plan identity includes the dtype-rescaled
        shared-memory capacity)."""
        return dtype_of(self.model.cfg.compute_dtype).itemsize

    def validate_capacity(self, prompt_len: int, max_new_tokens: int, *,
                          prefix_len: int = 0, lookahead: int = 0) -> None:
        """Fail fast instead of silently overflowing the static cache:
        every token of prompt + generation needs a cache position."""
        need = prefix_len + prompt_len + max_new_tokens + lookahead
        if need > self.cfg.cache_len:
            raise ValueError(
                f"request needs {need} cache positions (prefix "
                f"{prefix_len} + prompt {prompt_len} + max_new_tokens "
                f"{max_new_tokens} + lookahead {lookahead}) but "
                f"cache_len={self.cfg.cache_len}; shorten the request "
                f"or raise ServeConfig.cache_len")

    # With a stop token set, the all-rows-done early exit is checked only
    # every this many steps: each check is a device->host sync.
    STOP_CHECK_EVERY = 4

    @torch.inference_mode()
    def generate(self, tokens: np.ndarray, *,
                 rng: torch.Generator | None = None) -> np.ndarray:
        """tokens: (B, S) prompt batch; returns (B, new) int32.

        Rows that hit the stop token are padded with it; columns after
        the early exit are 0.  With temperature > 0 each step draws fresh
        Gumbel noise from ``rng`` (a torch.Generator on the engine's
        device)."""
        cfg = self.cfg
        B, S = tokens.shape
        self.validate_capacity(S, cfg.max_new_tokens)
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                               device=self.device)
        logits, cache = self.model.prefill(self.params, {"tokens": toks},
                                           max_len=cfg.cache_len)
        out = torch.zeros((B, cfg.max_new_tokens), dtype=torch.int32,
                          device=self.device)
        cur = self.sample(logits[:, -1], rng)
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        fill = torch.tensor(cfg.stop_token or 0, dtype=torch.int32,
                            device=self.device)
        for t in range(cfg.max_new_tokens):
            out[:, t] = torch.where(done, fill, cur)
            if cfg.stop_token is not None:
                done = done | (cur == cfg.stop_token)
                last = t == cfg.max_new_tokens - 1
                if (t % self.STOP_CHECK_EVERY == self.STOP_CHECK_EVERY - 1
                        or last) and bool(done.all()):
                    break
            if t + 1 == cfg.max_new_tokens:
                break               # the next step's token would be unused
            logits, cache = self.model.decode_step(
                self.params, cache, cur[:, None].to(torch.int64), S + t)
            cur = self.sample(logits[:, -1], rng)
        return out.cpu().numpy()

    def sample(self, logits: torch.Tensor,
               rng: torch.Generator | None) -> torch.Tensor:
        """Greedy/temperature sampling (row-wise; rng may be None)."""
        if self.cfg.temperature <= 0.0 or rng is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return gumbel_argmax(logits, self.cfg.temperature, rng)
