"""Batched serving engine: prefill + greedy/temperature decode loop (the
counterpart of the reference's ``serving/engine.py``).

Static-shape KV caches, batched requests, and a stop-token / max-token
policy.  Beyond the static ``generate`` loop, the engine exposes its
step-level primitives — ``new_cache`` / ``prefill_chunk`` /
``decode_slots`` / ``insert_row`` / ``sample`` — which the
continuous-batching scheduler (``serving.sched``) composes into an
admission / prefill / decode loop.  PyTorch runs eagerly, so there is
nothing to compile (with ``ServeConfig.step_graphs`` a latent-attention
model's chunks and decode steps replay as CUDA graphs instead,
``serving.graphs``); caches are updated in place, and the decode loop
keeps its bookkeeping on the device and synchronises with the host only
for the sparse stop-token check and the final transfer.

With a GOMA plan store (``planner.PlanStore``) the ``prewarm_*`` entry
points plan every tiling a deployment will dispatch ahead of traffic,
through the store, for the H100 (``core.hopper_mapping``); serving then
resolves every kernel plan with zero solver calls.

``verify_step`` is speculative decoding's batched verify (the router's
``spec`` module and the scheduler's spec decode).

On a tensor-parallel model (``dist.serve.shard_engine``) every rank runs
the same host loop on its shard; every rank holds the full logits after
their gather, so greedy and seeded sampling pick the same token on each,
and each step checks that they do with one all_reduce of the step's
tokens.  Rank 0 prewarms the plan store first; the other ranks wait for
it and then read the plans of the same (local) shapes from it
(``rank_zero_first``, which the scheduler's prewarm takes too).
"""
from __future__ import annotations

import contextlib
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
    # replay prefill chunks and decode steps as CUDA graphs (a
    # latent-attention model on the card; ``serving.graphs``)
    step_graphs: bool = False


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


def _check_agree(agree: torch.Tensor | None) -> None:
    """Raise unless the tensor-parallel ranks' token checks so far all
    held (``agree`` is the same on every rank; None without TP)."""
    if agree is not None and not bool(agree):
        raise RuntimeError("the tensor-parallel ranks sampled different "
                           "tokens")


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
        self.graphs = None
        if cfg.step_graphs:
            from .graphs import StepGraphs
            self.graphs = StepGraphs(model, params)

    @property
    def mesh(self):
        """The mesh of a tensor-parallel model (``launch.mesh.HostMesh``);
        None on one device."""
        tp = self.model.tp
        return None if tp is None else tp.mesh

    # ----------------------------------------------------- step-level API
    def new_cache(self, batch: int) -> dict:
        """Fresh static cache for `batch` rows at cfg.cache_len."""
        return self.model.init_cache(batch, self.cfg.cache_len,
                                     device=self.device)

    def prefill_chunk(self, cache, tokens, index: int):
        """Run one prefill chunk (B, W) at scalar write position `index`
        against an existing cache; returns (logits (B, W, V), cache).
        With step graphs, the logits are the graph's, until its next
        replay."""
        tokens = torch.as_tensor(tokens, device=self.device)
        if self.graphs is not None:
            return self.graphs.run(cache, tokens, index)
        return self.model.decode_step(self.params, cache, tokens, index)

    def decode_slots(self, cache, tokens, positions):
        """One decode step with per-row write positions (B,); rows are
        fully independent — inactive slots may carry garbage, their
        writes land at their own (clamped) positions only.  Returns
        (logits (B, S, V), cache), the cache updated in place."""
        tokens = torch.as_tensor(tokens, device=self.device)
        positions = torch.as_tensor(positions, device=self.device)
        if self.graphs is not None:
            return self.graphs.run(cache, tokens, positions)
        return self.model.decode_step(self.params, cache, tokens, positions)

    @torch.inference_mode()
    def verify_step(self, cache, tokens, positions):
        """One speculative-verify step: decode ``tokens`` (B, W) — per
        row, the committed next token followed by W-1 draft tokens — at
        per-row write positions (B,), returning ``(greedy, finite,
        cache)``: ``greedy`` (B, W) int32 is the target model's greedy
        continuation after each input token, ``finite`` (B,) flags rows
        whose logits stayed finite, both host arrays.  The argmax and the
        finiteness test run on the device; only the token ids and the
        flags cross to the host, in one copy, never the (B, W, V)
        logits.  Greedy token j equals what width-1 decoding would have
        produced after consuming input tokens 0..j (held in fp32; in
        bf16 on the card the window's batched products may round
        otherwise), so accepting drafts while they match ``greedy``
        keeps the emitted stream that of target-only decoding.  On a
        tensor-parallel engine the ranks' tokens and flags are checked
        to agree (one all_reduce), and every rank raises where they do
        not."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        positions = torch.as_tensor(positions, device=self.device).long()
        logits, cache = self.model.decode_step(self.params, cache, tokens,
                                               positions)
        ok = torch.isfinite(logits)
        greedy = torch.argmax(torch.where(ok, logits, -torch.inf), dim=-1)
        both = torch.cat([greedy, ok.all(dim=-1).all(dim=-1,
                                                      keepdim=True)], 1)
        tp = self.model.tp
        if tp is not None:
            _check_agree(tp.tokens_agree(both.flatten()))
        both = both.cpu().numpy()
        return both[:, :-1].astype(np.int32), both[:, -1].astype(bool), cache

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

    def _install_store(self) -> None:
        """Install the engine's store as the process plan store, as the
        prewarm helpers do.  A capture installs it before it traces: the
        trace resolves the plans of the kernels it passes (a fused chain,
        an unfused chain's B1 tilings), and those must land in the
        store, not only in the process cache that installing it later
        would flush."""
        store = self._store()
        if store is not None:
            from ..core import hopper_mapping
            hopper_mapping.set_plan_store(store)

    def prewarm_plans(self, arch_id: str | None, batch: int,
                      prompt_len: int, *,
                      dtype_bytes: int | None = None,
                      source: str = "capture") -> int:
        """Pre-plan every GEMM tiling this deployment will hit (prefill at
        prompt_len + batched decode against the KV cache), through the
        plan database when one is installed.  After this, the serving loop
        never invokes the GOMA solver.  Returns #shapes planned.

        ``source="capture"`` (default) reads the shape set off the
        engine's *own* traced prefill/decode programs (capture.plan) — the
        plans match what this model actually dispatches, smoke variants
        included, and ``arch_id`` is only documentation.
        ``source="enumerated"`` falls back to the hand-enumerated
        ``arch_id`` extraction tables.

        dtype_bytes defaults to the model's compute dtype — plan identity
        includes the dtype-rescaled shared-memory capacity, so prewarming
        bf16 plans for an fp32 engine would all miss at dispatch time.

        On a tensor-parallel engine the capture traces the rank's local
        model, so the shapes are the local ones; rank 0 plans them into
        the store before the other ranks, which then read them (so no
        two ranks put the same plan at once)."""
        with self.rank_zero_first():
            return self._prewarm_plans(arch_id, batch, prompt_len,
                                       dtype_bytes=dtype_bytes,
                                       source=source)

    @contextlib.contextmanager
    def rank_zero_first(self):
        """On a tensor-parallel engine, the body runs on rank 0 before it
        runs on the other ranks (a barrier between): a prewarm that plans
        into the shared store on rank 0 and reads from it on the others.
        On one device, the body as it is."""
        mesh = self.mesh
        if mesh is not None and mesh.rank != 0:
            mesh.barrier()
        try:
            yield
        finally:
            if mesh is not None and mesh.rank == 0:
                mesh.barrier()

    def _prewarm_plans(self, arch_id, batch, prompt_len, *, dtype_bytes,
                       source):
        if source == "capture":
            from ..capture.plan import serving_capture_shapes
            self._install_store()
            shapes = serving_capture_shapes(self.model, batch, prompt_len,
                                            self.cfg.cache_len)
        else:
            if arch_id is None:
                raise ValueError(
                    "prewarm_plans(source='enumerated') needs an arch_id "
                    "to look up the extraction tables; only the capture "
                    "source reads everything off the model itself")
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
        dist.mesh_solve), under the H100 dispatch identity: the
        deployment artifact of the reference's GSPMD mesh.  The port's
        tensor-parallel ranks plan their local shapes through the
        ordinary read-through instead (``prewarm_plans``,
        ``rank_zero_first``).

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
                 extra_batch: dict | None = None,
                 rng: torch.Generator | None = None) -> np.ndarray:
        """tokens: (B, S) prompt batch; returns (B, new) int32.

        ``extra_batch`` goes into the prefill's batch with the tokens:
        ``frames`` (B, F, d) for the encoder-decoder, ``patches`` (B, P, d)
        for the VLM, whose P prefix positions come before the prompt's in
        the cache (and enter the capacity check and every decode
        position).  Rows that hit the stop token are padded with it;
        columns after the early exit are 0.  With temperature > 0 each
        step draws fresh Gumbel noise from ``rng`` (a torch.Generator on
        the engine's device).  On a tensor-parallel engine a step whose
        token differs between ranks raises on every rank together: at
        the first stop check after it (before the ranks' ``done`` could
        part them), else at the end of the loop."""
        cfg = self.cfg
        B, S = tokens.shape
        prefix = 0
        for k in ("patches", "frames"):
            if extra_batch and k in extra_batch and \
                    self.model.cfg.family == "vlm":
                prefix = extra_batch[k].shape[1]
        self.validate_capacity(S, cfg.max_new_tokens, prefix_len=prefix)
        batch = {"tokens": torch.as_tensor(np.asarray(tokens),
                                           dtype=torch.int64,
                                           device=self.device)}
        for k, v in (extra_batch or {}).items():
            batch[k] = torch.as_tensor(v, device=self.device)
        logits, cache = self.model.prefill(self.params, batch,
                                           max_len=cfg.cache_len)
        out = torch.zeros((B, cfg.max_new_tokens), dtype=torch.int32,
                          device=self.device)
        cur = self.sample(logits[:, -1], rng)
        tp = self.model.tp
        agree = None if tp is None else tp.tokens_agree(cur)
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        fill = torch.tensor(cfg.stop_token or 0, dtype=torch.int32,
                            device=self.device)
        for t in range(cfg.max_new_tokens):
            out[:, t] = torch.where(done, fill, cur)
            if cfg.stop_token is not None:
                done = done | (cur == cfg.stop_token)
                last = t == cfg.max_new_tokens - 1
                if (t % self.STOP_CHECK_EVERY == self.STOP_CHECK_EVERY - 1
                        or last):
                    # the ranks' `done` agree while their tokens do, so
                    # all of them leave the loop at the same step
                    _check_agree(agree)
                    if bool(done.all()):
                        break
            if t + 1 == cfg.max_new_tokens:
                break               # the next step's token would be unused
            logits, cache = self.model.decode_step(
                self.params, cache, cur[:, None].to(torch.int64),
                prefix + S + t)
            cur = self.sample(logits[:, -1], rng)
            if tp is not None:
                agree = agree & tp.tokens_agree(cur)
        _check_agree(agree)
        return out.cpu().numpy()

    def sample(self, logits: torch.Tensor,
               rng: torch.Generator | None) -> torch.Tensor:
        """Greedy/temperature sampling (row-wise; rng may be None)."""
        if self.cfg.temperature <= 0.0 or rng is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return gumbel_argmax(logits, self.cfg.temperature, rng)
