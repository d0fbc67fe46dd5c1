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

Not ported yet: ``verify_step`` (speculative decoding, with the router),
and the plan store with its ``prewarm_*`` entry points.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.model import Model


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
        if plan_store is not None:
            raise NotImplementedError(
                "the plan store is not ported yet (ROADMAP A1): plans are "
                "solved at first dispatch and memoized in process")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = params["embed"]["e"].device

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
