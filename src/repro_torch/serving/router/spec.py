"""Speculative decoding: drafters + the static greedy spec-decode loop
(the counterpart of the reference's ``serving/router/spec.py``).

The soundness anchor is a property of the serving engine, not of any
drafter: ``Engine.verify_step`` decodes a width-W window in one step,
and greedy output token j is what width-1 decoding would produce after
consuming window tokens 0..j (chunked decode == sequential decode, held
in fp32; see tests).  So accepting draft tokens *while they match the
target's own greedy continuation* emits exactly the tokens target-only
greedy decoding would have emitted — drafters only decide how many
commit per step, never what gets committed.  A bad drafter costs
throughput; it cannot change a single output token.

Two drafters:

- ``NgramDrafter`` — prompt-lookup drafting: propose the continuation
  of the most recent earlier occurrence of the current n-gram suffix.
  Zero model calls, so every accepted token is pure profit; acceptance
  is high whenever generation revisits its own context (repetitive or
  cyclic text, copy-heavy spans) and harmless when it doesn't.
- ``ModelDrafter`` — a small draft model served through its own
  ``Engine``.  It keeps a single-stream KV cache teacher-forced to the
  committed context: per ``propose`` it catches up on the tokens
  committed since its last call (rejected drafts are overwritten in
  place — stale positions are masked, the same invariant the target's
  verify step relies on), then free-runs k greedy tokens.  Single-stream
  by design: use it with ``spec_generate`` or a slots=1 scheduler;
  multi-slot scheduling wants the stateless ``NgramDrafter``.

``spec_generate`` is the static-path loop (the ``Engine.generate``
counterpart): one stream, greedy only, with an adaptive verify-window
ladder — escalate width on full acceptance, drop back on any miss — so
cheap windows probe and wide windows exploit streaks.  Its output is
``Engine.generate``'s greedy stream by construction.

Where the port differs from the reference: the engine's logits are
device tensors, so the drafter and the loop take their greedy tokens
with ``torch.argmax`` on the device and read back one int per step
(``verify_step`` already returns host arrays); the draft cache is
updated in place.  Counters: ``spec.rounds`` / ``spec.drafted`` /
``spec.accepted`` / ``spec.tokens`` / ``spec.draft_steps``.
"""
from __future__ import annotations

import numpy as np
import torch

from ...obs.registry import get_registry
from ..engine import Engine

_REG = get_registry()

# default verify-window ladder (window = 1 committed + k draft tokens);
# a fixed small set keeps the plan-key count bounded
DEFAULT_WIDTHS = (2, 4, 8)


def _greedy(logits_row: torch.Tensor) -> int:
    """The greedy token of one (V,) logits row, read back to the host."""
    return int(torch.argmax(logits_row))


class NgramDrafter:
    """Prompt-lookup drafter: longest-suffix n-gram match over the
    request's own (prompt + generated) context, most recent match wins,
    proposal = the tokens that followed it, padded with the last
    proposal when the match runs out.  No model, no state."""

    model = None                     # no draft model to prewarm

    def __init__(self, n: int = 3):
        if n < 1:
            raise ValueError(f"n-gram order must be >= 1, got {n}")
        self.n = int(n)

    def propose(self, ctx, k: int) -> list[int]:
        ctx = [int(t) for t in ctx]
        L = len(ctx)
        for n in range(min(self.n, L - 1), 0, -1):
            pat = ctx[L - n:]
            for s in range(L - n - 1, -1, -1):
                if ctx[s:s + n] == pat:
                    cont = ctx[s + n:s + n + k]
                    if not cont:
                        continue     # match flush against the suffix
                    while len(cont) < k:
                        cont.append(cont[-1])
                    return cont
        return [ctx[-1]] * k if ctx else [0] * k


class ModelDrafter:
    """Draft-model drafter over a single teacher-forced KV stream.

    ``engine`` serves the draft model (typically a much smaller config
    sharing the target's tokenizer/vocab).  The drafter tracks which
    committed context its cache holds; each ``propose`` feeds only the
    delta since last time (one chunk), then free-runs ``k`` greedy
    draft steps.  Draft free-run writes land *past* the committed
    frontier and are overwritten by the next call's teacher-forced
    delta — masked until then, so a rejected draft never contaminates
    the next proposal.
    """

    def __init__(self, engine: Engine):
        self.engine = engine
        self.model = engine.model
        self._cache = None
        self._ctx: list[int] = []    # tokens the cache is committed to

    def reset(self) -> None:
        """Forget the committed context (new request).  The cache
        allocation is reused; stale rows are masked then overwritten."""
        self._ctx = []

    @torch.inference_mode()
    def propose(self, ctx, k: int) -> list[int]:
        ctx = [int(t) for t in ctx]
        if not ctx:
            return [0] * k
        if len(ctx) + k > self.engine.cfg.cache_len:
            raise ValueError(
                f"draft context {len(ctx)} + {k} proposals exceeds the "
                f"draft engine's cache_len={self.engine.cfg.cache_len}")
        if self._cache is None:
            self._cache = self.engine.new_cache(1)
        # committed-context delta: diverging history (retried/evacuated
        # request, fresh stream) truncates to the common prefix and
        # re-feeds from there — correctness never depends on the guess
        c = 0
        while c < len(self._ctx) and c < len(ctx) and \
                self._ctx[c] == ctx[c]:
            c += 1
        if c == len(ctx):            # identical context re-proposed:
            c = len(ctx) - 1         # re-feed the last token for logits
        delta = np.asarray(ctx[c:], np.int64)[None]
        logits, self._cache = self.engine.prefill_chunk(
            self._cache, delta, c)
        self._ctx = list(ctx)
        _REG.inc("spec.draft_steps")
        cur = _greedy(logits[0, delta.shape[1] - 1])
        out = [cur]
        pos = len(ctx)
        for _ in range(k - 1):
            logits, self._cache = self.engine.decode_slots(
                self._cache, np.asarray([[cur]], np.int64),
                np.asarray([pos], np.int64))
            _REG.inc("spec.draft_steps")
            cur = _greedy(logits[0, -1])
            out.append(cur)
            pos += 1
        return out


@torch.inference_mode()
def spec_generate(engine: Engine, prompt, drafter, *,
                  max_new_tokens: int | None = None,
                  stop_token: int | None = None,
                  widths: tuple[int, ...] = DEFAULT_WIDTHS) -> np.ndarray:
    """Greedy speculative decoding of one stream on the static path.

    Equal to ``Engine.generate``'s greedy output (truncated at the stop
    token): every emitted token is the target model's own greedy
    continuation read off a verify window; drafts only set the window
    contents.  The window width walks the ``widths`` ladder — up one
    rung on full acceptance, back to the bottom on any miss.

    Returns the generated tokens (1-D int32, stop token included when
    hit).
    """
    cfg = engine.cfg
    budget = cfg.max_new_tokens if max_new_tokens is None \
        else max_new_tokens
    stop = cfg.stop_token if stop_token is None else stop_token
    widths = tuple(sorted(set(int(w) for w in widths)))
    if not widths or widths[0] < 2:
        raise ValueError(f"verify widths must all be >= 2, got {widths}")
    prompt = np.asarray(prompt, np.int64).reshape(-1)
    engine.validate_capacity(len(prompt), budget,
                             lookahead=widths[-1] - 1)
    if hasattr(drafter, "reset"):
        drafter.reset()
    cache = engine.new_cache(1)
    logits, cache = engine.prefill_chunk(cache, prompt[None], 0)
    first = _greedy(logits[0, len(prompt) - 1])
    out = [first]
    _REG.inc("spec.tokens")
    pos = len(prompt)
    cur = first
    wi = 0
    while len(out) < budget and (stop is None or out[-1] != stop):
        w = widths[wi]
        k = w - 1
        d = [int(t) for t in drafter.propose(
            list(prompt) + out, k)][:k]
        while len(d) < k:
            d.append(d[-1] if d else cur)
        row = np.asarray([[cur] + d], np.int64)
        greedy, finite, cache = engine.verify_step(
            cache, row, np.asarray([pos], np.int64))
        if not bool(finite[0]):
            raise FloatingPointError(
                "non-finite logits in speculative verify step")
        g = [int(t) for t in greedy[0]]
        m = 0
        while m < k and d[m] == g[m]:
            m += 1
        _REG.inc("spec.rounds")
        _REG.inc("spec.drafted", k)
        _REG.inc("spec.accepted", m)
        for tok in g[:m + 1]:        # all target-greedy by construction
            out.append(tok)
            _REG.inc("spec.tokens")
            pos += 1
            cur = tok
            if len(out) >= budget or (stop is not None and tok == stop):
                break
        wi = min(wi + 1, len(widths) - 1) if m == k else 0
    return np.asarray(out, np.int32)
