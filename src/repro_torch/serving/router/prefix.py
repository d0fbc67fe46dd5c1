"""KV prefix cache: reuse prefilled KV rows across shared-prompt requests
(the counterpart of the reference's ``serving/router/prefix.py``).

Requests in real serving traffic overwhelmingly share prompt prefixes
(system prompts, few-shot headers, multi-turn history).  Because KV at
position ``i`` depends only on tokens ``<= i``, the KV rows a finished
prefill produced for a prompt's first ``P`` tokens are what any other
request with the same first ``P`` tokens would compute — so they can be
grafted into a fresh prefill cache and the chunks that would have
produced them skipped entirely.

Correctness constraints (why ``P`` is quantized):

- ``P`` is always a multiple of the scheduler's largest chunk width, so
  the skipped chunks are exactly the full-width chunks covering
  ``[0, P)`` and the surviving chunks' start offsets are unchanged — the
  prefill runs the same chunk shapes at the same positions, just fewer
  of them, and the grafted rows are bit for bit the rows those chunks
  would have written.
- ``P <= prompt_len - 1``, so at least one chunk always survives: the
  final chunk's logits produce the request's first token, and skipping
  it would leave nothing to sample from.
- Keys compare the *exact token prefix* (stored alongside the rows),
  not just a hash — a collision can cost a lookup, never correctness.

Entries live on the host as numpy arrays (bf16 rows as their raw 16-bit
patterns, since numpy has no bfloat16), so the cache budgets ordinary
memory, not device memory.  Unlike the reference, whose caches are
immutable arrays, ``graft`` writes the rows into the scheduler's B=1
prefill cache in place.  Host transfers: ``insert`` copies each KV leaf's
first ``P`` rows from the device once per stored entry (a key already
cached is refreshed without a copy), ``graft`` copies them back once per
hit.  Eviction is LRU under a byte budget.  Counters: ``prefix.hits`` /
``prefix.misses`` / ``prefix.inserts`` / ``prefix.evictions`` and the
``prefix.bytes`` gauge.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from ...obs.registry import get_registry

_REG = get_registry()


def _leaves(tree: dict, prefix: tuple = ()):
    """(path, tensor or array) for every leaf of a nested dict, in a
    fixed order."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], prefix + (key,))
        else:
            yield prefix + (key,), tree[key]


def _to_host(t: torch.Tensor) -> np.ndarray:
    """One device-to-host copy of ``t``; bf16 keeps its bits as int16."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


@dataclasses.dataclass
class _Entry:
    p: int                       # prefix length in tokens
    tokens: np.ndarray           # (p,) int32 — exact-match guard
    leaves: dict                 # {leaf path: host rows [:, :, :p]}
    nbytes: int


class PrefixCache:
    """LRU byte-budgeted cache of prefilled KV prefixes.

    ``chunk_width`` must equal the scheduler's largest bucket width
    (``BucketSpec.max_width``): prefix boundaries are quantized to it so
    grafting composes with chunk planning (see module docstring).
    """

    def __init__(self, chunk_width: int, *, max_bytes: int = 64 << 20):
        if chunk_width < 1:
            raise ValueError(f"chunk_width must be >= 1, got {chunk_width}")
        self.chunk_width = int(chunk_width)
        self.max_bytes = int(max_bytes)
        self._entries: collections.OrderedDict[bytes, _Entry] = \
            collections.OrderedDict()
        self._bytes = 0

    # -------------------------------------------------------------- keys
    def _boundary(self, prompt_len: int) -> int:
        """Largest quantized prefix length usable for this prompt (0 =
        prompt too short to ever hit)."""
        return ((prompt_len - 1) // self.chunk_width) * self.chunk_width

    @staticmethod
    def _key(tokens: np.ndarray) -> bytes:
        return np.ascontiguousarray(tokens, np.int32).tobytes()

    # ------------------------------------------------------------ lookup
    def lookup(self, tokens) -> tuple[int, _Entry] | None:
        """Longest cached prefix of ``tokens`` at a chunk boundary, or
        None.  Returns ``(P, entry)``; a hit refreshes LRU order."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        p = self._boundary(len(tokens))
        while p > 0:
            key = self._key(tokens[:p])
            entry = self._entries.get(key)
            if entry is not None and \
                    np.array_equal(entry.tokens, tokens[:p]):
                self._entries.move_to_end(key)
                _REG.inc("prefix.hits")
                return p, entry
            p -= self.chunk_width
        _REG.inc("prefix.misses")
        return None

    def graft(self, cache: dict, entry: _Entry) -> dict:
        """Write the cached rows into positions [0, P) (axis 2 of every KV
        leaf, see model.init_cache) of a B=1 prefill cache, in place, and
        return it.  Positions >= P keep whatever stale content they held
        — causal + valid-length masking makes them unreadable until the
        surviving chunks overwrite them, the same invariant that lets the
        scheduler reuse its prefill cache across admissions."""
        for path, big in _leaves(cache):
            rows = torch.from_numpy(entry.leaves[path])
            if big.dtype == torch.bfloat16:
                rows = rows.view(torch.bfloat16)
            big[:, :, :entry.p].copy_(rows)
        return cache

    # ------------------------------------------------------------ insert
    def insert(self, tokens, cache: dict) -> bool:
        """Offer a finished prefill's cache (B=1, rows [0, prompt_len)
        valid) keyed by the prompt's quantized prefix.  Dedups on key;
        LRU-evicts under the byte budget.  Returns True when stored."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        p = self._boundary(len(tokens))
        if p <= 0:
            return False
        key = self._key(tokens[:p])
        if key in self._entries:
            self._entries.move_to_end(key)   # refreshed, not re-copied
            return False
        shapes = [(a.shape[:2] + (p,) + a.shape[3:], a.element_size())
                  for _, a in _leaves(cache)]
        nbytes = sum(int(np.prod(s)) * size for s, size in shapes)
        if nbytes > self.max_bytes:
            _REG.inc("prefix.oversize")
            return False
        leaves = {path: _to_host(a[:, :, :p]) for path, a in _leaves(cache)}
        while self._bytes + nbytes > self.max_bytes and self._entries:
            _, old = self._entries.popitem(last=False)
            self._bytes -= old.nbytes
            _REG.inc("prefix.evictions")
        self._entries[key] = _Entry(p=p, tokens=tokens[:p].copy(),
                                    leaves=leaves, nbytes=nbytes)
        self._bytes += nbytes
        _REG.inc("prefix.inserts")
        _REG.set_gauge("prefix.bytes", self._bytes)
        return True

    # ------------------------------------------------------------- state
    def __len__(self) -> int:
        return len(self._entries)

    @property
    def bytes_used(self) -> int:
        return self._bytes
