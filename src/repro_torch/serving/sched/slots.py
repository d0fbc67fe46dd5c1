"""Slot-based KV-cache bookkeeping.

The decode batch has a fixed number of rows ("slots") in one static
slot-batched cache; each slot independently carries a request through
PREFILLING -> ACTIVE -> eviction.  Freed slots go back on a free list
and are recycled by admission — the cache row itself is never cleared
(the next occupant's prefill overwrites it, and per-row valid-length
masking hides any stale tail).
"""
from __future__ import annotations

import dataclasses

from .requests import Request


@dataclasses.dataclass
class Slot:
    idx: int
    req: Request | None = None
    emitted: int = 0      # generated tokens streamed so far
    next_token: int = 0   # sampled but not yet fed back
    stop_token: int | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    first_token_s: float = 0.0

    @property
    def free(self) -> bool:
        return self.req is None


class SlotManager:
    """Fixed slot pool with LIFO free-list recycling."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"need >= 1 slot, got {n_slots}")
        self.slots = [Slot(i) for i in range(n_slots)]
        self._free = list(range(n_slots - 1, -1, -1))   # pop() -> slot 0 first

    def __len__(self) -> int:
        return len(self.slots)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_busy(self) -> int:
        return len(self.slots) - len(self._free)

    def acquire(self, req: Request) -> Slot | None:
        if not self._free:
            return None
        slot = self.slots[self._free.pop()]
        assert slot.free, f"slot {slot.idx} on free list but occupied"
        slot.req = req
        slot.emitted = 0
        slot.next_token = 0
        slot.stop_token = req.stop_token
        slot.tokens = []
        slot.first_token_s = 0.0
        return slot

    def release(self, slot: Slot) -> None:
        assert not slot.free, f"slot {slot.idx} double-free"
        slot.req = None
        self._free.append(slot.idx)

    def busy(self) -> list[Slot]:
        return [s for s in self.slots if not s.free]
