"""Request/response types of the continuous-batching scheduler.

A ``Request`` is one user generation: a prompt, a token budget and an
optional per-request stop token.  The scheduler streams tokens through
the ``on_token`` callback as they are sampled and emits a final
``RequestResult`` when the request finishes (stop token or budget).
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"          # admitted to the queue, no slot yet
    PREFILLING = "prefilling"  # owns a slot; chunks being written
    ACTIVE = "active"          # in the decode batch
    FINISHED = "finished"
    # terminal degraded states (overload shedding / fault isolation):
    REJECTED = "rejected"      # shed at admission (queue full)
    EXPIRED = "expired"        # deadline passed while still queued
    ERRORED = "errored"        # evicted mid-flight (e.g. NaN/Inf logits)

#: states a request can never leave; their RequestResult.finish_reason
#: is the state's value
TERMINAL_STATES = (RequestState.FINISHED, RequestState.REJECTED,
                   RequestState.EXPIRED, RequestState.ERRORED)


@dataclasses.dataclass
class Request:
    req_id: int
    tokens: np.ndarray                  # (L,) int32 prompt
    max_new_tokens: int
    arrival_s: float = 0.0              # trace time (replay harness)
    stop_token: int | None = None       # None -> scheduler default
    deadline_s: float | None = None     # absolute trace-time deadline; a
    #                                     request still *queued* past it is
    #                                     expired (None -> scheduler
    #                                     default_deadline_s, if any)

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.tokens.size == 0:
            raise ValueError(f"request {self.req_id}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.req_id}: max_new_tokens "
                             f"must be >= 1, got {self.max_new_tokens}")

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.size)


@dataclasses.dataclass
class RequestResult:
    req_id: int
    tokens: list[int]                   # generated tokens, stop included
    finish_reason: str                  # "stop" | "length" | "rejected"
    #                                     | "expired" | "errored"
    prompt_len: int
    # trace-clock timestamps (seconds since scheduler start);
    # first_token_s is NaN for requests shed before their first token
    arrival_s: float
    first_token_s: float
    finish_s: float

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s

    @property
    def n_generated(self) -> int:
        return len(self.tokens)

    @property
    def shed(self) -> bool:
        """True when the scheduler terminated this request without
        honoring it (admission shed, queue expiry, or fault eviction)."""
        return self.finish_reason in ("rejected", "expired", "errored")
