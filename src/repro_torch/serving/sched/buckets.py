"""Prefill-chunk bucket quantization.

Prompts arrive at arbitrary lengths; compiling a prefill program (and
content-addressing a GEMM plan) per length would make both the jit cache
and the plan database grow with traffic.  Instead prompts are cut into
chunks drawn from a small fixed set of widths: full chunks at the
largest width, then one final chunk right-padded up to the smallest
bucket that fits the remainder.  Compiled-program count and plan-key
count are both bounded by ``len(chunk_widths) + 1`` (the +1 is the
slot-batched decode step), independent of traffic.

Padding is sound because padded positions are never *read*: causal
masking hides them from every real query of the same chunk (their
positions are strictly larger), the per-row valid-length mask hides
them from later decode steps, and subsequent writes reclaim the
positions as generation proceeds.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One prefill chunk: prompt[start:start+n_real], padded to width."""

    start: int          # absolute cache position of the chunk's first token
    width: int          # bucket width (the compiled program's S)
    n_real: int         # real prompt tokens in the chunk (<= width)

    @property
    def is_padded(self) -> bool:
        return self.n_real < self.width


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """The quantized prefill widths, ascending."""

    chunk_widths: tuple[int, ...] = (8, 32, 128)

    def __post_init__(self):
        if not self.chunk_widths:
            raise ValueError("need at least one chunk width")
        ws = tuple(sorted(set(int(w) for w in self.chunk_widths)))
        if ws[0] < 1:
            raise ValueError(f"chunk widths must be >= 1: {ws}")
        object.__setattr__(self, "chunk_widths", ws)

    @property
    def max_width(self) -> int:
        return self.chunk_widths[-1]

    def quantize(self, remainder: int) -> int:
        """Smallest bucket width that fits `remainder` tokens."""
        for w in self.chunk_widths:
            if w >= remainder:
                return w
        return self.max_width

    def plan_chunks(self, prompt_len: int) -> list[Chunk]:
        """Cut a prompt into chunks: full max-width chunks, then one
        final (possibly padded) bucketed chunk.  Only the final chunk
        ever carries padding."""
        if prompt_len < 1:
            raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
        chunks: list[Chunk] = []
        start, rem = 0, prompt_len
        while rem > self.max_width:
            chunks.append(Chunk(start, self.max_width, self.max_width))
            start += self.max_width
            rem -= self.max_width
        chunks.append(Chunk(start, self.quantize(rem), rem))
        return chunks

    def padded_len(self, prompt_len: int) -> int:
        """Cache positions touched by the prefill of `prompt_len` (the
        final chunk's padding writes masked garbage past the prompt)."""
        last = self.plan_chunks(prompt_len)[-1]
        return last.start + last.width
