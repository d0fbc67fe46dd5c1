"""Reference torch programs for ``LlmSpec`` models (capture oracle side;
the counterpart of the reference's ``capture/reference.py``).

The hand-enumerated extraction tables in ``core.workloads`` encode the
paper's modeling conventions (per-head attention instances weighted
L x H, decode batched as M = batch rows against one modeled KV cache,
MoE capacity-balanced per-expert token shares).  This module expresses
the *same* conventions as torch programs — a prefill fn and a
decode-step fn built from an ``LlmSpec`` — so the capture pipeline can be
differentially tested: capturing these programs must reproduce the
hand-enumerated GEMM multiset *exactly*, weights and chains included, on
every ``paper_cases()`` spec (tests/test_torch_capture*.py).

These are modeling programs, not executable inference: weights are
zeros made inside the trace (fake tensors, nothing allocated), the KV
cache is a free tensor, and GQA key/value heads are materialized per
query head (``repeat_interleave``) exactly as the paper prices them.
The layer stack is a Python loop (the trace unrolls it; capture dedupes
the L identical layers to weight L, where the reference's ``lax.scan``
multiplies by its trip count); per-head and per-expert GEMMs are einsums
with batch labels, so the capture exercises batch-dim flattening.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.workloads import LlmSpec
from .program import PlanProgram, captured_program

_F32 = torch.float32


def _score_len(spec: LlmSpec, extent: int) -> int:
    if spec.window is not None and spec.local_ratio >= 1.0:
        return min(extent, spec.window)
    return extent


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=_F32, device=like.device)


def _mlp_block(spec: LlmSpec, x: torch.Tensor, m: int) -> torch.Tensor:
    """Gated MLP (or capacity-balanced MoE) on m token rows; returns the
    block output with the same modeling shapes workloads.py prices."""
    d, ff = spec.d_model, spec.d_ff
    if spec.n_experts:
        m_exp = max(1, m * spec.top_k // spec.n_experts)
        n_mats = spec.n_experts + spec.shared_experts
        wg = _zeros((n_mats, d, ff), x)
        wu = _zeros((n_mats, d, ff), x)
        wd = _zeros((n_mats, ff, d), x)
        xe = x[:m_exp][None].expand(n_mats, m_exp, d)
        g = torch.einsum("emd,edf->emf", xe, wg)
        u = torch.einsum("emd,edf->emf", xe, wu)
        y = torch.einsum("emf,efd->emd", F.silu(g) * u, wd)
        return torch.cat([x[:m_exp] + torch.sum(y, dim=0), x[m_exp:]])
    wg = _zeros((d, ff), x)
    wu = _zeros((d, ff), x)
    wd = _zeros((ff, d), x)
    g = x @ wg
    u = x @ wu
    return x + (F.silu(g) * u) @ wd


def spec_prefill_fn(spec: LlmSpec, seq: int):
    """(fn, example_args) for one prefill under the paper's conventions."""
    L, H, KV, hd = spec.layers, spec.n_heads, spec.kv_heads, spec.head_dim
    d, vocab = spec.d_model, spec.vocab
    T = _score_len(spec, seq)
    G = H // KV

    def fn(x):                                   # x: (seq, d)
        wq = _zeros((d, H * hd), x)
        wk = _zeros((d, KV * hd), x)
        wv = _zeros((d, KV * hd), x)
        wo = _zeros((H * hd, d), x)
        w_lm = _zeros((d, vocab), x)
        for _ in range(L):
            q = x @ wq                           # (S, H*hd)
            k = x @ wk                           # (S, KV*hd)
            v = x @ wv
            qh = q.reshape(seq, H, hd).transpose(0, 1)
            kh = torch.repeat_interleave(k[:T].reshape(T, KV, hd), G,
                                         dim=1).transpose(0, 1)
            vh = torch.repeat_interleave(v[:T].reshape(T, KV, hd), G,
                                         dim=1).transpose(0, 1)
            s = torch.einsum("hsd,htd->hst", qh, kh)   # per-head: batch h
            p = torch.softmax(s, dim=-1)               # reduce breaks chains
            ctx = torch.einsum("hst,htd->hsd", p, vh)
            attn = ctx.transpose(0, 1).reshape(seq, H * hd) @ wo
            x = _mlp_block(spec, x + attn, seq)
        return x[seq - 1:] @ w_lm                # lm_head: last token only

    return fn, (torch.empty((seq, d), dtype=_F32, device="meta"),)


def spec_decode_fn(spec: LlmSpec, batch: int, cache_len: int):
    """(fn, example_args) for one batched decode step: every projection
    collapses to M = batch rows, attention runs against the modeled KV
    cache (the paper's serving-shape convention in ``decode_gemms``)."""
    L, H, KV, hd = spec.layers, spec.n_heads, spec.kv_heads, spec.head_dim
    d, vocab = spec.d_model, spec.vocab
    ctx = _score_len(spec, cache_len)

    def fn(x, k_cache, v_cache):                 # x: (batch, d)
        wq = _zeros((d, H * hd), x)
        wk = _zeros((d, KV * hd), x)
        wv = _zeros((d, KV * hd), x)
        wo = _zeros((H * hd, d), x)
        w_lm = _zeros((d, vocab), x)
        appended = []
        for _ in range(L):
            q = x @ wq                           # (B, H*hd)
            appended += [x @ wk, x @ wv]         # cache-append projections
            qh = q.reshape(batch, H, hd).transpose(0, 1)
            s = torch.einsum("hbd,htd->hbt", qh, k_cache)
            p = torch.softmax(s, dim=-1)
            c = torch.einsum("hbt,htd->hbd", p, v_cache)
            attn = c.transpose(0, 1).reshape(batch, H * hd) @ wo
            x = _mlp_block(spec, x + attn, batch)
        return x @ w_lm, appended                # lm_head: every row

    meta = dict(dtype=_F32, device="meta")
    args = (torch.empty((batch, d), **meta),
            torch.empty((H, ctx, hd), **meta),
            torch.empty((H, ctx, hd), **meta))
    return fn, args


def capture_spec_prefill(spec: LlmSpec, seq: int) -> PlanProgram:
    fn, args = spec_prefill_fn(spec, seq)
    return captured_program(fn, *args,
                            name=f"{spec.name}_prefill{seq}")


def capture_spec_decode(spec: LlmSpec, batch: int,
                        cache_len: int) -> PlanProgram:
    fn, args = spec_decode_fn(spec, batch, cache_len)
    return captured_program(fn, *args,
                            name=f"{spec.name}_decode{batch}")


def capture_spec_scenario(spec: LlmSpec, *, prefill_seqs=(),
                          decode_batches=(), cache_len: int = 4096
                          ) -> PlanProgram:
    """Prefill sweep + decode shapes, merged — the captured counterpart
    of ``workloads.scenario_program``."""
    prog = PlanProgram(name=f"{spec.name}_scenario", gemms=[], chains=[])
    for seq in prefill_seqs:
        prog = prog.merged(capture_spec_prefill(spec, seq),
                           name=prog.name)
    for batch in decode_batches:
        prog = prog.merged(capture_spec_decode(spec, batch, cache_len),
                           name=prog.name)
    return prog
