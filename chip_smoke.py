"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]
    python3 chip_smoke.py --time-generate
    python3 chip_smoke.py --attention [--out DIR]
    python3 chip_smoke.py --mla [--out DIR]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
checks that the bf16 GEMM kernels and the scans run on the tensor cores
(HGMMA, or TF32 HMMA, in their SASS), holds each kernel against its plain
PyTorch version on the card and B1's bf16 bits against every
decomposition of one problem, and serves three paths, checking each
one's launch counts:

- ``llama3-8b``: the smoke config through the fused kernel (B2), the
  full width through the GEMM kernel (B1) and ``goma_combine``; and the
  continuous scheduler, on the smoke config (B2; streams equal to the
  static oracle and to the CPU) and at full width (B1 and
  ``goma_combine`` at the slots' and the chunk widths' shapes, and in
  fp32 at 4 layers every emitted token's logits against a static
  prefill);
- ``rwkv6-7b``: the smoke config (card tokens == CPU tokens) and the
  full width, with the prefill's WKV6 scans through B3;
- ``zamba2-2.7b``: the smoke config (card tokens == CPU tokens) and the
  full width, with the prefill's Mamba2 scans through B4 and the shared
  block's MLP through B1 and ``goma_combine``;
- the MoE family (phase 13): the ``deepseek-moe-16b`` and
  ``granite-moe-1b-a400m`` smoke configs (card == CPU, both dispatches,
  and behind the scheduler), ``deepseek-moe-16b`` at full width and 14
  of its 28 layers statically and behind the scheduler with no GOMA
  kernel launched, and its fp32 gate at 4 layers;
- scale-out (phase 14) on ``llama3-8b``: ``spec_generate`` with an
  n-gram and a model drafter, the scheduler with speculative decoding
  and with a KV prefix cache, the replica router (its fleet planned by
  one donor prewarm with zero solver calls, and a replica killed
  mid-trace) on the smoke config, card == CPU == static oracle; at full
  width two replicas with prefix cache and speculative decoding, B1
  and ``goma_combine`` at held shapes, and the fp32 gate at 4 layers;
- fidelity and calibration (phase 15): the port's ``plan build``
  manifests of llama3-8b's scheduler deployment and zamba2-2.7b's static
  path replayed through B1 in bf16 (exact launch counts per dispatched
  plan, row keys == the store's keys, B1 held at every replayed shape),
  ``plan calibrate`` and ``plan fidelity`` (the smoke config's captured
  manifest, fp32) in second processes, each exit code its report's gate;
- program capture (phase 16): phase 11's deployment prewarmed from the
  model's own traced programs (no device memory, 0 solver calls and
  store misses in the first replay, phase 11's streams and launches per
  pass), and phase 14's smoke fleet with a model drafter prewarmed the
  same way (the drafter's groups in the store, 0 solver calls, card ==
  CPU == static oracle);
- the rest of the catalog (phase 17): the ``gemma2-27b`` (sliding
  windows on alternate layers, softcaps), ``llava-next-34b`` (a prefix
  of patches) and ``seamless-m4t-medium`` (encoder, cross-attention)
  smoke configs, card == CPU, and gemma2's behind the scheduler; at
  full width gemma2-27b (4 of its 46 layers) statically (prompts past
  its window, 9 key blocks) and behind the scheduler from an enumerated prewarm, B1 and
  ``goma_combine`` with exact counts at phase-3 shapes, 0 solver calls;
  llava-next-34b statically behind 2880 patches (B1, ``goma_combine``);
  seamless-m4t-medium statically (no GOMA kernel); the fp32 gates at 4
  layers;
- tensor-parallel serving (phase 18) over 2 and 4 ranks that share the
  card over gloo: the ``llama3-8b`` (B2 at the local d_ff) and
  ``deepseek-moe-16b`` smoke configs card == CPU == one rank, and
  ``llama3-8b`` at full width and 16 of its 32 layers from a plan store
  rank 0 prewarmed (0
  solver calls; on every rank B1 and ``goma_combine`` with exact counts
  at the per-rank shapes phase 3 holds, and exactly 2 all-reduces a
  layer and 2 for the split vocabulary a pass), tokens/s, peak memory per
  rank and the time of one all-reduce, and the fp32 gate at 4 layers
  against one rank;
- the rest of tensor-parallel serving (phase 19), the ranks again on the
  one card over gloo: at TP 2 and 4 the ``rwkv6-7b`` (B3 at a rank's
  heads), ``zamba2-2.7b`` (B4, B2), ``seamless-m4t-medium`` and
  ``llava-next-34b`` smoke configs card == CPU == one rank with exact
  all-reduces, and phase 10's trace behind the scheduler (llama3-8b with
  the fused MLP on and off, deepseek-moe-16b) card == CPU == one rank's
  scheduler == the static oracle, 0 solver calls after rank 0's
  prewarm; at TP 2 a router of 2 replicas == the one-rank router, phase
  11's deployment at full width and 4 layers from rank 0's capture
  prewarm (0 solver
  calls and store misses, B1 and ``goma_combine`` with exact counts at
  the per-rank chunk and slot shapes phase 3 holds, the same streams on
  every rank, the fp32 gate at 4 layers against one rank's
  teacher-forced prefills), and ``rwkv6-7b`` and ``zamba2-2.7b`` at full
  width (B3 at 32 and B4 at 40 heads a rank, B1 at zamba2's per-rank
  MLP, exact launches and all-reduces, the fp32 kernel-vs-plain gates);
- training (phase 20): every smoke config of the catalog, fp32, three
  AdamW steps on the card == the CPU's, its loss without grad through
  the kernels (B2, B3, B4) == the plain loss, and under grad the kernel
  path refusing on the card as on the CPU; ``stablelm-1.6b`` at full
  width (fp32 masters, bf16 compute, full remat, batch 8 x 512) for 20
  steps through ``run_training`` (finite, descending; step time,
  tokens/s, peak memory, stragglers, a profiled step's idle share), its
  loss without grad through B1 and ``goma_combine`` at phase-3 shapes
  and the fp32 gate at 4 layers; exact resume (6 steps == 3, a
  checkpoint, a restore, 3; bitwise) on the llama3-8b smoke config and
  stablelm-1.6b at 2 layers; 2 data-parallel gloo ranks at 4 layers,
  the exact mean (ranks bitwise equal, losses == one rank's) and the
  int8 error-feedback all-reduce (loss gap, bytes, seconds inside
  ``all_reduce``);
- sharded training (phase 21): one gloo world of 4 ranks on the card
  (and one of 2): the smoke configs phases 18 and 19 serve, fp32, three
  AdamW steps on the meshes (4, 1) and (2, 2) FSDP, (1, 2) and (1, 4)
  TP against one rank (losses; the gathered parameters; ranks that hold
  one slice bitwise equal), at (2, 2) their loss without grad through
  the kernels (B2, B3, B4) == the plain loss and the grad refusal,
  ``shard_engine(mode="fsdp")``'s tokens == one rank's, and checkpoints
  saved there restored onto (4, 1) and (1, 4) bitwise;
  ``stablelm-1.6b`` at 20d's 4 layers in fp32 on (2, 2) FSDP + TP (losses
  == 20d's one rank, step seconds, peak memory, collectives by kind a
  rank; the loss without grad through B1 and ``goma_combine`` at a
  rank's MLP, 2048 x 2816 x 2048 and back, at shapes phase 3 held); its
  parameters at 2 layers saved on (2, 2) and restored onto (4, 1),
  bitwise.
- the Hopper roofline against measured steps (phase 22): phase 5's
  ``llama3-8b`` decode step (profiled there) and phase 20b's
  ``stablelm-1.6b`` train step, each analyzed on meta tensors
  (``launch.hlo_analysis``): the analyzed B1 and ``goma_combine`` calls
  and shapes == the profiled step's == phase 5's a pass, and each bound
  max(t_compute, t_memory) at most the step's device busy time; the
  shares and the train step's MFU are printed.
- the fused attention kernel (phase 23, also alone with ``--attention``):
  forward, dQ and dK/dV against the plain version in fp32 and against
  fp64 on a slice, at stablelm-1.6b's training shape and a GQA shape at
  head size 128 (each also ragged, from position 100) and non-causal;
  against the walk (given ``kv_len=T``, the reference's mask) in bf16
  (reported); each shape's device time beside
  its least time, the walk's and SDPA's (``library_ms``, a yardstick the
  port never calls); then stablelm-1.6b's 2 x 4096 training step with
  2 x 24 forward and 24 backward calls of the kernel and none of the
  walk, and a profile of one step; serving with a cache stays on the
  walk, and the encoder-decoder's encoder, which has none, takes the
  kernel.
- the latent attention kernel (phase 24, also alone with ``--mla``):
  against its plain version and the products it replaces in bf16, at
  dsv2lite.chat8k's decode shape (128 slots of 8192, positions from the
  cell's length distributions) and at 512-wide chunks over a 4096 and a
  6144 bucket; each call's CUDA graph replays the eager call bit for bit;
  device times beside the bytes bound and the products' times.

Imports nothing of JAX and nothing of the reference package.

Output: one line per phase with its time; then the card's name and power
limit, a ``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.  With ``--out DIR`` the per-shape
kernel numbers also go to ``DIR/chip_smoke.json``, and one more
full-width ``generate`` of each model runs under ``torch.profiler``:
device time by kernel and the device's busy and idle shares go to
``DIR/profile_serve.{json,txt}`` (llama3-8b),
``DIR/profile_serve_rwkv.{json,txt}`` and
``DIR/profile_serve_zamba2.{json,txt}``, and one more scheduler replay
to ``DIR/profile_sched.{json,txt}``, after phase 11's bf16 streams'
agreement with the static oracle and its witnesses are reported; phase
13's profiled MoE replay (device only) goes to
``DIR/profile_sched_moe.{json,txt}``, phase 17's
profiled generates to ``DIR/profile_serve_<arch>.{json,txt}``.  Any
failed phase raises and ends the script with a non-zero code; without a
CUDA card it prints no result.

``--time-generate`` runs nothing but phase 5's static generate, timed
five times, and prints the readings; a copy of the script at the root of
another checkout times that checkout's port (two commits compared in
one session, in turns).
"""
from __future__ import annotations

import argparse
import atexit
import concurrent.futures
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit), from the
# port's roofline, their one home
from repro_torch.launch import roofline  # noqa: E402

HBM_BYTES_PER_S = roofline.HBM_BW
PEAK_FLOPS = {torch.bfloat16: roofline.PEAK_FLOPS["bfloat16"],
              torch.float32: roofline.PEAK_FLOPS["float32"]}
# the tensor cores' TF32 rate, which 3xTF32 runs at
TF32_FLOPS = roofline.PEAK_FLOPS["tf32"]
# kernel vs its plain version: the reference's kernel tolerances
# (tests/test_kernels.py), as rtol = atol; fp32 sums differ only in order,
# bf16 outputs may differ by one rounding of the output
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
FUSED_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# tests/test_kernels.py's MATRIX_SHAPES that need padding on some axis
ODD_SHAPES = [(300, 200, 100), (129, 257, 65), (100, 50, 1)]
# every path serves batch 4 and 8 new tokens
FULL = dict(arch="llama3-8b", batch=4, prompt_len=16, new_tokens=8)
# phase 5 times this many generates after its checked one (and
# --time-generate as many): one reading of 0.5-0.8 s moves with the
# load of the host's shared cores
PHASE5_TIMED_RUNS = 5
# the recurrent paths' prompts: 200 is two chunks of 128 at full width,
# the second one padded; 12 is two chunks of the smoke configs' 8
RECURRENT = dict(prompt_len=200, smoke_prompt_len=12)
# the continuous scheduler at full width (phase 11): llama3-8b serving a
# Poisson trace of 16 requests (8 arrivals a second, prompts uniform in
# 16-200, 16 new tokens) on 8 slots with prefill chunks of 8, 32 and 128;
# a prompt of 200 pads to 256 positions, so the cache holds 256 + 16
SCHED_FULL = dict(slots=8, chunk_widths=(8, 32, 128), requests=16,
                  arrival_rate=8.0, prompt_mix=((16, 200, 1.0),),
                  new_tokens=16, cache_len=272)
# the fp32 gates of phases 11 and 14 replay the trace on the served
# weights' first layers in fp32 (a depth cut, as phase 13's and 17's
# gates run: at llama3-8b's 32 layers they took 27.8 and 32.1 s on the H100)
FP32_GATE_LAYERS = 4
# the served bf16 MLPs that run B1 and goma_combine: their rows at decode
# and in the prefill (batch x prompt; the scheduler's slots and chunk
# widths), and their (d_ff, d_model)
SERVED_MLPS = {
    "llama3-8b": ((FULL["batch"], FULL["batch"] * FULL["prompt_len"]),
                  14336, 4096),
    "llama3-8b scheduler": (tuple(sorted({SCHED_FULL["slots"],
                                          *SCHED_FULL["chunk_widths"]})),
                            14336, 4096),
    "zamba2-2.7b": ((FULL["batch"],
                     FULL["batch"] * RECURRENT["prompt_len"]), 10240, 2560)}
# benchmarks/bench_serving.py's smoke trace (phase 10): 8 staggered
# requests of 3-23 tokens, stop token 7, 12 new tokens, 3 slots, chunk
# widths 4 and 16, cache 96
SCHED_SMOKE = dict(requests=8, stop=7, new_tokens=12, slots=3,
                   chunk_widths=(4, 16), cache_len=96)
# phase 14's fleet with a replica killed mid-trace keeps its clocks in
# ticks of this many virtual seconds (tick_clocks): against the prefix
# trace's arrivals (34-267 ms) the 6th tick kills replica 0 with two
# requests to fail over and one in a decode slot, evicted as errored
TICK_CLOCK_S = 0.02
# the scans against their plain versions: the reference's tolerances
# (tests/test_kernels.py), relative to the plain version's largest
# magnitude: y 1e-4 (bf16 y 5e-2), state 2e-3 (B3) and 1e-3 (B4)
SCAN_Y_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# the recurrent paths' full-width prefill scans (batch x prompt 200 padded
# to two chunks of 128): rwkv6-7b's (B, S, H, P), zamba2-2.7b's (B, S, H,
# P, N)
FULL_WKV, FULL_SSD = (4, 256, 64, 64), (4, 256, 80, 64, 64)
WKV_STATE_TOL, SSD_STATE_TOL = 2e-3, 1e-3
# full-width prefill logits, kernel path (B3/B4, and B1 in zamba2's
# shared MLP) against the plain path (chunked scans, plain MLP) on the
# card, on the served model's weights computed in fp32, relative to the
# plain logits' largest magnitude.  Sums taken in another order differ by
# about 1e-7 relative per operation; 32 or 54 layers leave them near
# 5e-5, and a wrong scan moves the logits by their whole scale.  In the
# served bf16 model such a difference flips bf16 roundings (2^-8) that
# every later layer of a random-weight model carries and amplifies, so
# the bf16 gap is measured and not held to a tolerance.
PATH_TOL = 1e-3
SEED = 0
# ROADMAP C7: a row's bits in a launch of this many rows (the scheduler's
# slots) against a launch of one
C7_ROWS = 8
# the MoE family (phase 13): both smoke configs, statically (each
# dispatch) and behind the scheduler on phase 10's trace; deepseek-moe-16b
# at its published widths (arXiv:2401.06066), statically at FULL's batch,
# prompt and new tokens and behind the scheduler on phase 11's deployment
# and trace, and its fp32 gate at full width and this depth (the full
# depth's fp32 weights, about 68 GB, leave no room)
MOE_SMOKE = ("deepseek-moe-16b", "granite-moe-1b-a400m")
MOE_ARCH, MOE_GATE_LAYERS = "deepseek-moe-16b", 4
# ... served at 14 of its 28 layers (a depth cut: phase 13 took 86.3 s at
# the 28 on the H100)
MOE_LAYERS = 14
# scale-out (phase 14) on llama3-8b's smoke config, fp32, on phase 10's
# deployment: spec_generate on prompts of 16 tokens with the width ladder
# 2, 4, 8, the scheduler at window width 4, a shared prefix of 32 tokens
# in front of phase 10's prompts for the prefix cache and the router
SPEC_SMOKE = dict(prompts=3, prompt_len=16, new_tokens=16,
                  widths=(2, 4, 8), spec_width=4, prefix_len=32)
# the smoke chain's rows B2 runs at on those paths: a model drafter's
# first catch-up chunk (prompt + first token), its later ones (1 to 8
# accepted tokens) and its steps (1), the ladder's windows, the target's
# prefill, the scheduler's chunks, decode and verify (slots x width)
SPEC_SMOKE_ROWS = tuple(sorted({
    *range(1, max(SPEC_SMOKE["widths"]) + 1), SPEC_SMOKE["prompt_len"],
    SPEC_SMOKE["prompt_len"] + 1, *SCHED_SMOKE["chunk_widths"],
    SCHED_SMOKE["slots"], SCHED_SMOKE["slots"] * SPEC_SMOKE["spec_width"]}))
# ... and at full width, llama3-8b with the fused MLP: 2 replicas of phase
# 11's deployment over phase 11's trace with a shared prefix of 128
# tokens in front of every prompt (prompts of 144-328 tokens pad to 384 at
# most, so the cache holds 384 + 16), a prefix cache of 1 GiB and the
# n-gram drafter at width 4 (verify windows of 8 x 4 = 32 rows)
SCALEOUT_FULL = dict(replicas=2, prefix_len=128, spec_width=4,
                     cache_len=400, prefix_mib=1024)
# fidelity (phase 15): the port's `plan build` manifests of phase 11's
# deployment (its chunk widths as prefill sequences, its slots as the
# decode batch, its cache) and of the static zamba2-2.7b path (batch x
# prompt rows, decode batch, a cache of prompt + new tokens + 8, as
# launch.serve sizes it), replayed through B1 in bf16 with this many
# warm-up and timed calls per dispatched plan
FIDELITY = dict(warmup=2, repeats=10, manifests={
    "llama3-8b": dict(seqs=SCHED_FULL["chunk_widths"],
                      decode=(SCHED_FULL["slots"],),
                      cache_len=SCHED_FULL["cache_len"]),
    "zamba2-2.7b": dict(seqs=(FULL["batch"] * RECURRENT["prompt_len"],),
                        decode=(FULL["batch"],),
                        cache_len=RECURRENT["prompt_len"]
                        + FULL["new_tokens"] + 8)})
# ... then `plan capture`'s manifest of the llama3-8b smoke config (prefill
# of batch x prompt and decode against this cache), replayed in fp32 by
# `plan fidelity` in a second process
FIDELITY_SMOKE_CACHE = 64
# the capture-prewarmed smoke fleet (phase 16) runs a model drafter over
# phase 14's prefix trace: its catch-up chunks re-feed a request's whole
# context (shared prefix, prompt, the tokens so far and a window), so B2
# runs at every row count up to this
CAPTURE_FLEET_ROWS = (SPEC_SMOKE["prefix_len"] + 23 + SCHED_SMOKE["new_tokens"]
                      + SPEC_SMOKE["spec_width"])
# the rest of the catalog (phase 17).  The smoke configs, fp32: gemma2's
# prompt runs past its window of 8 and its cache past one key block of 512
# (three blocks); llava's 6 patches and seamless's 6 frames come from the
# seed.  B2 runs gemma2's and llava's static smoke prefills at batch x
# (prefix +) prompt rows
CATALOG_SMOKE = dict(gemma2_prompt=24, gemma2_cache=1100)
CATALOG_SMOKE_ROWS = (FULL["batch"] * CATALOG_SMOKE["gemma2_prompt"],
                      FULL["batch"] * (6 + FULL["prompt_len"]))
# gemma2-27b at its published widths (arXiv:2408.00118), bf16: a static
# batch of 2 prompts of 4160 tokens, past the local layers' window of
# 4096, and 8 new tokens in a cache of 4176 (9 key blocks of 512) ...
GEMMA2_FULL = dict(batch=2, prompt_len=4160, new_tokens=8)
# ... at 4 of its 46 layers (2 local, 2 global), so that the script keeps
# inside its time limit: the static generate and the scheduler's two
# replays of the 46 layers took 150-170 s of phase 17, of 8 layers 38 s
# besides the fp32 gate, on the H100
GEMMA2_LAYERS = 4
# ... and behind the scheduler: 12 Poisson requests at 8 a second, 10 with
# prompts of 16-200 tokens and 2 (these ids) of 4150-4200, 16 new tokens,
# 4 slots, chunks of 8, 32 and 128; a prompt of 4200 pads to 4224
# positions, so a cache of 4352 holds it and its new tokens
GEMMA2_SCHED = dict(slots=4, chunk_widths=(8, 32, 128), requests=12,
                    arrival_rate=8.0, short=(16, 200), long=(4150, 4200),
                    long_ids=(3, 8), new_tokens=16, cache_len=4352)
# llava-next-34b at its published widths (yi-34b's backbone), bf16: the
# anyres stub's 2880 patches in front of prompts of 16, 8 new tokens
LLAVA_FULL = dict(batch=2, prompt_len=16, new_tokens=8)
# seamless-m4t-medium at its published widths (arXiv:2308.11596), bf16:
# 1024 frames into the encoder, prompts of 16, 8 new tokens
SEAMLESS_FULL = dict(batch=4, prompt_len=16, new_tokens=8)
# phase 17's fp32 gates run the served weights' first layers (the full
# depths' fp32 weights do not fit beside the served ones)
CATALOG_GATE_LAYERS = 4
# their MLPs at decode, the scheduler's slots and chunk widths, and the
# prefills (batch x prompt; llava's batch x (patches + prompt))
SERVED_MLPS.update({
    "gemma2-27b": (tuple(sorted({
        GEMMA2_FULL["batch"], GEMMA2_SCHED["slots"],
        *GEMMA2_SCHED["chunk_widths"],
        GEMMA2_FULL["batch"] * GEMMA2_FULL["prompt_len"]})), 36864, 4608),
    "llava-next-34b": ((LLAVA_FULL["batch"], LLAVA_FULL["batch"]
                        * (2880 + LLAVA_FULL["prompt_len"])), 20480, 7168)})
# tensor-parallel serving (phase 18): the ranks share the one card and
# run gloo (NCCL refuses two ranks on one card), every rank on the model
# axis.  The smoke configs (llama3-8b's fused MLP, B2 at the local d_ff,
# and deepseek-moe-16b's experts) at phase 4's batch and prompt; llama3-8b
# at its published widths and full_layers of its 32 layers (a depth cut:
# at the 32, TP 2 and TP 4 took 51.7 and 70.4 s of phase 18 on the H100)
# at phase 5's, its MLPs (three B1 launches and a goma_combine) at the
# local d_ff; the fp32 gate at gate_layers
TP_SERVE = dict(worlds=(2, 4), smoke=(("llama3-8b", {"fused_mlp": True}),
                                     ("deepseek-moe-16b", {})),
                full_layers=16, gate_layers=4)
SERVED_MLPS.update({
    f"llama3-8b TP{n}": ((FULL["batch"], FULL["batch"] * FULL["prompt_len"]),
                         14336 // n, 4096) for n in TP_SERVE["worlds"]})
# the rest of tensor-parallel serving (phase 19), the ranks on the card
# over gloo as in phase 18.  19a: the recurrent, hybrid, encdec and vlm
# smoke configs (the scans' kernels, the hybrid's fused MLP) at phase 4's
# batch, prompt and new tokens; 19b: phase 10's scheduler smoke at the
# local d_ff, and a router of 2 replicas at TP 2; 19c: phase 11's
# deployment at TP 2 from rank 0's capture prewarm, its fp32 gate at 4
# layers; 19d: rwkv6-7b and zamba2-2.7b at full width at TP 2 on phases
# 8 and 9's static path, their fp32 kernel-vs-plain gates at 4 layers
# (zamba2-2.7b's at 6: its first shared-block application, with the MLP's
# B1 and goma_combine, follows the sixth Mamba2 layer)
TP_REST = dict(
    worlds=(2, 4), full_world=2, replicas=2,
    smoke=(("rwkv6-7b", {"use_pallas_scan": True}),
           ("zamba2-2.7b", {"use_pallas_scan": True, "fused_mlp": True}),
           ("seamless-m4t-medium", {}), ("llava-next-34b", {})),
    sched=(("llama3-8b", {"fused_mlp": True}), ("llama3-8b", {}),
           ("deepseek-moe-16b", {})),
    recurrent=(("rwkv6-7b", {"use_pallas_scan": True}),
               ("zamba2-2.7b", {"use_pallas_scan": True,
                                "fused_mlp": True})),
    gate_layers={"llama3-8b": 4, "rwkv6-7b": 4, "zamba2-2.7b": 6},
    # phase 11's deployment at full_world runs llama3-8b's full width at 4
    # of its 32 layers: its capture prewarm and replay of the 32 took
    # 60-75 s of phase 19, and of 8 layers 15.4 s of replay
    deploy_layers=4)
SERVED_MLPS.update({
    "llama3-8b scheduler TP2": (SERVED_MLPS["llama3-8b scheduler"][0],
                                14336 // 2, 4096),
    "zamba2-2.7b TP2": (SERVED_MLPS["zamba2-2.7b"][0], 10240 // 2, 2560)})
# B3 and B4 at a rank's heads at TP 2 (phase 19d)
TP_WKV, TP_SSD = (4, 256, 32, 64), (4, 256, 40, 64, 64)
# the smoke chain's rows (decode, prefill; the scheduler smoke's slots
# and chunk widths) and local d_ff at each TP
TP_SMOKE_CHAINS = tuple((M, 128 // n) for n in TP_SERVE["worlds"]
                        for M in sorted({
                            FULL["batch"], FULL["batch"] * FULL["prompt_len"],
                            SCHED_SMOKE["slots"],
                            *SCHED_SMOKE["chunk_widths"]}))


# training (phase 20).  20a: every smoke config of ARCHS, fp32, this many
# AdamW steps on the card against the CPU from one set of fp32 masters and
# host_batch's stream (batch x sequence), and the loss without grad
# through the kernels (the fused MLP, the scans) against the plain loss;
# 20b: stablelm-1.6b at its published widths (hf stabilityai/stablelm-2-
# 1_6b: 24 layers, d_model 2048, 32 heads of 64, d_ff 5632, vocab
# 100352), fp32 masters, bf16 compute, every layer rematerialized, global
# batch x sequence, lr with a warmup of 10, through run_training without a
# checkpoint (26 GB at full width); its loss without grad through B1 and
# goma_combine, whose fp32 gate runs the first gate_layers layers; 20c:
# exact resume (resume_steps straight == half, save, restore, half) on the
# llama3-8b smoke config and on stablelm-1.6b at resume_layers layers;
# 20d: dp_world gloo ranks on the card at dp_layers layers, dp_steps
# steps, the exact mean and the int8 error-feedback all-reduce, computed
# in fp32 (in bf16 a rank's half batch rounds otherwise than the whole
# batch, which would hide the reduction's own error)
TRAIN = dict(smoke_steps=3, smoke_batch=4, smoke_seq=16,
             arch="stablelm-1.6b", batch=8, seq=512, steps=20, lr=1e-3,
             warmup=10, gate_layers=4, resume_steps=6, resume_layers=2,
             dp_world=2, dp_layers=4, dp_steps=3, dp_dtype="float32")
# card against CPU (20a) and data-parallel ranks against one rank (20d):
# losses within this of max(1, |loss|); the same sums in other orders
TRAIN_TOL = 1e-4
# the full-width training loss's MLP products (B1) and combine, at the
# batch x sequence rows, held and timed in phase 3 with cold weights
SERVED_MLPS["stablelm-1.6b training"] = (
    (TRAIN["batch"] * TRAIN["seq"],), 5632, 2048)
# sharded training (phase 21), one gloo world of 4 ranks on the card (and
# one of 2 for the (1, 2) mesh).  21a: the smoke configs that phases 18
# and 19 serve tensor-parallel, and llama3-8b's widened so that FSDP splits
# leaves (the rule keeps a leaf under 2**16 elements whole, so at the
# smoke widths only the data mean reduces), fp32: every rank's reduced
# gradients of the first batch against its slices of one rank's on the
# card (within SHARDED_TOL of max(1, max|g|), leaf by leaf), then TRAIN's
# smoke steps of AdamW on each mesh against one rank on the card from the
# same masters and batches (losses within SHARDED_TOL of scale; the
# gathered parameters within SHARDED_PARAM_TOL by the norm of each leaf's
# difference over max(1, the leaf's norm)), the kernels' loss without grad
# at (2, 2), shard_engine(mode="fsdp") there, and a (2, 2) checkpoint
# restored onto (4, 1) and (1, 4); 21b: stablelm-1.6b at
# 20d's depth and dtype (TRAIN's dp layers, fp32) on (2, 2) FSDP + TP,
# 20d's steps on the global batch, against 20d's one-rank losses, then its
# loss without grad through B1 and goma_combine at a rank's MLP
# (2048 x 2816 x 2048 and back, fp32); 21c: stablelm-1.6b's parameters at
# reshard_layers layers saved on (2, 2) and restored onto (4, 1)
SHARDED = dict(
    smoke=(("llama3-8b", {"fused_mlp": True}), ("deepseek-moe-16b", {}),
           ("rwkv6-7b", {"use_pallas_scan": True}),
           ("zamba2-2.7b", {"use_pallas_scan": True, "fused_mlp": True}),
           ("seamless-m4t-medium", {}), ("llava-next-34b", {}),
           ("llama3-8b widened", {})),
    widened={"llama3-8b widened": ("llama3-8b", {"d_ff": 1024,
                                                 "vocab": 1024})},
    meshes=(((4, 1), "fsdp"), ((1, 4), "tp"), ((2, 2), "fsdp")),
    pair=((1, 2), "tp"), serve=("llama3-8b", "rwkv6-7b", "zamba2-2.7b"),
    saved=("llama3-8b", "zamba2-2.7b"), restore=((4, 1), (1, 4)),
    mesh=(2, 2), reshard_layers=2)
SHARDED_TOL = 1e-5
# the parameters after 3 AdamW steps move further than the losses: AdamW's
# g / (|g| + eps) turns a roundoff-level gradient's reassociation into a
# share of the lr on that one element.  Set between the largest sound
# reading on the card (1.11e-5, rwkv6-7b at (4, 1)) and a planted fault's
# reading on the CPU (8.95e-5: the FSDP gather's backward summing where
# the mean belongs, widened llama3-8b at (2, 2), in
# tests/test_torch_train_sharded.py), which the gradient gate fails by
# 1e5x; the parameters are nearly blind to a constant factor on a leaf's
# gradient, so the gradients prove the reductions
SHARDED_PARAM_TOL = 3e-5
# 21b's loss without grad: B1 and goma_combine at a (2, 2) rank's rows
# (global batch x sequence over 2 data ranks) and d_ff (over 2 model
# ranks), in fp32; held and timed in phase 3 with cold weights
SHARDED_MLP = (TRAIN["batch"] // 2 * TRAIN["seq"], 5632 // 2, 2048)


@contextlib.contextmanager
def phase(name: str):
    """Print the phase's name, and its time when it ends without error."""
    t0 = time.perf_counter()
    print(f"[phase] {name} ...", flush=True)
    yield
    print(f"[phase] {name}: ok in {time.perf_counter() - t0:.2f} s",
          flush=True)


def time_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of fn() after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, tries: int = 3) -> float:
    """Device time of one fn() by torch.profiler: the time of the device
    kernels that ``reps`` calls ran, over ``reps``, after one warm-up.
    Unlike time_ms it leaves out the host's launch overhead.  A profile
    that recorded no device time at all (the profiler's tracing did not
    start) is taken again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / reps
    raise AssertionError(f"the profiler recorded no device time in {tries} "
                         f"tries")


def bound_ms(nbytes: int, flops: int, dtype: torch.dtype) -> tuple[float,
                                                                    str]:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of the type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def close(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Max abs error; raises unless |got - want| <= tol + tol * |want|."""
    err = (got.float() - want.float()).abs()
    bad = err > tol + tol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{int(bad.sum())} elements beyond tol {tol}, "
                             f"max abs err {float(err.max()):.3g}")
    return float(err.max())


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def rand(shape, dtype, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


# --------------------------------------------------------------- phase 2
# the tensor-core kernels by library: a pattern of the SASS function name
# (its mangled name), the instruction that must appear, and how to name it
MMA_KERNELS = (
    ("libgoma_gemm.so", r"goma_matmul_wgmmaILi(\d+)E", "HGMMA",
     "goma_matmul_wgmma<{}>"),
    ("libgoma_fused.so", r"goma_fused_wgmma()", "HGMMA", "goma_fused_wgmma"),
    ("libwkv6.so", r"(wkv6_kernel)I(f|13__nv_bfloat16)()E",
     "HMMA.1688.F32.TF32", "{}<{}{}>"),
    ("libmamba2_ssd.so",
     r"(ssd_scan_kernel|ssd_cb_kernel)I(f|13__nv_bfloat16)((?:Li\d+E)*)E",
     "HMMA.1688.F32.TF32", "{}<{}{}>"))
# the names' parts as C++ writes them: the I/O type, the (P, N) sizes
TYPES = {"f": "float", "13__nv_bfloat16": "bf16"}


def mma_counts(lib_dir: pathlib.Path) -> dict | None:
    """Tensor-core instructions in each tensor-core kernel of the built
    libraries, from ``cuobjdump -sass``: HGMMA (wgmma) in the bf16 GEMM
    kernels, TF32 HMMA (mma.sync m16n8k8, the 3xTF32 products) in the
    scans; None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    counts = {}
    for lib, pattern, op, label in MMA_KERNELS:
        sass = subprocess.run([tool, "-sass", str(lib_dir / lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        name = None
        for line in sass.splitlines():
            if "Function :" in line:
                m = re.search(pattern, line)
                name = None if m is None else label.format(
                    *(TYPES.get(g, re.sub(r"Li(\d+)E", r", \1", g))
                      for g in m.groups()))
                if name:
                    counts[name] = 0
            elif name and op in line:
                counts[name] += 1
    return counts


# --------------------------------------------------------------- phase 3
def cold_copies(t: torch.Tensor) -> list[torch.Tensor]:
    """``t`` and as many copies of it as make the list span at least
    twice the card's L2 cache.  A timing loop that cycles through them
    reads each from memory, as the served path reads every layer's
    weight; one weight called again stays in L2 where it fits."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 * 2**20)
    return [t] + [t.clone() for _ in range(
        max(0, math.ceil(2 * l2 / t.nbytes) - 1))]


def b1_operands(plan, dtype, gen):
    """Padded B1 operands for a plan: A's rows from plan.M on and the
    padding of both are zero, as every caller pads."""
    M, N, K = plan.M, plan.N, plan.K
    pm, pn, pk = plan.padded
    a = torch.zeros((pm, pk), dtype=dtype, device="cuda")
    a[:M, :K] = rand((M, K), dtype, gen)
    b = torch.zeros((pk, pn), dtype=dtype, device="cuda")
    b[:K, :N] = rand((K, N), dtype, gen, K ** -0.5)
    return a, b


def check_b1(shape, dtype, gen, *, timed: bool) -> dict:
    """B1 against its plain version on padded operands under the H100
    plan (with the seconds its planning took: the solve, the first time
    a shape is planned in the process), with its CTA decomposition; with
    ``timed``, also kernel, plain
    and torch.matmul times (events, and device time by the profiler), the
    kernel's device time at every slice width, and its shares; each timed
    call takes the next of B's cold_copies (``weight_copies``)."""
    from repro_torch.core.hopper_mapping import plan_gemm_tiling
    from repro_torch.kernels import _build
    from repro_torch.kernels.goma_gemm import (SLICE_WIDTHS, cta_slices,
                                               cta_tiles, goma_matmul,
                                               goma_matmul_plain)
    M, N, K = shape
    t0 = time.perf_counter()
    plan = plan_gemm_tiling(M, N, K, dtype_bytes=dtype.itemsize)
    plan_s = time.perf_counter() - t0
    pm, pn, pk = plan.padded
    a, b = b1_operands(plan, dtype, gen)
    got = goma_matmul(a, b, plan)
    want = goma_matmul_plain(a, b, plan)
    torch.cuda.synchronize()
    row = {"shape": [M, N, K], "padded": [pm, pn, pk], "plan_s": plan_s,
           "block": list(plan.block), "grid_order": "".join(plan.grid_order),
           "dtype": dtype_name(dtype),
           "max_abs_err": close(got, want, TOL[dtype])}
    if dtype == torch.bfloat16:
        width = cta_slices(plan)
        row.update(slice_n=width, ctas=len(cta_tiles(plan, width)),
                   stages=_build.load().goma_matmul_stages(width))
    else:   # fp32: one CTA per plan block
        row.update(slice_n=None,
                   ctas=(pm // plan.block[0]) * (pn // plan.block[1]),
                   stages=None)
    if timed:
        # the work the product needs: the unpadded operands and flops
        nbytes = (M * K + K * N + M * N) * dtype.itemsize
        bound, by = bound_ms(nbytes, 2 * M * N * K, dtype)
        bs = cold_copies(b)
        w = itertools.cycle(bs).__next__
        row.update(
            weight_copies=len(bs),
            ms=time_ms(lambda: goma_matmul(a, w(), plan)),
            device_ms=device_ms(lambda: goma_matmul(a, w(), plan)),
            plain_ms=time_ms(lambda: goma_matmul_plain(a, w(), plan)),
            library_ms=time_ms(lambda: torch.matmul(a, w())),
            library_device_ms=device_ms(lambda: torch.matmul(a, w())),
            bound_ms=bound, bound_by=by)
        row.update(
            bound_share=bound / row["ms"],
            vs_library=row["ms"] / row["library_ms"],
            device_bound_share=bound / row["device_ms"],
            device_vs_library=row["device_ms"] / row["library_device_ms"])
        if dtype == torch.bfloat16:   # the slice width is the bf16 path's
            row["device_ms_by_slice"] = {
                n: device_ms(lambda: goma_matmul(a, w(), plan, slice_n=n))
                for n in SLICE_WIDTHS if plan.block[1] % n == 0}
        del bs
    return row


def check_tiling_independence(gen) -> list[dict]:
    """bf16 B1 gives the same bits under every decomposition of one padded
    problem: a served decode shape at every slice width, and a 128 x 128
    x 128 problem under plans with bk 32, 64 and 128 and different (bm,
    bn), each at every slice width.  Raises on any difference."""
    from repro_torch.core.hopper_mapping import TpuTilePlan, plan_gemm_tiling
    from repro_torch.kernels.goma_gemm import SLICE_WIDTHS, goma_matmul
    rows = []
    hand = [TpuTilePlan(M=128, N=128, K=128, padded=(128, 128, 128),
                        block=blk, grid_order=("m", "n", "k"), walk="z",
                        objective=0.0, solve_time_s=0.0)
            for blk in ((128, 128, 32), (64, 128, 64), (128, 64, 128))]
    for plans in ([plan_gemm_tiling(4, 14336, 4096, dtype_bytes=2)],
                  [plan_gemm_tiling(128, 128, 128, dtype_bytes=2)] + hand):
        a, b = b1_operands(plans[0], torch.bfloat16, gen)
        outs = [(p.block, w, goma_matmul(a, b, p, slice_n=w))
                for p in plans for w in SLICE_WIDTHS
                if p.block[1] % w == 0]
        torch.cuda.synchronize()
        first = outs[0][2]
        differ = [(blk, w) for blk, w, o in outs if not torch.equal(o, first)]
        if differ:
            raise AssertionError(f"B1 bits depend on the decomposition: "
                                 f"{differ} differ from {outs[0][:2]}")
        rows.append({"shape": [plans[0].M, plans[0].N, plans[0].K],
                     "decompositions": [[list(blk), w]
                                        for blk, w, _ in outs],
                     "bitwise_equal": True})
    return rows


def check_row_independence(gen, store_dir: pathlib.Path) -> dict:
    """ROADMAP C7: row 0 of a full-width bf16 input multiplied in a launch
    of 8 rows and in one of 1, its output bits compared.  B1 at llama3-8b's
    MLP gate/up and down through ``ops.gemm``, its plans read through a
    plan store; and each ``torch.matmul`` projection of llama3-8b as the
    model runs it: q, k, v and o in bf16, the LM head in the logits dtype
    (fp32).  Reports which of them differ, with the device kernels each
    launch ran; raises only when a launch fails."""
    from repro_torch.configs import get_config
    from repro_torch.core import hopper_mapping
    from repro_torch.kernels import ops
    from repro_torch.planner import PlanStore
    cfg = get_config("llama3-8b")
    d, hd, bf16 = cfg.d_model, cfg.head_dim, torch.bfloat16
    logits = getattr(torch, cfg.logits_dtype)
    products = {"q": ("torch.matmul", cfg.n_heads * hd, d, bf16),
                "k": ("torch.matmul", cfg.kv_heads * hd, d, bf16),
                "v": ("torch.matmul", cfg.kv_heads * hd, d, bf16),
                "o": ("torch.matmul", d, cfg.n_heads * hd, bf16),
                "lm_head": ("torch.matmul", cfg.padded_vocab, d, logits),
                "mlp gate/up": ("B1", cfg.d_ff, d, bf16),
                "mlp down": ("B1", d, cfg.d_ff, bf16)}
    store = PlanStore(store_dir)
    hopper_mapping.set_plan_store(store)
    rows = {}
    try:
        for name, (route, n, k, dtype) in products.items():
            a = rand((C7_ROWS, k), bf16, gen).to(dtype)
            w = rand((k, n), bf16, gen, k ** -0.5).to(dtype)
            mm = ops.gemm if route == "B1" else torch.matmul
            many = mm(a, w)[:1]
            one = mm(a[:1], w)
            torch.cuda.synchronize()
            rows[name] = {
                "route": route, "shape": [n, k], "dtype": dtype_name(dtype),
                "rows": [C7_ROWS, 1],
                "bitwise_equal": bool(torch.equal(many, one)),
                "max_abs_diff": float((many.float() - one.float()).abs()
                                      .max()),
                "device_kernels": {
                    m: sorted(device_kernels(lambda: mm(a[:m], w)))
                    for m in (C7_ROWS, 1)}}
    finally:
        hopper_mapping.set_plan_store(None)
    if store.puts == 0 or store.hits == 0:
        raise AssertionError(f"B1's plans did not go through the store: "
                             f"{store.stats()}")
    return rows


def check_b2(M, FF, K, dtype, gen, *, plan=None, timed: bool) -> dict:
    """B2 against its plain version, and bit for bit against the B1
    composition under the plan's producer/consumer tilings."""
    from repro_torch.core.hopper_mapping import plan_fused_mlp
    from repro_torch.kernels.goma_fused import (goma_fused_matmul,
                                                goma_fused_matmul_plain)
    from repro_torch.kernels.ops import fused_mlp_composition
    if plan is None:
        plan = plan_fused_mlp(M, FF, K, dtype_bytes=dtype.itemsize)
    if not plan.fused:
        raise AssertionError(f"chain {(M, FF, K)} does not fuse: {plan}")
    pm, pff, pk, pn2 = plan.padded
    a = torch.zeros((pm, pk), dtype=dtype, device="cuda")
    a[:M, :K] = rand((M, K), dtype, gen)
    wg, wu = (rand((pk, pff), dtype, gen, pk ** -0.5) for _ in range(2))
    wd = rand((pff, pn2), dtype, gen, pff ** -0.5)
    got = goma_fused_matmul(a, wg, wu, wd, plan)
    comp = fused_mlp_composition(a, wg, wu, wd, plan)
    want = goma_fused_matmul_plain(a, wg, wu, wd, plan)
    torch.cuda.synchronize()
    if not torch.equal(got, comp):
        diff = int((got != comp).sum())
        raise AssertionError(f"B2 != B1 composition on {diff} elements "
                             f"(plan {plan})")
    row = {"shape": [M, FF, K], "padded": list(plan.padded),
           "bm": plan.bm, "bk": plan.bk,
           "dtype": dtype_name(dtype),
           "bitwise_equal_composition": True,
           "max_abs_err": close(got, want, FUSED_TOL[dtype])}
    if timed:
        # the work the chain needs: the unpadded operands and flops
        m, ff, k, n2 = plan.M, plan.FF, plan.K, plan.N2
        nbytes = (m * k + 2 * k * ff + ff * n2 + m * n2) * dtype.itemsize
        flops = 2 * m * k * ff * 2 + 2 * m * ff * n2
        bound, by = bound_ms(nbytes, flops, dtype)
        row.update(
            ms=time_ms(lambda: goma_fused_matmul(a, wg, wu, wd, plan)),
            plain_ms=time_ms(
                lambda: goma_fused_matmul_plain(a, wg, wu, wd, plan)),
            library_ms=None, bound_ms=bound, bound_by=by)
    return row


# operations of one silu_mul element: neg, exp, add, div, mul
COMBINE_OPS = 5


def check_combine(shape, dtype, gen, *, timed: bool) -> dict:
    """B2's combine as the composition launches it (goma_combine) against
    its plain version."""
    from repro_torch.kernels.goma_fused import (goma_combine,
                                                goma_combine_plain)
    g, u = rand(shape, dtype, gen), rand(shape, dtype, gen)
    got = goma_combine(g, u)
    want = goma_combine_plain(g, u, "silu_mul")
    torch.cuda.synchronize()
    row = {"shape": list(shape), "dtype": dtype_name(dtype),
           "max_abs_err": close(got, want, TOL[dtype])}
    if timed:
        n = g.numel()
        bound, by = bound_ms(3 * n * dtype.itemsize, COMBINE_OPS * n, dtype)
        row.update(
            ms=time_ms(lambda: goma_combine(g, u)),
            device_ms=device_ms(lambda: goma_combine(g, u)),
            plain_ms=time_ms(lambda: goma_combine_plain(g, u, "silu_mul")),
            library_ms=None, bound_ms=bound, bound_by=by)
        row["device_bound_share"] = bound / row["device_ms"]
    return row


def close_to_scale(got: torch.Tensor, want: torch.Tensor,
                   tol: float) -> float:
    """Max abs error; raises unless it is within tol of the plain
    version's scale, max(1, max |want|)."""
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    if not err <= tol * scale:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"max abs err {err:.3g} > {tol} x {scale:.3g}")
    return err


def device_kernels(fn) -> dict:
    """The device kernels one call of fn runs, by name, with their
    counts (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def brief(row: dict) -> dict:
    """A scan row with the plain version's device kernels by name only
    where they come from cuBLAS (the rest go to --out)."""
    return {**row, "plain_device_kernels": {
        k[:90]: n for k, n in row["plain_device_kernels"].items()
        if "gemm" in k or "gemv" in k}}


def wkv6_ops(B, S, H, P, C) -> int:
    """The CUDA-core yardstick: operations of the WKV6 scan as the
    reference's algorithm does them, all at the fp32 rate (an exp counts
    as one), per chunk and head: the intra-chunk scores (sub, exp, two multiplies and an add
    for each t > s and p), the bonus, the decay folds, y = scores @ v +
    r @ S, and the state update."""
    per = (C * (C - 1) // 2 * P * 5 + C * P * 3 + C * P * 5
           + C * (C + 1) // 2 * P * 2 + C * P * P * 2
           + C * P * P * 2 + P * P)
    return B * H * (S // C) * per


def ssd_ops(B, S, H, P, N, C) -> int:
    """The CUDA-core yardstick: operations of the SSD scan as the
    reference's algorithm does them, all at the fp32 rate (an exp counts
    as one): C Bm^T once per batch row and chunk (it is the same for every
    head); per chunk and head the cumsum, xh . dt, the decayed scores, y =
    scores @ xdt + exp(cum) C S^T, and the state update."""
    per_row = C * (C + 1) // 2 * N * 2
    per_head = (C * 2 + C * P + C * (C + 1) // 2 * 3
                + C * (C + 1) // 2 * P * 2 + C * N * P * 2 + C * P * 2
                + C + P * N * C * 2 + P * N + C * P + C * 2)
    return B * (S // C) * (per_row + H * per_head)


def scan_bound(nbytes: int, products: int, other: int) -> tuple[float, str]:
    """The least time the card could take for a scan's work: the largest
    of its bytes over the memory rate, its products over the TF32
    tensor-core rate and its other operations over the fp32 rate (the
    three run on separate units)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(products / TF32_FLOPS, other / PEAK_FLOPS[torch.float32]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# log-decays per step: "typical" as the reference's kernel tests draw
# them (B3 -exp(N(0,1) - 2), B4 a_log N(0,1) * 0.2 with dt = softplus
# N(0,1): about e^-90 a chunk of 128); "mild": B3 at the model's decay
# bias -6, B4 at a_log -4 (-1 to -2 a chunk), so that the state carried
# from one chunk into the next is visible; "strong": B3 down to -5 a step,
# where the factored partial products underflow (B4: a_log 1.5)
WKV_LOGW = {"typical": lambda z: -torch.exp(z - 2.0),
            "mild": lambda z: -torch.exp(z * 0.5 - 6.0),
            "strong": lambda z: -5.0 * torch.special.ndtr(z)}
SSD_A_LOG = {"typical": 0.0, "mild": -4.0, "strong": 1.5}


def scan_timing(fn, plain, nbytes, work, cuda_core_ops, ctas, smem,
                ctas_per_sm) -> dict:
    """A scan row's times (events and the profiler's device time, the
    plain version's), its bound and the CUDA-core yardstick's, and its
    CTAs."""
    bound, by = scan_bound(nbytes, *work)
    cuda_core_bound, _ = bound_ms(nbytes, cuda_core_ops, torch.float32)
    row = {"ms": time_ms(fn), "device_ms": device_ms(fn),
           "plain_ms": time_ms(plain), "library_ms": None,
           "bound_ms": bound, "bound_by": by,
           "cuda_core_bound_ms": cuda_core_bound,
           "product_flops": work[0], "other_ops": work[1], "bytes": nbytes,
           "ctas": ctas, "smem_bytes": smem, "ctas_per_sm": ctas_per_sm}
    row.update(bound_share=bound / row["ms"],
               device_bound_share=bound / row["device_ms"])
    return row


def check_wkv6(shape, chunk, dtype, gen, *, decay="typical",
               timed=True) -> dict:
    """B3 against its plain version and, in y, against the sequential
    oracle, which sums in another order; timed: kernel and plain times,
    the bound, and the device kernels the plain version runs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.goma_gemm import DTYPE_CODES
    from repro_torch.kernels.ref import wkv6_ref
    from repro_torch.kernels.wkv6 import (wkv6_bytes, wkv6_scan,
                                          wkv6_scan_plain, wkv6_work)
    B, S, H, P = shape
    r, k, v = (rand(shape, dtype, gen, 0.5) for _ in range(3))
    logw = WKV_LOGW[decay](torch.randn(shape, generator=gen,
                                       device="cuda")).to(dtype)
    u = torch.randn((H, P), generator=gen, device="cuda") * 0.3
    y, st = wkv6_scan(r, k, v, logw, u, chunk=chunk)
    want_y, want_st = wkv6_scan_plain(r, k, v, logw, u, chunk=chunk)
    torch.cuda.synchronize()
    row = {"shape": list(shape), "chunk": chunk, "decay": decay,
           "dtype": dtype_name(dtype),
           "y_scale": float(want_y.float().abs().max()),
           "max_abs_err": close_to_scale(y, want_y, SCAN_Y_TOL[dtype]),
           "state_max_abs_err": close_to_scale(st, want_st, WKV_STATE_TOL),
           "oracle_max_abs_err": close_to_scale(
               y, wkv6_ref(*(t.float() for t in (r, k, v, logw)), u),
               SCAN_Y_TOL[dtype])}
    if timed:
        lib, code = _build.load(), DTYPE_CODES[dtype]
        nbytes = wkv6_bytes(B, S, H, P, dtype.itemsize)
        row.update(scan_timing(
            lambda: wkv6_scan(r, k, v, logw, u, chunk=chunk),
            lambda: wkv6_scan_plain(r, k, v, logw, u, chunk=chunk), nbytes,
            wkv6_work(B, S, H, P), wkv6_ops(B, S, H, P, chunk), B * H,
            lib.wkv6_smem_bytes(code), lib.wkv6_ctas_per_sm(code)))
        row["plain_device_kernels"] = device_kernels(
            lambda: wkv6_scan_plain(r, k, v, logw, u, chunk=chunk))
        print(f"  B3 {brief(row)}")
    else:
        print(f"  B3 {row}")
    return row


def check_ssd(shape, chunk, dtype, gen, *, decay="typical",
              timed=True) -> dict:
    """B4 against its plain version and, in y, against the sequential
    oracle (with D = 0), which sums in another order; timed: kernel and
    plain times, the bound, and the device kernels the plain version
    runs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.goma_gemm import DTYPE_CODES
    from repro_torch.kernels.mamba2_ssd import (ssd_bytes, ssd_scan,
                                                ssd_scan_plain, ssd_work)
    from repro_torch.kernels.ref import ssd_ref
    B, S, H, P, N = shape
    xh = rand((B, S, H, P), dtype, gen, 0.5)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda")).to(dtype)
    a_log = (torch.randn((H,), generator=gen, device="cuda") * 0.2
             + SSD_A_LOG[decay])
    Bm, Cm = (rand((B, S, N), dtype, gen, 0.5) for _ in range(2))
    y, st = ssd_scan(xh, dt, a_log, Bm, Cm, chunk=chunk)
    want_y, want_st = ssd_scan_plain(xh, dt, a_log, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    row = {"shape": list(shape), "chunk": chunk, "decay": decay,
           "dtype": dtype_name(dtype),
           "y_scale": float(want_y.float().abs().max()),
           "max_abs_err": close_to_scale(y, want_y, SCAN_Y_TOL[dtype]),
           "state_max_abs_err": close_to_scale(st, want_st, SSD_STATE_TOL),
           "oracle_max_abs_err": close_to_scale(
               y, ssd_ref(*(t.float() for t in (xh, dt, a_log, Bm, Cm)),
                          torch.zeros_like(a_log)), SCAN_Y_TOL[dtype])}
    if timed:
        lib, code = _build.load(), DTYPE_CODES[dtype]
        nbytes = ssd_bytes(B, S, H, P, N, dtype.itemsize)
        row.update(scan_timing(
            lambda: ssd_scan(xh, dt, a_log, Bm, Cm, chunk=chunk),
            lambda: ssd_scan_plain(xh, dt, a_log, Bm, Cm, chunk=chunk),
            nbytes, ssd_work(B, S, H, P, N), ssd_ops(B, S, H, P, N, chunk),
            B * H, lib.ssd_smem_bytes(P, N, code),
            lib.ssd_ctas_per_sm(P, N, code)))
        row["plain_device_kernels"] = device_kernels(
            lambda: ssd_scan_plain(xh, dt, a_log, Bm, Cm, chunk=chunk))
        print(f"  B4 {brief(row)}")
    else:
        print(f"  B4 {row}")
    return row


# ------------------------------------------------------------ phases 4-9
def kernel_fns() -> dict:
    """The kernel wrappers by name; each counts its launches."""
    from repro_torch.kernels import (goma_combine, goma_fused_matmul,
                                     goma_matmul, ssd_scan, wkv6_scan)
    return {fn.__name__: fn for fn in (goma_matmul, goma_fused_matmul,
                                       goma_combine, wkv6_scan, ssd_scan)}


def checked_key(name: str, row: dict) -> tuple:
    """A phase-3 row's kernel, shape (with the chunk of a scan) and
    dtype, as recording_shapes names a launch."""
    return (name, tuple(row["shape"]) + ((row["chunk"],) if "chunk" in row
                                         else ()), row["dtype"])


@contextlib.contextmanager
def recording_shapes(seen: dict):
    """Count in ``seen`` every B1, B2, goma_combine, B3 and B4 call made
    through the modules that the model reaches them by, keyed as
    checked_key names the phase-3 rows."""
    from repro_torch.kernels import ops
    from repro_torch.models import rwkv, ssm
    sites = (
        (ops, "goma_matmul", lambda a, b, plan, **kw:
         ((plan.M, plan.N, plan.K), a.dtype)),
        (ops, "goma_fused_matmul", lambda a, wg, wu, wd, plan, **kw:
         ((plan.M, plan.FF, plan.K), a.dtype)),
        (ops, "goma_combine", lambda g, u, *args, **kw:
         (tuple(g.shape), g.dtype)),
        (rwkv, "wkv6_scan", lambda r, k, v, logw, u, *, chunk:
         (tuple(r.shape) + (chunk,), r.dtype)),
        (ssm, "ssd_scan", lambda xh, dt, a_log, Bm, Cm, *, chunk:
         (tuple(xh.shape) + (Bm.shape[-1], chunk), xh.dtype)))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]

    def recorder(name, fn, key):
        def call(*args, **kw):
            shape, dtype = key(*args, **kw)
            k = (name, shape, dtype_name(dtype))
            seen[k] = seen.get(k, 0) + 1
            return fn(*args, **kw)
        return call

    for (mod, name, key), (_, _, fn) in zip(sites, saved):
        setattr(mod, name, recorder(name, fn, key))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def reset_launches() -> None:
    for fn in kernel_fns().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_fns().items()}


def held_shapes(seen: dict, counts: dict, checked: set) -> dict:
    """Raise unless the calls recorded in ``seen`` add up to the launch
    ``counts`` kernel by kernel and every one was at a shape phase 3
    held (``checked``); return them by kernel, for the report."""
    by_kernel = {name: sum(n for k, n in seen.items() if k[0] == name)
                 for name in counts}
    unchecked = sorted(k for k in seen if k not in checked)
    if by_kernel != counts or unchecked:
        raise AssertionError(f"calls by shape {by_kernel} != launches "
                             f"{counts}, or at shapes phase 3 did not "
                             f"hold: {unchecked}")
    return {name: [{"shape": list(k[1]), "dtype": k[2], "launches": n}
                   for k, n in sorted(seen.items()) if k[0] == name]
            for name in counts}


def frontend_inputs(cfg, batch: int, device) -> dict | None:
    """The frontend's stand-in for the VLM (patches) and the
    encoder-decoder (frames): (batch, frontend_len, d_model) fp32,
    normal with std 0.02, from the seed; None for the other families."""
    if cfg.family not in ("vlm", "encdec"):
        return None
    gen = torch.Generator(device=device).manual_seed(SEED)
    key = "patches" if cfg.family == "vlm" else "frames"
    return {key: torch.randn((batch, cfg.frontend_len, cfg.d_model),
                             generator=gen, device=device) * 0.02}


def serve_smoke(arch: str, prompt_len: int, expect: tuple[str, ...], *,
                cache_len: int = 32, checked: set | None = None,
                **knobs) -> dict:
    """``arch``'s smoke config, fp32, with the config ``knobs`` set: one
    set of weights made on the CPU (and the frontend's inputs, for the
    VLM and the encoder-decoder); greedy tokens on the card (kernels)
    equal those on the CPU (plain versions), and every kernel named in
    ``expect`` launched on the card.  With ``checked`` every launch must
    be at a shape phase 3 held."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_to
    from repro_torch.serving import Engine, ServeConfig
    cfg = dataclasses.replace(get_config(arch, smoke=True), **knobs)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(SEED), "cpu")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (FULL["batch"], prompt_len)).astype(np.int32)
    extra = frontend_inputs(cfg, FULL["batch"], "cpu")
    scfg = ServeConfig(max_new_tokens=FULL["new_tokens"],
                       cache_len=cache_len)
    cpu_tokens = Engine(model, params, scfg).generate(prompts,
                                                      extra_batch=extra)
    card = Engine(model, tree_to(params, "cuda"), scfg)
    reset_launches()
    seen = {}
    with recording_shapes(seen):
        card_tokens = card.generate(prompts, extra_batch=extra)
    launches = launch_counts()
    if checked is not None:
        held_shapes(seen, launches, checked)
    missing = [k for k in expect if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the {arch} smoke run never launched "
                             f"{missing}: {launches}")
    if not np.array_equal(card_tokens, cpu_tokens):
        raise AssertionError(f"card tokens {card_tokens.tolist()} != CPU "
                             f"tokens {cpu_tokens.tolist()}")
    print(f"  smoke tokens (card == cpu): {card_tokens.tolist()}")
    print(f"  launches: {launches}")
    return launches


def free_device() -> None:
    """Drop the last phase's model and caches, so that the next phase's
    peak memory is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def watch_logits(model) -> list:
    """Record, for every forward pass of ``model``, whether its logits
    are all finite (a device tensor, read after the run)."""
    finite = []
    lm_logits = model._lm_logits

    def checked_logits(p, x):
        out = lm_logits(p, x)
        finite.append(torch.isfinite(out).all())
        return out

    model._lm_logits = checked_logits
    return finite


def tree_float(tree: dict) -> dict:
    """The same parameter tree in fp32 (fp32 leaves are not copied)."""
    return {k: tree_float(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def prefill_paths(cfg, params, toks) -> dict:
    """The first prefill's logits, kernel path against plain path: held
    within PATH_TOL in fp32 on the served weights; measured in the
    served bf16."""
    from repro_torch.models import build_model

    def logits(c, p):
        with torch.inference_mode():
            return build_model(c).prefill(p, {"tokens": toks},
                                          max_len=toks.shape[1])[0]

    plain_cfg = dataclasses.replace(cfg, use_pallas_scan=False,
                                    fused_mlp=False)
    f32 = dict(compute_dtype="float32")
    params32 = tree_float(params)
    want = logits(dataclasses.replace(plain_cfg, **f32), params32)
    err32 = close_to_scale(logits(dataclasses.replace(cfg, **f32),
                                  params32), want, PATH_TOL)
    del params32, want
    free_device()
    want = logits(plain_cfg, params)
    scale = float(want.float().abs().max())
    got = logits(cfg, params)
    return {"fp32_max_abs_err": err32,
            "bf16_max_abs_err": float((got - want).float().abs().max()),
            "bf16_scale": scale,
            "bf16_argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                       .float().mean())}


def expected_launches(cfg, passes: int) -> dict:
    """Every kernel's launches in one full-width generate of ``passes``
    forward passes.  Unfused MLPs (the dense and VLM layers, zamba2-2.7b's
    shared block; the chains do not fuse at these widths) take three B1
    launches and one goma_combine a pass; the encoder-decoder's MLPs are
    plain products, as the reference calls them; the scans run once per
    layer, in the prefill only (decode is the recurrent step)."""
    mlps = {"dense": cfg.layers, "vlm": cfg.layers, "encdec": 0,
            "rwkv": 0,
            "hybrid": cfg.layers // max(cfg.attn_every, 1)}[cfg.family]
    mlps = mlps if cfg.fused_mlp else 0
    scans = cfg.layers if cfg.use_pallas_scan else 0
    return {"goma_matmul": 3 * mlps * passes, "goma_fused_matmul": 0,
            "goma_combine": mlps * passes,
            "wkv6_scan": scans if cfg.family == "rwkv" else 0,
            "ssd_scan": scans if cfg.family == "hybrid" else 0}


def make_full(arch: str, **knobs):
    """``arch`` at its published widths with the config ``knobs`` set,
    random weights made on the card: (config, model, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(arch), **knobs)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    print(f"  {arch}: {sum(t.numel() for t in leaves(params))} parameters, "
          f"{torch.cuda.memory_allocated() / 2**30} GiB on the card, made "
          f"in {time.perf_counter() - t0:.1f} s")
    return cfg, model, params


def static_full(cfg, model, params, run: dict, checked: set, smi: str,
                out: pathlib.Path | None,
                profile_name: str | None = None, timed_runs: int = 1,
                profile_decode: bool = False) -> dict:
    """One static generate at full width (``run``: batch, prompt_len,
    new_tokens; the frontend's inputs from the seed), with exact launch
    counts (expected_launches), every launch at a shape phase 3 held and
    finite logits; then ``timed_runs`` more, each timed and with equal
    tokens (tokens/s from their median, every reading kept).  With
    ``out``, one more generate runs under the profiler
    (``out/<profile_name>.{json,txt}``, by default
    ``profile_serve_<arch>``); with ``profile_decode``, one decode step
    (``decode_step_profile``)."""
    from repro_torch.core.solver import reset_solver_stats, solver_stats
    from repro_torch.serving import Engine, ServeConfig
    B, S, new = run["batch"], run["prompt_len"], run["new_tokens"]
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    extra = frontend_inputs(cfg, B, "cuda")
    prefix = cfg.frontend_len if cfg.family == "vlm" else 0
    finite = watch_logits(model)
    eng = Engine(model, params, ServeConfig(
        max_new_tokens=new, cache_len=prefix + S + new + 8))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reset_solver_stats()
    seen = {}
    t0 = time.perf_counter()
    with recording_shapes(seen):
        tokens = eng.generate(prompts, extra_batch=extra)
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    solves = solver_stats()["calls"]
    passes = len(finite)
    del model._lm_logits        # watch_logits' wrapper: this run only
    if tokens.shape != (B, new) or not ((tokens >= 0)
                                        & (tokens < cfg.vocab)).all():
        raise AssertionError(f"bad tokens {tokens.tolist()}")
    if not all(bool(f) for f in finite):
        raise AssertionError(f"non-finite logits in {cfg.name}")
    want = expected_launches(cfg, passes)
    if counts != want:
        raise AssertionError(f"{cfg.name} launches {counts} != {want} "
                             f"({passes} forward passes)")
    shapes = held_shapes(seen, counts, checked)
    runs = []
    for _ in range(timed_runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = eng.generate(prompts, extra_batch=extra)
        runs.append(time.perf_counter() - t0)
        if not np.array_equal(again, tokens):
            raise AssertionError("a second greedy run gave other tokens")
    dt = statistics.median(runs)
    peak = torch.cuda.max_memory_allocated() / 2**30
    serve = {"tokens_per_s": B * new / dt, "seconds": dt,
             "tokens_per_s_runs": [B * new / t for t in runs],
             "first_run_seconds": first_s, "first_run_solver_calls": solves,
             "forward_passes": passes, "peak_memory_gib": peak,
             "cache_len": eng.cfg.cache_len}
    print(f"  static generate, batch {B}, prompt {S}, prefix {prefix}, "
          f"{new} new tokens, cache {eng.cfg.cache_len}: tokens "
          f"{tokens.tolist()}")
    print(f"  forward passes {passes}, launches {counts}")
    print(f"  launches by shape (each held in phase 3): {seen}")
    print(f"  {B * new / dt} tokens/s ({dt} s for {B}x{new} tokens, the "
          f"median of {timed_runs} timed runs: "
          f"{serve['tokens_per_s_runs']} tokens/s; first run {first_s} s "
          f"with {solves} solver calls), peak memory {peak} GiB")
    if out is not None:
        serve["profile"] = profile_run(
            lambda: eng.generate(prompts, extra_batch=extra), smi, out,
            profile_name or f"profile_serve_{cfg.name}")
    if profile_decode:
        serve["decode_step"] = decode_step_profile(eng, prompts, smi, out)
    return {"launches": counts, "shapes": shapes, "serve": serve,
            "prompts": prompts, "extra": extra, "tokens": tokens}


def decode_step_profile(eng, prompts: np.ndarray, smi: str,
                        out: pathlib.Path | None) -> dict:
    """Phase 22a's measurement, taken on phase 5's engine: one decode step
    after the prompts' prefill (at position prompt_len of the engine's
    cache), once to warm, once recording its kernel calls by shape, then
    once under the profiler (device only): its device busy and wall
    milliseconds."""
    model, params = eng.model, eng.params
    B, S = prompts.shape
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"tokens": torch.as_tensor(
            prompts, dtype=torch.int64, device="cuda")},
            max_len=eng.cfg.cache_len)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        model.decode_step(params, cache, tok, S)
        seen = {}
        with recording_shapes(seen):
            model.decode_step(params, cache, tok, S)
        prof = profile_run(lambda: model.decode_step(params, cache, tok, S),
                           smi, out, "profile_decode_step", host_ops=False)
    return {"batch": B, "index": S, "cache_len": eng.cfg.cache_len,
            "calls": {f"{k[0]} {'x'.join(map(str, k[1]))} {k[2]}": n
                      for k, n in sorted(seen.items())},
            **{k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                    "device_busy_share",
                                    "device_kernel_launches")}}


def serve_full(arch: str, prompt_len: int, smi: str,
               out: pathlib.Path | None, profile_name: str, checked: set,
               *, check_paths: bool, timed_runs: int = 1,
               profile_decode: bool = False, **knobs) -> dict:
    """``arch`` at its published widths, bf16, random weights made on the
    card, with the config ``knobs`` set.  With ``check_paths`` the first
    prefill's logits are held against the plain path's on the card
    (prefill_paths).  Then FULL's static generate (static_full): exact
    launch counts, every kernel launched at a shape and dtype phase 3
    held, finite logits, and ``timed_runs`` more, timed; with ``out``,
    one more under the profiler."""
    cfg, model, params = make_full(arch, **knobs)
    paths = None
    if check_paths:
        prompts = np.random.default_rng(SEED).integers(
            0, cfg.vocab, (FULL["batch"], prompt_len)).astype(np.int32)
        paths = prefill_paths(
            cfg, params, torch.as_tensor(prompts, dtype=torch.int64,
                                         device="cuda"))
        print(f"  first prefill, kernel path vs plain path: {paths} "
              f"(fp32 tol {PATH_TOL} x scale)")
        free_device()
    run = static_full(cfg, model, params,
                      dict(batch=FULL["batch"], prompt_len=prompt_len,
                           new_tokens=FULL["new_tokens"]),
                      checked, smi, out, profile_name, timed_runs,
                      profile_decode)
    if paths is not None:
        run["serve"]["prefill_vs_plain_path"] = paths
    return run


# ---------------------------------------------------------- phases 10-11
def smoke_trace(vocab: int) -> list:
    """benchmarks/bench_serving.py's smoke trace (SCHED_SMOKE)."""
    from repro_torch.serving.sched import Request
    rng = np.random.default_rng(0)
    return [Request(req_id=i,
                    tokens=rng.integers(0, vocab, (int(rng.integers(3, 24)),)),
                    max_new_tokens=SCHED_SMOKE["new_tokens"],
                    arrival_s=0.05 * i, stop_token=SCHED_SMOKE["stop"])
            for i in range(SCHED_SMOKE["requests"])]


def replay_trace(eng, reqs, arch_id=None, prefix_cache=None, drafter=None,
                 **sched_cfg):
    """The trace through a fresh ContinuousScheduler in virtual time;
    returns (scheduler, {req_id: (tokens, finish_reason)})."""
    from repro_torch.serving.sched import (ContinuousScheduler, SchedConfig,
                                           TraceClock, replay)
    clock = TraceClock()
    sched = ContinuousScheduler(eng, SchedConfig(**sched_cfg),
                                arch_id=arch_id, clock=clock.now,
                                prefix_cache=prefix_cache, drafter=drafter)
    results = replay(sched, reqs, clock)
    return sched, {r.req_id: (r.tokens, r.finish_reason) for r in results}


@contextlib.contextmanager
def tick_clocks():
    """Routers built inside run on virtual clocks that charge each
    scheduler tick TICK_CLOCK_S and read no wall time, so which replica
    the router steps, and which it kills, is the same on every device and
    in every run."""
    from repro_torch.serving.sched import TraceClock
    router_mod = sys.modules["repro_torch.serving.router.router"]

    class TickClock(TraceClock):
        def now(self) -> float:
            return self._t

        def pin(self) -> None:
            pass

        def release(self) -> None:
            self.advance(TICK_CLOCK_S)

    router_mod.TraceClock = TickClock
    try:
        yield
    finally:
        router_mod.TraceClock = TraceClock


def oracle_tokens(eng, req) -> list[int]:
    """The request alone through the static Engine.generate, trimmed to
    what the scheduler delivers (up to its first stop token)."""
    eng.cfg.max_new_tokens = req.max_new_tokens
    eng.cfg.stop_token = req.stop_token
    out = []
    for t in eng.generate(req.tokens[None])[0][:req.max_new_tokens]:
        out.append(int(t))
        if req.stop_token is not None and out[-1] == req.stop_token:
            break
    return out


def sched_smoke(checked: set, arch: str = "llama3-8b") -> dict:
    """The continuous scheduler on ``arch``'s smoke config (llama3-8b's,
    or gemma2-27b's with its windows per row), fp32, fused MLP (B2):
    bench_serving's smoke trace on the card, every stream equal to the
    static oracle's on the card and to the same replay on the CPU; B2
    launched once per layer and forward pass, every launch at a shape
    phase 3 held (``checked``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_to
    from repro_torch.serving import Engine, ServeConfig
    cfg = dataclasses.replace(get_config(arch, smoke=True), fused_mlp=True)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(SEED), "cpu")
    reqs = smoke_trace(cfg.vocab)
    scfg = ServeConfig(max_new_tokens=SCHED_SMOKE["new_tokens"],
                       cache_len=SCHED_SMOKE["cache_len"])
    knobs = dict(slots=SCHED_SMOKE["slots"],
                 chunk_widths=SCHED_SMOKE["chunk_widths"],
                 stop_token=SCHED_SMOKE["stop"])
    _, cpu = replay_trace(Engine(model, params, scfg), reqs, **knobs)
    card = Engine(model, tree_to(params, "cuda"), scfg)
    reset_launches()
    seen = {}
    with recording_shapes(seen):
        sched, got = replay_trace(card, reqs, **knobs)
    launches = launch_counts()
    passes = sched.metrics.prefill_chunks + sched.metrics.decode_steps
    want = {**{k: 0 for k in launches},
            "goma_fused_matmul": cfg.layers * passes}
    if launches != want:
        raise AssertionError(f"scheduler smoke launches {launches} != "
                             f"{want} ({passes} forward passes)")
    shapes = held_shapes(seen, launches, checked)
    if got != cpu:
        raise AssertionError(f"card streams {got} != CPU streams {cpu}")
    oracle = Engine(model, card.params, ServeConfig(
        cache_len=SCHED_SMOKE["cache_len"]))
    for req in reqs:
        want_tokens = oracle_tokens(oracle, req)
        if got[req.req_id][0] != want_tokens:
            raise AssertionError(f"request {req.req_id}: scheduler "
                                 f"{got[req.req_id]} != static oracle "
                                 f"{want_tokens}")
    print(f"  streams (card == cpu == static oracle): {got}")
    print(f"  forward passes {passes}, launches {launches}")
    print(f"  launches by shape (each held in phase 3): {seen}")
    return {"launches": launches, "shapes": shapes, "streams": got}


def capture_emitted_logits(model, scheds_of: dict):
    """Record, for every token a scheduler or a fleet of them emits, the
    logits row it was read off: the last prefill chunk's row of the
    prompt's last token for the first, the request's slot row of the
    decode or verify window, at the token's place in the window, for the
    rest.  Wraps ``model.decode_step`` (a prefill chunk has an int index,
    a decode or verify step a tensor of positions; ``del
    model.decode_step`` undoes it); ``scheds_of["scheds"]`` are the
    schedulers whose slots to search.  Returns ({req_id: [row, ...]},
    {req_id: its slot}, the on_token callback to install)."""
    step = type(model).decode_step
    last = {"window": 0}
    rows, slot_of, place = {}, {}, {}

    def decode_step(params, cache, tokens, index):
        logits, cache = step(model, params, cache, tokens, index)
        if isinstance(index, torch.Tensor):
            last["window"] += 1
            last["decode"] = logits
        else:
            last["prefill"] = (index, logits)
        return logits, cache

    def on_token(req, tok):
        mine = rows.setdefault(req.req_id, [])
        slot = next(s for sched in scheds_of["scheds"]
                    for s in sched.slots.slots if s.req is req)
        if not mine:
            index, logits = last["prefill"]
            mine.append(logits[0, req.prompt_len - 1 - index].clone())
            slot_of[req.req_id] = slot.idx
            return
        window, j = place.get(req.req_id, (None, -1))
        j = j + 1 if window == last["window"] else 0
        place[req.req_id] = (last["window"], j)
        mine.append(last["decode"][slot.idx, j].clone())

    model.decode_step = decode_step
    return rows, slot_of, on_token


def teacher_forced_errs(model, params, trace, results, rows) -> dict:
    """Every emitted token's logits row (``rows``, by request) against
    the static B=1 prefill of prompt + emitted tokens, teacher-forced:
    each within PATH_TOL of scale, one row per token.  Returns the max
    abs errors by request."""
    errs = {}
    by_id = {r.req_id: r for r in results}
    for req in trace:
        res = by_id[req.req_id]
        seq = np.concatenate([req.tokens, res.tokens[:-1]])[None]
        with torch.inference_mode():
            want = model.decode_step(
                params, model.init_cache(1, seq.shape[1], "cuda"),
                torch.as_tensor(seq, dtype=torch.int64, device="cuda"),
                0)[0][0, req.prompt_len - 1:]
        errs[req.req_id] = [close_to_scale(got, w, PATH_TOL)
                            for got, w in zip(rows[req.req_id], want)]
        if len(errs[req.req_id]) != len(res.tokens):
            raise AssertionError(f"request {req.req_id}: "
                                 f"{len(rows[req.req_id])} logits rows for "
                                 f"{len(res.tokens)} tokens")
    return errs


def sched_full_trace(vocab: int) -> list:
    """Phase 11's Poisson trace (SCHED_FULL)."""
    from repro_torch.serving.sched import TrafficConfig, poisson_trace
    return poisson_trace(TrafficConfig(
        n_requests=SCHED_FULL["requests"],
        arrival_rate=SCHED_FULL["arrival_rate"],
        prompt_mix=SCHED_FULL["prompt_mix"],
        max_new_tokens=SCHED_FULL["new_tokens"], vocab=vocab, seed=SEED))


def sched_full_witnesses(model, params, scfg, knobs, trace,
                         streams) -> tuple[dict, dict]:
    """Where sched_full's bf16 streams part from the static oracle's
    (reported, not held: bf16 rounding flips, see PATH_TOL), and as
    witnesses, the same trace at one slot against the oracle (chunked
    against whole-prompt prefill) and against the 8-slot streams (a
    decode of 8 rows against one of 1)."""
    from repro_torch.serving import Engine, ServeConfig
    t0 = time.perf_counter()
    oracle = Engine(model, params, ServeConfig(
        cache_len=SCHED_FULL["cache_len"]))
    static = {req.req_id: oracle_tokens(oracle, req) for req in trace}
    _, alone = replay_trace(Engine(model, params, scfg), trace,
                            **{**knobs, "slots": 1})

    def agreement(got: dict, want: dict) -> dict:
        out = {}
        for rid, w in want.items():
            same = [a == b for a, b in zip(got[rid], w)]
            out[rid] = {"equal": sum(same), "of": len(w),
                        "leading": (same + [False]).index(False)}
        return out

    eight = {rid: t for rid, (t, _) in streams.items()}
    one = {rid: t for rid, (t, _) in alone.items()}
    agree = agreement(eight, static)
    witness = {"one_slot_vs_static": agreement(one, static),
               "eight_slots_vs_one_slot": agreement(eight, one)}
    for name, agr in {"static bf16 oracle": agree, **witness}.items():
        parted = {rid: a["leading"] for rid, a in agr.items()
                  if a["equal"] != a["of"]}
        print(f"  token agreement, {name} (reported, not held): "
              f"{len(agr) - len(parted)} of {len(agr)} streams equal; the "
              f"others' leading equal tokens: {parted}")
    print(f"  (static oracle and witnesses "
          f"{time.perf_counter() - t0:.1f} s)")
    return agree, witness


def sched_full(smi: str, out: pathlib.Path | None, checked: set) -> dict:
    """The continuous scheduler at llama3-8b's full width, bf16, fused
    MLP on (the chains do not fuse: every MLP is three B1 launches and a
    goma_combine), random weights made on the card: SCHED_FULL's trace
    with exact launch counts, every launch at a shape phase 3 held, and
    finite logits; a second replay, timed, with zero solver calls.  Then,
    with the weights' first FP32_GATE_LAYERS layers in fp32, the whole
    trace again: every emitted token's logits row within PATH_TOL of
    scale of the teacher-forced static prefill of prompt + emitted tokens
    at B=1, with slots reused.
    With ``out``, sched_full_witnesses reports the bf16 streams' token
    agreement, and one more bf16 replay runs under the profiler."""
    from repro_torch.configs import get_config
    from repro_torch.core.solver import reset_solver_stats, solver_stats
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.sched import (ContinuousScheduler, SchedConfig,
                                           TraceClock, replay)
    cfg = dataclasses.replace(get_config("llama3-8b"), fused_mlp=True)
    model = build_model(cfg)
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    trace = sched_full_trace(cfg.vocab)
    knobs = dict(slots=SCHED_FULL["slots"],
                 chunk_widths=SCHED_FULL["chunk_widths"])
    scfg = ServeConfig(max_new_tokens=SCHED_FULL["new_tokens"],
                       cache_len=SCHED_FULL["cache_len"])
    finite = watch_logits(model)
    reset_launches()
    seen = {}
    with recording_shapes(seen):
        sched, streams = replay_trace(Engine(model, params, scfg), trace,
                                      **knobs)
    counts = launch_counts()
    del model._lm_logits        # watch_logits' wrapper: this run only
    chunks, ticks = sched.metrics.prefill_chunks, sched.metrics.decode_steps
    passes = chunks + ticks
    want = {**{k: 0 for k in counts},
            "goma_matmul": 3 * cfg.layers * passes,
            "goma_combine": cfg.layers * passes}
    if counts != want:
        raise AssertionError(f"scheduler launches {counts} != {want} "
                             f"({passes} forward passes)")
    if len(finite) != passes or not all(bool(f) for f in finite):
        raise AssertionError(f"non-finite logits or {len(finite)} passes "
                             f"!= {passes}")
    shapes = held_shapes(seen, counts, checked)
    served = [streams[r.req_id][0] for r in trace]
    if any(len(t) != r.max_new_tokens or min(t) < 0 or max(t) >= cfg.vocab
           for t, r in zip(served, trace)):
        raise AssertionError(f"bad streams {streams}")
    # a second replay, timed, once every plan is memoized
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_solver_stats()
    eng = Engine(model, params, scfg)
    sched, again = replay_trace(eng, trace, **knobs)
    torch.cuda.synchronize()
    solves = solver_stats()["calls"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    if again != streams or solves:
        raise AssertionError(f"the timed replay made {solves} solver calls "
                             f"or gave other streams")
    summ = sched.metrics.summary()
    print(f"  streams: {streams}")
    print(f"  forward passes {passes} ({chunks} prefill chunks, {ticks} "
          f"decode ticks), launches {counts}")
    print(f"  launches by shape (each held in phase 3): {seen}")
    print(f"  metrics: {summ}")
    print(f"  tokens/s {summ['tokens_per_s']}, ttft p50/p95 "
          f"{summ['ttft_p50_s']}/{summ['ttft_p95_s']} s, tpot p50 "
          f"{summ['tpot_p50_s']} s, mean slot occupancy "
          f"{summ['mean_slot_occupancy']}, ticks {summ['steps']}, peak "
          f"memory {peak} GiB, solver calls {solves}")
    agree = witness = None
    if out is not None:
        agree, witness = sched_full_witnesses(model, params, scfg, knobs,
                                              trace, streams)
        profile_run(lambda: replay_trace(Engine(model, params, scfg), trace,
                                         **knobs), smi, out, "profile_sched")
    del eng, sched

    # fp32: the same weights' first layers, the same path, the same trace
    t0 = time.perf_counter()
    params32 = gate_params(params, FP32_GATE_LAYERS)
    del params
    free_device()
    cfg32 = dataclasses.replace(cfg, layers=FP32_GATE_LAYERS,
                                compute_dtype="float32")
    model32 = build_model(cfg32)
    clock = TraceClock()
    holder = {}
    rows, slot_of, on_token = capture_emitted_logits(model32, holder)
    sched = ContinuousScheduler(
        Engine(model32, params32, scfg), SchedConfig(**knobs),
        clock=clock.now, on_token=on_token)
    holder["scheds"] = [sched]
    results = replay(sched, trace, clock)
    del model32.decode_step
    reused = len(trace) - len(set(slot_of.values()))
    if reused <= 0:
        raise AssertionError(f"fp32 replay reused no slot: {slot_of}")
    errs = teacher_forced_errs(model32, params32, trace, results, rows)
    worst = max(max(e) for e in errs.values())
    print(f"  fp32 at {FP32_GATE_LAYERS} layers ("
          f"{time.perf_counter() - t0:.1f} s, {len(trace)} requests "
          f"on {len(set(slot_of.values()))} slots, {reused} admissions into "
          f"a used slot; slots {slot_of}): every emitted token's logits row "
          f"vs the teacher-forced static prefill, largest max abs err "
          f"{worst} (tol {PATH_TOL} x scale); per request: "
          f"{ {rid: max(e) for rid, e in errs.items()} }")
    return {"launches": counts, "shapes": shapes, "streams": streams,
            "serve": {"metrics": summ, "peak_memory_gib": peak,
                      "forward_passes": passes, "solver_calls": solves,
                      "oracle_agreement": agree, "witness": witness,
                      "fp32_logits_err": errs, "fp32_slot_of": slot_of}}


# ------------------------------------------------------------- phase 12
def sched_smoke_store(checked: set, phase10: dict,
                      store_dir: pathlib.Path) -> dict:
    """Phase 10's replay once more, its plans through a plan store: one
    scheduler's enumerated prewarm fills a fresh store; a second one, on
    the same store reopened with the process's plan caches flushed,
    reads every plan back (no put, no miss, no solver call) and replays
    the trace.  B2 launched once per layer and forward pass, every launch
    at a shape phase 3 held; streams equal phase 10's and the card's
    static oracle."""
    from repro_torch.configs import get_config
    from repro_torch.core import hopper_mapping
    from repro_torch.core.solver import reset_solver_stats, solver_stats
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_to
    from repro_torch.planner import PlanStore
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.sched import ContinuousScheduler, SchedConfig
    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                              fused_mlp=True)
    model = build_model(cfg)
    params = tree_to(model.init_params(torch.Generator().manual_seed(SEED),
                                       "cpu"), "cuda")
    reqs = smoke_trace(cfg.vocab)
    scfg = ServeConfig(max_new_tokens=SCHED_SMOKE["new_tokens"],
                       cache_len=SCHED_SMOKE["cache_len"])
    knobs = dict(slots=SCHED_SMOKE["slots"],
                 chunk_widths=SCHED_SMOKE["chunk_widths"],
                 stop_token=SCHED_SMOKE["stop"],
                 prewarm_source="enumerated")
    cold = PlanStore(store_dir)
    ContinuousScheduler(Engine(model, params, scfg, plan_store=cold),
                        SchedConfig(**knobs), arch_id="llama3-8b")
    hopper_mapping.set_plan_store(None)
    store = PlanStore(store_dir)
    reset_solver_stats()
    reset_launches()
    seen = {}
    with recording_shapes(seen):
        sched, got = replay_trace(Engine(model, params, scfg,
                                         plan_store=store),
                                  reqs, arch_id="llama3-8b", **knobs)
    launches = launch_counts()
    solves = solver_stats()["calls"]
    hopper_mapping.set_plan_store(None)
    passes = sched.metrics.prefill_chunks + sched.metrics.decode_steps
    want = {**{k: 0 for k in launches},
            "goma_fused_matmul": cfg.layers * passes}
    if launches != want:
        raise AssertionError(f"scheduler smoke launches with the store "
                             f"{launches} != {want} ({passes} passes)")
    shapes = held_shapes(seen, launches, checked)
    if solves or store.puts or store.misses or not cold.num_fused() \
            or not store.hits:
        raise AssertionError(f"the replay from the store made {solves} "
                             f"solver calls: cold {cold.stats()}, warm "
                             f"{store.stats()}")
    if got != phase10["streams"]:
        raise AssertionError(f"streams with the store {got} != phase 10's "
                             f"{phase10['streams']}")
    oracle = Engine(model, params, ServeConfig(
        cache_len=SCHED_SMOKE["cache_len"]))
    for req in reqs:
        if got[req.req_id][0] != oracle_tokens(oracle, req):
            raise AssertionError(f"request {req.req_id}: {got[req.req_id]}"
                                 f" != the static oracle's")
    print(f"  smoke replay from the store: streams == phase 10's == static "
          f"oracle, launches {launches}, solver calls {solves}; cold store "
          f"{cold.stats()}, warm store {store.stats()}")
    return {"launches": launches, "shapes": shapes,
            "store": {"cold": cold.stats(), "warm": store.stats(),
                      "solver_calls": solves}}


def sched_store_full(checked: set, phase11: dict,
                     store_dir: pathlib.Path) -> dict:
    """Phase 11's deployment served from a plan store.  A cold run: the
    scheduler's enumerated prewarm for llama3-8b fills a fresh store with
    every bucketed B1 tiling and fused chain, then the trace replays once
    with no warm-up replay before it: zero solver calls and zero store
    misses, streams equal to phase 11's, the launches per forward pass
    of phase 11 and every one at a shape phase 3 held.  A second replay
    on the same store, timed as phase 11's timed replay, gives the same
    streams.  Then, with this run's device memory freed,
    ``launch.serve --continuous --plan-db`` in a second process on the
    same store and trace: it must print ``puts: 0`` and zero solver
    calls."""
    from repro_torch.configs import get_config
    from repro_torch.core import hopper_mapping
    from repro_torch.core.solver import reset_solver_stats, solver_stats
    from repro_torch.models import build_model
    from repro_torch.obs.registry import get_registry
    from repro_torch.planner import PlanStore
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.sched import (ContinuousScheduler, SchedConfig,
                                           TraceClock, replay)
    cfg = dataclasses.replace(get_config("llama3-8b"), fused_mlp=True)
    model = build_model(cfg)
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    trace = sched_full_trace(cfg.vocab)
    scfg = ServeConfig(max_new_tokens=SCHED_FULL["new_tokens"],
                       cache_len=SCHED_FULL["cache_len"])
    store = PlanStore(store_dir)
    failures = get_registry().get("sched.prewarm_failures")
    reset_solver_stats()
    clock = TraceClock()
    t0 = time.perf_counter()
    sched = ContinuousScheduler(
        Engine(model, params, scfg, plan_store=store),
        SchedConfig(slots=SCHED_FULL["slots"],
                    chunk_widths=SCHED_FULL["chunk_widths"],
                    prewarm_source="enumerated"),
        arch_id="llama3-8b", clock=clock.now)
    prewarm_s = time.perf_counter() - t0
    prewarm = {"seconds": prewarm_s, "solver_calls": solver_stats()["calls"],
               "prewarmed_plans": sched.prewarmed_plans,
               "prewarmed_chains": sched.prewarmed_chains,
               "store": store.stats()}
    print(f"  cold prewarm: {prewarm_s} s, {sched.prewarmed_plans} GEMM "
          f"tilings, {sched.prewarmed_chains} fused chains, "
          f"{prewarm['solver_calls']} solver calls, store {store.stats()}")
    reset_solver_stats()
    misses, hits = store.misses, store.hits
    torch.cuda.synchronize()
    reset_launches()
    seen = {}
    with recording_shapes(seen):
        results = replay(sched, trace, clock)
    torch.cuda.synchronize()
    counts = launch_counts()
    solves = solver_stats()["calls"]
    streams = {r.req_id: (r.tokens, r.finish_reason) for r in results}
    shapes = held_shapes(seen, counts, checked)
    if solves or store.misses != misses or \
            get_registry().get("sched.prewarm_failures") != failures:
        raise AssertionError(f"the first replay from the store made "
                             f"{solves} solver calls and "
                             f"{store.misses - misses} store misses, or a "
                             f"prewarm failed: {store.stats()}")
    # the virtual clock counts compute, so the number of ticks may differ
    # from phase 11's by a few; the launches per forward pass may not
    passes = sched.metrics.prefill_chunks + sched.metrics.decode_steps
    want = {**{k: 0 for k in counts},
            "goma_matmul": 3 * cfg.layers * passes,
            "goma_combine": cfg.layers * passes}
    if counts != want:
        raise AssertionError(f"launches {counts} != {want} ({passes} "
                             f"forward passes; phase 11: "
                             f"{phase11['launches']})")
    if streams != phase11["streams"]:
        raise AssertionError(f"streams from the store {streams} != phase "
                             f"11's {phase11['streams']}")
    summ = sched.metrics.summary()
    # a second replay, timed as phase 11's (the second of its trace, not
    # recorded), on a fresh scheduler over the same store
    reset_solver_stats()
    torch.cuda.synchronize()
    timed, again = replay_trace(
        Engine(model, params, scfg, plan_store=store), trace,
        arch_id="llama3-8b", slots=SCHED_FULL["slots"],
        chunk_widths=SCHED_FULL["chunk_widths"],
        prewarm_source="enumerated")
    torch.cuda.synchronize()
    hopper_mapping.set_plan_store(None)
    if again != streams or solver_stats()["calls"] or \
            store.misses != misses:
        raise AssertionError(f"the second replay from the store gave other "
                             f"streams or solved: {store.stats()}")
    summ2 = timed.metrics.summary()
    print(f"  first replay from the store: solver calls {solves}, store "
          f"misses {store.misses - misses}, store hits {store.hits} "
          f"({store.hits - hits} in the replay); streams == phase 11's; "
          f"forward passes {passes}, launches {counts} (phase 11: "
          f"{phase11['serve']['forward_passes']} passes, "
          f"{phase11['launches']})")
    print(f"  tokens/s {summ['tokens_per_s']}, ttft p50/p95 "
          f"{summ['ttft_p50_s']}/{summ['ttft_p95_s']} s, tpot p50 "
          f"{summ['tpot_p50_s']} s, ticks {summ['steps']} (phase 11's "
          f"timed replay: tokens/s "
          f"{phase11['serve']['metrics']['tokens_per_s']}, ttft p50 "
          f"{phase11['serve']['metrics']['ttft_p50_s']} s, tpot p50 "
          f"{phase11['serve']['metrics']['tpot_p50_s']} s)")
    print(f"  second replay from the store (timed as phase 11's): tokens/s "
          f"{summ2['tokens_per_s']}, ttft p50/p95 {summ2['ttft_p50_s']}/"
          f"{summ2['ttft_p95_s']} s, tpot p50 {summ2['tpot_p50_s']} s, "
          f"ticks {summ2['steps']}, solver calls 0")
    del sched, timed, model, params, results
    free_device()

    lo, hi, _ = SCHED_FULL["prompt_mix"][0]
    cmd = [sys.executable, "-m", "repro_torch.launch.serve",
           "--arch", "llama3-8b", "--fused-mlp", "--continuous",
           "--plan-db", str(store_dir), "--prewarm-source", "enumerated",
           "--batch", str(SCHED_FULL["slots"]),
           "--chunk-widths", ",".join(map(str, SCHED_FULL["chunk_widths"])),
           "--requests", str(SCHED_FULL["requests"]),
           "--arrival-rate", str(SCHED_FULL["arrival_rate"]),
           "--min-prompt-len", str(lo), "--prompt-len", str(hi),
           "--new-tokens", str(SCHED_FULL["new_tokens"])]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=600)
    warm_s = time.perf_counter() - t0
    for line in res.stdout.splitlines():
        print(f"  | {line}")
    if res.returncode != 0 or res.stdout.count("'puts': 0") != 2 or \
            "solver calls: 0" not in res.stdout:
        raise AssertionError(f"the second process (rc {res.returncode}) "
                             f"did not serve from the store with no put and "
                             f"no solver call:\n{res.stderr[-4000:]}")
    print(f"  second process: {warm_s} s, puts 0, solver calls 0")
    return {"launches": counts, "shapes": shapes,
            "serve": {"prewarm": prewarm, "metrics": summ,
                      "metrics_second_replay": summ2,
                      "forward_passes": passes,
                      "replay_solver_calls": solves,
                      "replay_store_misses": store.misses - misses,
                      "store": store.stats(),
                      "second_process": {"seconds": warm_s,
                                         "stdout": res.stdout}}}


# ------------------------------------------------------------- phase 13
def moe_smoke() -> dict:
    """The MoE smoke configs, fp32: static generate with the dense and the
    gathered dispatch, and phase 10's trace behind the scheduler (dense),
    card tokens == CPU tokens and, behind the scheduler, == the card's
    static oracle; no GOMA kernel launched (the family has no dense MLP,
    its experts are plain fp32 products, as in the reference)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_to
    from repro_torch.serving import Engine, ServeConfig
    none = {k: 0 for k in kernel_fns()}
    runs = {}
    for arch in MOE_SMOKE:
        for dispatch in ("dense", "gathered"):
            launches = serve_smoke(arch, FULL["prompt_len"], (),
                                   moe_dispatch=dispatch)
            if launches != none:
                raise AssertionError(f"{arch} ({dispatch}) launched "
                                     f"{launches}")
            runs[f"serve {arch} smoke, {dispatch}"] = launches
        cfg = get_config(arch, smoke=True)
        model = build_model(cfg)
        params = model.init_params(torch.Generator().manual_seed(SEED),
                                   "cpu")
        reqs = smoke_trace(cfg.vocab)
        scfg = ServeConfig(max_new_tokens=SCHED_SMOKE["new_tokens"],
                           cache_len=SCHED_SMOKE["cache_len"])
        knobs = dict(slots=SCHED_SMOKE["slots"],
                     chunk_widths=SCHED_SMOKE["chunk_widths"],
                     stop_token=SCHED_SMOKE["stop"])
        _, cpu = replay_trace(Engine(model, params, scfg), reqs, **knobs)
        card = Engine(model, tree_to(params, "cuda"), scfg)
        reset_launches()
        _, got = replay_trace(card, reqs, **knobs)
        launches = launch_counts()
        if launches != none or got != cpu:
            raise AssertionError(f"{arch} scheduler: launches {launches}, "
                                 f"card streams {got} vs CPU {cpu}")
        oracle = Engine(model, card.params, ServeConfig(
            cache_len=SCHED_SMOKE["cache_len"]))
        for req in reqs:
            if got[req.req_id][0] != oracle_tokens(oracle, req):
                raise AssertionError(f"{arch} request {req.req_id}: "
                                     f"{got[req.req_id]} != the static "
                                     f"oracle's")
        print(f"  {arch} scheduler streams (card == cpu == static "
              f"oracle): {got}")
        runs[f"scheduler {arch} smoke"] = launches
    return runs


def leaves(tree: dict):
    """Every tensor of a parameter tree."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from leaves(v)
        else:
            yield v


def first_layers(tree: dict, n: int) -> dict:
    """The first n entries of the layer axis of every leaf (views)."""
    return {k: first_layers(v, n) if isinstance(v, dict) else v[:n]
            for k, v in tree.items()}


def moe_full(smi: str, out: pathlib.Path | None) -> dict:
    """deepseek-moe-16b at its published widths and MOE_LAYERS layers,
    bf16 (banks stored in
    bf16, products in fp32), random weights made on the card: static
    generate (FULL's batch, prompt and new tokens; timed on a second run),
    then phase 11's deployment and trace behind the scheduler: a first
    replay (finite logits, no GOMA kernel launched), a second one timed
    with zero solver calls, a third one under the profiler (device only)
    for the device's busy share.  Then the fp32 gate at MOE_GATE_LAYERS
    layers, the served weights' first layers in fp32: the whole trace
    again, every emitted token's logits row within PATH_TOL of scale of
    the teacher-forced static prefill."""
    from repro_torch.configs import get_config
    from repro_torch.core.solver import reset_solver_stats, solver_stats
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.sched import (ContinuousScheduler, SchedConfig,
                                           TraceClock, replay)
    none = {k: 0 for k in kernel_fns()}
    cfg = dataclasses.replace(get_config(MOE_ARCH), layers=MOE_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    print(f"  {n_params} parameters, "
          f"{torch.cuda.memory_allocated() / 2**30} GiB on the card, made "
          f"in {time.perf_counter() - t0:.1f} s")
    B, S, new = FULL["batch"], FULL["prompt_len"], FULL["new_tokens"]
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    finite = watch_logits(model)
    eng = Engine(model, params, ServeConfig(max_new_tokens=new,
                                            cache_len=S + new + 8))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tokens = eng.generate(prompts)
    static_launches = launch_counts()
    static_passes = len(finite)
    if tokens.shape != (B, new) or not ((tokens >= 0)
                                        & (tokens < cfg.vocab)).all() \
            or not all(bool(f) for f in finite) \
            or static_launches != none:
        raise AssertionError(f"static generate: tokens {tokens.tolist()}, "
                             f"launches {static_launches}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = eng.generate(prompts)
    dt = time.perf_counter() - t0
    if not np.array_equal(again, tokens):
        raise AssertionError("a second greedy run gave other tokens")
    static = {"tokens_per_s": B * new / dt, "seconds": dt,
              "forward_passes": static_passes,
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"  static: tokens {tokens.tolist()}; {static}")
    del eng
    finite.clear()

    trace = sched_full_trace(cfg.vocab)
    knobs = dict(slots=SCHED_FULL["slots"],
                 chunk_widths=SCHED_FULL["chunk_widths"])
    scfg = ServeConfig(max_new_tokens=SCHED_FULL["new_tokens"],
                       cache_len=SCHED_FULL["cache_len"])
    reset_launches()
    sched, streams = replay_trace(Engine(model, params, scfg), trace,
                                  **knobs)
    launches = launch_counts()
    passes = sched.metrics.prefill_chunks + sched.metrics.decode_steps
    if launches != none or len(finite) != passes or \
            not all(bool(f) for f in finite):
        raise AssertionError(f"scheduler: launches {launches}, "
                             f"{len(finite)} passes of {passes} checked "
                             f"finite")
    del model._lm_logits        # watch_logits' wrapper: these runs only
    served = [streams[r.req_id][0] for r in trace]
    if any(len(t) != r.max_new_tokens or min(t) < 0 or max(t) >= cfg.vocab
           for t, r in zip(served, trace)):
        raise AssertionError(f"bad streams {streams}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_solver_stats()
    timed, again = replay_trace(Engine(model, params, scfg), trace, **knobs)
    torch.cuda.synchronize()
    solves = solver_stats()["calls"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    if again != streams or solves:
        raise AssertionError(f"the timed replay made {solves} solver calls "
                             f"or gave other streams")
    summ = timed.metrics.summary()
    prof = profile_run(lambda: replay_trace(Engine(model, params, scfg),
                                            trace, **knobs),
                       smi, out, "profile_sched_moe", host_ops=False)
    print(f"  scheduler: streams {streams}")
    print(f"  forward passes {passes}, launches {launches}, solver calls "
          f"{solves} (timed replay)")
    print(f"  tokens/s {summ['tokens_per_s']}, ttft p50/p95 "
          f"{summ['ttft_p50_s']}/{summ['ttft_p95_s']} s, tpot p50 "
          f"{summ['tpot_p50_s']} s, ticks {summ['steps']}, peak memory "
          f"{peak} GiB, device busy share {prof['device_busy_share']}")
    del sched, timed

    # fp32: the served weights' first layers, the same trace
    t0 = time.perf_counter()
    cut = dict(params, layers=first_layers(params["layers"],
                                           MOE_GATE_LAYERS))
    params32 = tree_float(cut)
    del params, cut
    free_device()
    model32 = build_model(dataclasses.replace(
        cfg, layers=MOE_GATE_LAYERS, compute_dtype="float32"))
    clock = TraceClock()
    holder = {}
    rows, slot_of, on_token = capture_emitted_logits(model32, holder)
    sched = ContinuousScheduler(Engine(model32, params32, scfg),
                                SchedConfig(**knobs), clock=clock.now,
                                on_token=on_token)
    holder["scheds"] = [sched]
    results = replay(sched, trace, clock)
    del model32.decode_step
    errs = teacher_forced_errs(model32, params32, trace, results, rows)
    worst = max(max(e) for e in errs.values())
    print(f"  fp32 at {MOE_GATE_LAYERS} layers ({time.perf_counter() - t0:.1f}"
          f" s, {len(trace)} requests on {len(set(slot_of.values()))} "
          f"slots): every emitted token's logits row vs the teacher-forced "
          f"static prefill, largest max abs err {worst} (tol {PATH_TOL} x "
          f"scale)")
    return {"launches": {"static": static_launches, "scheduler": launches},
            "serve": {"parameters": n_params, "static": static,
                      "metrics": summ, "peak_memory_gib": peak,
                      "forward_passes": passes, "solver_calls": solves,
                      "device_busy_share": prof["device_busy_share"],
                      "device_kernel_launches":
                          prof["device_kernel_launches"],
                      "fp32_gate_layers": MOE_GATE_LAYERS,
                      "fp32_logits_err": errs}}


# ------------------------------------------------------------- phase 14
def smoke_prefix_trace(vocab: int) -> list:
    """Phase 10's arrivals and budgets as a Poisson trace of 8 requests,
    each prompt behind one shared prefix of SPEC_SMOKE's length."""
    from repro_torch.serving.sched import TrafficConfig, shared_prefix_trace
    return shared_prefix_trace(TrafficConfig(
        n_requests=SCHED_SMOKE["requests"], arrival_rate=20.0,
        prompt_mix=((3, 23, 1.0),), max_new_tokens=SCHED_SMOKE["new_tokens"],
        vocab=vocab, stop_token=SCHED_SMOKE["stop"], seed=SEED),
        prefix_len=SPEC_SMOKE["prefix_len"])


def scaleout_paths(model, params, dparams, prompts, reqs, prefix_reqs,
                   store_dir: pathlib.Path | None) -> dict:
    """llama3-8b smoke's scale-out paths on the device of ``params``:
    spec_generate with the n-gram drafter and with a model drafter
    (``dparams``), the scheduler at SPEC_SMOKE's window width with the
    n-gram drafter, the prefix trace through a PrefixCache, two replicas
    with prefix cache and spec, two replicas with one killed mid-trace
    (router.replica_down) on tick_clocks, and with ``store_dir`` two
    replicas planned from a fresh store by the donor's prewarm alone (solver calls and
    store misses of the replay).  Returns the streams by path."""
    from repro_torch.core.solver import reset_solver_stats, solver_stats
    from repro_torch.faults import FaultInjector, FaultSpec, set_injector
    from repro_torch.obs.registry import get_registry
    from repro_torch.planner import PlanStore
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.router import (ModelDrafter, NgramDrafter,
                                            PrefixCache, ReplicaRouter,
                                            RouterConfig, spec_generate)
    from repro_torch.serving.sched import SchedConfig
    scfg = ServeConfig(max_new_tokens=SCHED_SMOKE["new_tokens"],
                       cache_len=SCHED_SMOKE["cache_len"])
    knobs = dict(slots=SCHED_SMOKE["slots"],
                 chunk_widths=SCHED_SMOKE["chunk_widths"],
                 stop_token=SCHED_SMOKE["stop"])
    spec = dict(spec_width=SPEC_SMOKE["spec_width"])
    eng = Engine(model, params, scfg)
    out = {}
    for name, drafter in (
            ("spec_generate ngram", NgramDrafter()),
            ("spec_generate model drafter",
             ModelDrafter(Engine(model, dparams, scfg)))):
        out[name] = [spec_generate(eng, p, drafter,
                                   max_new_tokens=SPEC_SMOKE["new_tokens"],
                                   widths=SPEC_SMOKE["widths"]).tolist()
                     for p in prompts]
    _, out["scheduler spec"] = replay_trace(eng, reqs, drafter=NgramDrafter(),
                                            **knobs, **spec)
    reg = get_registry()
    reg.reset()
    pc = PrefixCache(max(SCHED_SMOKE["chunk_widths"]))
    _, out["scheduler prefix"] = replay_trace(eng, prefix_reqs,
                                              prefix_cache=pc, **knobs)
    out["prefix hits"] = reg.get("prefix.hits")

    def fleet(engine):
        router = ReplicaRouter(engine, RouterConfig(
            replicas=2, sched=SchedConfig(**knobs, **spec)),
            prefix_cache=PrefixCache(max(SCHED_SMOKE["chunk_widths"])),
            drafter=NgramDrafter())
        return router, {r.req_id: (r.tokens, r.finish_reason)
                        for r in router.route_trace(prefix_reqs)}

    _, out["router"] = fleet(eng)
    # the victim is the replica whose clock lags at the 6th tick, and its
    # casualties are the requests in its decode slots then: on clocks that
    # fold in wall time both depend on the device's and the host's speed,
    # so this fleet's clocks charge every tick TICK_CLOCK_S instead
    set_injector(FaultInjector([FaultSpec("router.replica_down", at=(6,))],
                               seed=0))
    try:
        with tick_clocks():
            router, out["router replica_down"] = fleet(eng)
    finally:
        set_injector(None)
    out["alive after replica_down"] = sum(router.alive)
    if store_dir is not None:
        from repro_torch.core import hopper_mapping
        store = PlanStore(store_dir)
        try:
            router = ReplicaRouter(
                Engine(model, params, scfg, plan_store=store),
                RouterConfig(replicas=2, sched=SchedConfig(
                    **knobs, **spec, prewarm_source="enumerated")),
                arch_id="llama3-8b", drafter=NgramDrafter(),
                prefix_cache=PrefixCache(max(SCHED_SMOKE["chunk_widths"])))
            groups = [sorted(s._plan_groups) + sorted(s._chain_groups)
                      for s in router.scheds]
            reset_solver_stats()
            misses = store.misses
            out["router from a store"] = {
                r.req_id: (r.tokens, r.finish_reason)
                for r in router.route_trace(prefix_reqs)}
            out["fleet solver calls, store misses"] = (
                solver_stats()["calls"], store.misses - misses)
            out["fleet prewarm"] = {
                "donor": router.scheds[0].prewarmed_plans,
                "donor chains": router.scheds[0].prewarmed_chains,
                "replicas": [s.prewarmed_plans for s in router.scheds[1:]],
                "groups": groups, "store": store.stats()}
        finally:
            hopper_mapping.set_plan_store(None)
    return out


def scaleout_smoke(checked: set, store_dir: pathlib.Path) -> dict:
    """Scale-out on llama3-8b's smoke config, fp32, fused MLP (B2), one
    set of weights made on the CPU (the drafter's from another seed):
    scaleout_paths on the card (launch counts set to 0 just before)
    equals scaleout_paths on the CPU path by path; every stream equals the
    card's static oracle (a replica_down casualty its prefix); B2 launched
    once per layer and forward pass, every launch at a shape phase 3
    held; the grafted KV rows are bitwise the rows the prefix's chunks
    compute on the card; the fleet planned from a fresh store makes zero
    solver calls and store misses in its replay, the verify groups
    included."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_to
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.router import PrefixCache
    from repro_torch.serving.sched import Request
    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                              fused_mlp=True)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(SEED), "cpu")
    dparams = model.init_params(torch.Generator().manual_seed(SEED + 1),
                                "cpu")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, (SPEC_SMOKE["prompt_len"],))
               for _ in range(SPEC_SMOKE["prompts"])]
    reqs = smoke_trace(cfg.vocab)
    prefix_reqs = smoke_prefix_trace(cfg.vocab)
    cpu = scaleout_paths(model, params, dparams, prompts, reqs, prefix_reqs,
                         None)
    card_params = tree_to(params, "cuda")
    finite = watch_logits(model)
    reset_launches()
    seen = {}
    with recording_shapes(seen):
        card = scaleout_paths(model, card_params, tree_to(dparams, "cuda"),
                              prompts, reqs, prefix_reqs, store_dir)
    launches = launch_counts()
    del model._lm_logits
    passes = len(finite)
    want = {**{k: 0 for k in launches},
            "goma_fused_matmul": cfg.layers * passes}
    if launches != want or not all(bool(f) for f in finite):
        raise AssertionError(f"scale-out smoke launches {launches} != "
                             f"{want} ({passes} forward passes), or "
                             f"non-finite logits")
    shapes = held_shapes(seen, launches, checked)
    for name, got in cpu.items():
        if card[name] != got:
            raise AssertionError(f"{name}: card {card[name]} != CPU {got}")
    # the card's static oracle
    oracle = Engine(model, card_params, ServeConfig(
        cache_len=SCHED_SMOKE["cache_len"]))
    for name in ("spec_generate ngram", "spec_generate model drafter"):
        for p, got in zip(prompts, card[name]):
            oracle.cfg.max_new_tokens = SPEC_SMOKE["new_tokens"]
            oracle.cfg.stop_token = None
            if got != oracle.generate(p[None])[0].tolist():
                raise AssertionError(f"{name}: {got} != the static oracle's")
    for name, trace in (("scheduler spec", reqs),
                        ("scheduler prefix", prefix_reqs),
                        ("router", prefix_reqs),
                        ("router from a store", prefix_reqs),
                        ("router replica_down", prefix_reqs)):
        for req in trace:
            tokens, reason = card[name][req.req_id]
            want_tokens = oracle_tokens(oracle, req)
            if reason == "errored" and name == "router replica_down":
                want_tokens = want_tokens[:len(tokens)]
            if tokens != want_tokens:
                raise AssertionError(f"{name} request {req.req_id}: "
                                     f"{tokens} != the static oracle's "
                                     f"{want_tokens}")
    if card["prefix hits"] <= 0 or card["alive after replica_down"] != 1 \
            or not any(reason == "errored" for _, reason
                       in card["router replica_down"].values()):
        raise AssertionError(f"no prefix hit ({card['prefix hits']}), no "
                             f"replica down or no casualty in its slots")
    if card["fleet solver calls, store misses"] != (0, 0) or any(
            g != card["fleet prewarm"]["groups"][0]
            for g in card["fleet prewarm"]["groups"]) or \
            "verify4" not in card["fleet prewarm"]["groups"][0]:
        raise AssertionError(f"the fleet from a store: "
                             f"{card['fleet solver calls, store misses']} "
                             f"{card['fleet prewarm']}")
    # the grafted rows against the rows the prefix's chunks compute
    eng = Engine(model, card_params, ServeConfig(
        cache_len=SCHED_SMOKE["cache_len"]))
    width = max(SCHED_SMOKE["chunk_widths"])
    pc = PrefixCache(width)
    toks = np.concatenate([prefix_reqs[0].tokens[:SPEC_SMOKE["prefix_len"]],
                           np.arange(5)])
    replay_trace(eng, [Request(req_id=0, tokens=toks, max_new_tokens=1)],
                 prefix_cache=pc, slots=1,
                 chunk_widths=SCHED_SMOKE["chunk_widths"])
    p, entry = pc.lookup(toks)
    grafted = pc.graft(eng.new_cache(1), entry)
    fresh = eng.new_cache(1)
    with torch.inference_mode():
        for start in range(0, p, width):
            eng.prefill_chunk(fresh, toks[None, start:start + width], start)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(grafted["layers"][k][:, :, :p],
                              fresh["layers"][k][:, :, :p])
                  for k in ("k", "v"))
    if not bitwise:
        raise AssertionError("grafted KV rows != the recomputed rows")
    print(f"  every path card == cpu == static oracle: "
          f"{ {k: v for k, v in card.items() if 'prewarm' not in k} }")
    print(f"  fleet from a fresh store: {card['fleet prewarm']}, replay "
          f"solver calls and store misses "
          f"{card['fleet solver calls, store misses']}")
    print(f"  grafted rows [0, {p}) bitwise equal to the recomputed rows: "
          f"{bitwise}")
    print(f"  forward passes {passes}, launches {launches}")
    print(f"  launches by shape (each held in phase 3): {seen}")
    return {"launches": launches, "shapes": shapes,
            "fleet_prewarm": card["fleet prewarm"],
            "prefix_hits": card["prefix hits"]}


def scaleout_full(checked: set, store_dir: pathlib.Path) -> dict:
    """llama3-8b at full width, bf16, fused MLP (every MLP three B1
    launches and a goma_combine): two replicas of phase 11's deployment
    behind the router, over phase 11's trace with a shared prefix of 128
    tokens, a prefix cache and the n-gram drafter at width 4, planned from
    a fresh store by the donor's enumerated prewarm.  The replay: zero
    solver calls and store misses, exact launch counts, every launch at a
    shape phase 3 held, finite logits; a second fleet on the same store,
    timed; as a bf16 witness (reported, not held) the streams equal to
    the same trace served without spec and prefix cache.  Then in fp32,
    on the weights' first FP32_GATE_LAYERS layers, the same fleet and
    trace: every emitted token's logits row within PATH_TOL of scale of
    the teacher-forced static prefill."""
    from repro_torch.configs import get_config
    from repro_torch.core import hopper_mapping
    from repro_torch.core.solver import reset_solver_stats, solver_stats
    from repro_torch.models import build_model
    from repro_torch.obs.registry import get_registry
    from repro_torch.planner import PlanStore
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.router import (NgramDrafter, PrefixCache,
                                            ReplicaRouter, RouterConfig)
    from repro_torch.serving.sched import (SchedConfig, TrafficConfig,
                                           shared_prefix_trace)
    cfg = dataclasses.replace(get_config("llama3-8b"), fused_mlp=True)
    model = build_model(cfg)
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    trace = shared_prefix_trace(TrafficConfig(
        n_requests=SCHED_FULL["requests"],
        arrival_rate=SCHED_FULL["arrival_rate"],
        prompt_mix=SCHED_FULL["prompt_mix"],
        max_new_tokens=SCHED_FULL["new_tokens"], vocab=cfg.vocab,
        seed=SEED), prefix_len=SCALEOUT_FULL["prefix_len"])
    scfg = ServeConfig(max_new_tokens=SCHED_FULL["new_tokens"],
                       cache_len=SCALEOUT_FULL["cache_len"])
    sched_cfg = SchedConfig(slots=SCHED_FULL["slots"],
                            chunk_widths=SCHED_FULL["chunk_widths"],
                            spec_width=SCALEOUT_FULL["spec_width"],
                            prewarm_source="enumerated")
    reg = get_registry()

    def fleet(p, m, *, store=None, scale_out=True, on_token=None):
        cfg_r = sched_cfg if scale_out else dataclasses.replace(
            sched_cfg, spec_width=None)
        return ReplicaRouter(
            Engine(m, p, scfg, plan_store=store),
            RouterConfig(replicas=SCALEOUT_FULL["replicas"], sched=cfg_r),
            arch_id="llama3-8b" if store is not None else None,
            prefix_cache=PrefixCache(
                max(SCHED_FULL["chunk_widths"]),
                max_bytes=SCALEOUT_FULL["prefix_mib"] << 20)
            if scale_out else None,
            drafter=NgramDrafter() if scale_out else None,
            on_token=on_token)

    def streams_of(results):
        return {r.req_id: (r.tokens, r.finish_reason) for r in results}

    store = PlanStore(store_dir)
    try:
        reset_solver_stats()
        t0 = time.perf_counter()
        router = fleet(params, model, store=store)
        prewarm = {"seconds": time.perf_counter() - t0,
                   "solver_calls": solver_stats()["calls"],
                   "prewarmed_plans": router.prewarmed_plans,
                   "prewarmed_chains": router.scheds[0].prewarmed_chains,
                   "store": store.stats()}
        reset_solver_stats()
        misses = store.misses
        reg.reset()
        finite = watch_logits(model)
        reset_launches()
        seen = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with recording_shapes(seen):
            results = router.route_trace(trace)
        torch.cuda.synchronize()
        counts = launch_counts()
        solves = solver_stats()["calls"]
        passes = len(finite)
        del model._lm_logits
        want = {**{k: 0 for k in counts},
                "goma_matmul": 3 * cfg.layers * passes,
                "goma_combine": cfg.layers * passes}
        if solves or store.misses != misses or counts != want or \
                not all(bool(f) for f in finite):
            raise AssertionError(f"fleet replay: {solves} solver calls, "
                                 f"{store.misses - misses} store misses, "
                                 f"launches {counts} (want {want}), or "
                                 f"non-finite logits")
        shapes = held_shapes(seen, counts, checked)
        streams = streams_of(results)
        if any(len(t) != r.max_new_tokens or reason != "length"
               for r in trace for t, reason in [streams[r.req_id]]):
            raise AssertionError(f"bad streams {streams}")
        snap = reg.snapshot()
        scale = {k: snap.get(k, 0) for k in (
            "prefix.hits", "prefix.misses", "prefix.inserts",
            "sched.prefix_tokens_reused", "sched.spec.rounds",
            "sched.spec.drafted", "sched.spec.accepted", "router.routed",
            "router.replica0.routed", "router.replica1.routed")}
        summ = router.summary()
        peak = torch.cuda.max_memory_allocated() / 2**30
        # a second fleet on the same store, timed
        reset_solver_stats()
        torch.cuda.synchronize()
        timed = fleet(params, model, store=store)
        again = streams_of(timed.route_trace(trace))
        torch.cuda.synchronize()
        summ2 = timed.summary()
        solves2 = solver_stats()["calls"]
        if solves2:
            raise AssertionError(f"the second fleet made {solves2} solver "
                                 f"calls")
    finally:
        hopper_mapping.set_plan_store(None)
    del router, timed
    plain = streams_of(fleet(params, model, scale_out=False)
                       .route_trace(trace))
    witness = sum(streams[r][0] == plain[r][0] for r in streams)
    second = sum(streams[r][0] == again[r][0] for r in streams)
    print(f"  prewarm (donor, fresh store): {prewarm}")
    print(f"  replay: solver calls {solves}, store misses "
          f"{store.misses - misses}; forward passes {passes}, launches "
          f"{counts}")
    print(f"  launches by shape (each held in phase 3): {seen}")
    print(f"  scale-out counters: {scale} (each prefix insert copies the k "
          f"and v rows to the host: {2 * scale['prefix.inserts']} copies)")
    print(f"  fleet: tokens/s {summ['tokens_per_s']} over makespan "
          f"{summ['makespan_s']} s, ttft p50/p95 {summ['ttft_p50_s']}/"
          f"{summ['ttft_p95_s']} s, tpot p50 {summ['tpot_p50_s']} s, peak "
          f"memory {peak} GiB")
    print(f"  second fleet (timed): tokens/s {summ2['tokens_per_s']} over "
          f"makespan {summ2['makespan_s']} s, ttft p50/p95 "
          f"{summ2['ttft_p50_s']}/{summ2['ttft_p95_s']} s, tpot p50 "
          f"{summ2['tpot_p50_s']} s, solver calls 0; streams equal to the "
          f"first fleet's: {second} of {len(streams)}")
    print(f"  bf16 witness (reported, not held): {witness} of "
          f"{len(streams)} streams equal to the same trace without spec "
          f"and prefix cache")

    # fp32: the same weights' first layers, fleet and trace
    t0 = time.perf_counter()
    params32 = gate_params(params, FP32_GATE_LAYERS)
    del params
    free_device()
    model32 = build_model(dataclasses.replace(
        cfg, layers=FP32_GATE_LAYERS, compute_dtype="float32"))
    holder = {}
    rows, _, on_token = capture_emitted_logits(model32, holder)
    router = fleet(params32, model32, on_token=on_token)
    holder["scheds"] = router.scheds
    results = router.route_trace(trace)
    del model32.decode_step
    errs = teacher_forced_errs(model32, params32, trace, results, rows)
    worst = max(max(e) for e in errs.values())
    print(f"  fp32 at {FP32_GATE_LAYERS} layers ("
          f"{time.perf_counter() - t0:.1f} s): every emitted "
          f"token's logits row vs the teacher-forced static prefill, "
          f"largest max abs err {worst} (tol {PATH_TOL} x scale)")
    return {"launches": counts, "shapes": shapes,
            "serve": {"prewarm": prewarm, "solver_calls": solves,
                      "forward_passes": passes, "scale_out": scale,
                      "metrics": summ, "metrics_second_fleet": summ2,
                      "peak_memory_gib": peak,
                      "streams_equal_second_fleet": second,
                      "bf16_witness_equal_without_scale_out": witness,
                      "fp32_logits_err": errs}}


# device-kernel name fragments of the port's hand-written kernels
PORT_KERNELS = {"goma": "goma_", "b1": "goma_matmul", "wkv6": "wkv6_kernel",
                "ssd": "ssd_scan_kernel", "ssd_cb": "ssd_cb_kernel"}


# ------------------------------------------------------------- phase 15
def plan_cli(*args: str) -> subprocess.CompletedProcess:
    """``python -m repro_torch.plan ARGS`` in a second process."""
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.plan", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def cli_ok(res: subprocess.CompletedProcess, rc: int = 0) -> str:
    """The command's output, or raise unless it exited with ``rc``."""
    if res.returncode != rc:
        raise AssertionError(f"{res.args[3:]} exited {res.returncode}, not "
                             f"{rc}:\n{res.stdout[-2000:]}"
                             f"{res.stderr[-4000:]}")
    return res.stdout


def family_rows(rep) -> dict:
    """Each family's rows as the phase prints them: dims, predicted pJ,
    predicted DRAM bytes, measured ms, and the CTAs B1 launched."""
    from repro_torch.core.hopper_mapping import plan_gemm_tiling
    from repro_torch.kernels.goma_gemm import cta_slices, cta_tiles
    out: dict = {}
    for r in rep.rows:
        plan = plan_gemm_tiling(*r.dims, dtype_bytes=2)
        out.setdefault(r.gemm_type, []).append({
            "dims": list(r.dims), "predicted_pj": r.predicted_energy,
            "predicted_dram_bytes": r.predicted_bytes_per_level["dram"],
            "measured_ms": r.measured_time_s * 1e3,
            "ctas": len(cta_tiles(plan, cta_slices(plan))),
            "plan_key": r.plan_key[:12]})
    return out


def fidelity_phase(checked: set, gen, root: pathlib.Path) -> dict:
    """Fidelity replay and calibration on the card (ROADMAP A9).  The
    port's ``plan build`` writes FIDELITY's two manifests; each replays
    through B1 in bf16 (``obs.fidelity.replay_manifest``) on a fresh
    store: B1's launch count moves by exactly (warm-up + repeats) per
    distinct dispatched plan key, each row's plan key is the key under
    which the store holds the plan B1 ran, the rows round-trip through
    ``record_rows``/``load_rows``, and B1 is held against its plain
    version at every shape the replays launched it at.  Then the two
    replays' rows, recorded together, go through ``plan calibrate --save
    --spec h100-like`` in a second process, and the smoke config's
    captured manifest through ``plan fidelity`` (fp32) in another: each
    exit code is its report's gate, and the saved calibration loads.
    Spearman's rho per family is reported, not held (ROADMAP C8)."""
    from repro_torch.core import hopper_mapping
    from repro_torch.obs.calibrate import fit_jsonl, load_calibration
    from repro_torch.obs.fidelity import (FidelityRow, _finalize_report,
                                          load_rows, record_rows,
                                          replay_manifest)
    from repro_torch.planner import PlanStore
    from repro_torch.planner.manifest import ModelMappingManifest
    per_key = FIDELITY["warmup"] + FIDELITY["repeats"]
    manifests = {}
    for arch, m in FIDELITY["manifests"].items():
        path = root / f"{arch}.manifest.json"
        cli_ok(plan_cli("build", "--arch", arch,
                        "--seqs", ",".join(map(str, m["seqs"])),
                        "--decode-batches", ",".join(map(str, m["decode"])),
                        "--cache-len", str(m["cache_len"]), "--jobs", "4",
                        "--store", str(root / "build"),
                        "--manifest", str(path)))
        manifests[arch] = ModelMappingManifest.load(path)
    reports, out = {}, {}
    reset_launches()
    seen = {}
    with recording_shapes(seen):
        for arch, man in manifests.items():
            store = PlanStore(root / f"replay_{arch}")
            hopper_mapping.set_plan_store(store)
            before = launch_counts()["goma_matmul"]
            t0 = time.perf_counter()
            rep = replay_manifest(man, dtype="bfloat16",
                                  warmup=FIDELITY["warmup"],
                                  repeats=FIDELITY["repeats"])
            seconds = time.perf_counter() - t0
            keys = {r.plan_key for r in rep.rows}
            launched = launch_counts()["goma_matmul"] - before
            if launched != per_key * len(keys):
                raise AssertionError(f"{arch}: B1 launched {launched} "
                                     f"times, not {per_key} x {len(keys)} "
                                     f"dispatched keys")
            held = {e.digest: e for e in store.entries()}
            for r in rep.rows:
                plan = hopper_mapping.plan_gemm_tiling(*r.dims,
                                                       dtype_bytes=2)
                e = held.get(r.plan_key)
                if e is None or e.gemm_dims != plan.padded or \
                        tuple(e.mapping.L1) != plan.block:
                    raise AssertionError(f"{arch} {r.dims}: row key "
                                         f"{r.plan_key[:12]} is not the "
                                         f"store's key of B1's plan {plan}")
            path = record_rows(rep, root / "rows", arch)
            summary, back = load_rows(path)
            if [b.to_json() for b in back] != [r.to_json() for r in
                                               rep.rows] or \
                    summary["passes"] != rep.passes():
                raise AssertionError(f"{arch}: rows do not round-trip")
            reports[arch] = rep
            out[arch] = {"summary": rep.summary(), "seconds": seconds,
                         "rows": len(rep.rows), "keys": len(keys),
                         "launches": per_key * len(keys),
                         "families": family_rows(rep)}
    counts = launch_counts()
    hopper_mapping.set_plan_store(None)
    for name, shape, dt in sorted(seen):
        if (name, shape, dt) not in checked:
            checked.add(checked_key("goma_matmul", check_b1(
                shape, torch.bfloat16, gen, timed=False)))
    shapes = held_shapes(seen, counts, checked)
    # the calibration: both replays' rows in one file, fitted in a second
    # process; its exit code is the held-out gate of the same fit here
    cal_root = root / "calibration_store"
    rows = [FidelityRow.from_json(r.to_json())
            for rep in reports.values() for r in rep.rows]
    cal_rows = record_rows(_finalize_report(rows, gate=0.9, min_family=3),
                           cal_root, "bf16")
    fit = fit_jsonl(cal_rows)
    cal_out = cli_ok(plan_cli("calibrate", "--store", str(cal_root),
                              "--name", "bf16", "--save", "--spec",
                              "h100-like"), 0 if fit.passes() else 1)
    saved = load_calibration(cal_root / "calibration" / "calibration.json")
    if saved.get("h100-like") != fit.model:
        raise AssertionError(f"saved calibration {saved} != the fit "
                             f"{fit.model}")
    # the smoke config's captured manifest, fp32, through `plan fidelity`
    smoke_man = root / "smoke.manifest.json"
    cli_ok(plan_cli("capture", "--arch", "llama3-8b", "--smoke",
                    "--phase", "both", "--seq", str(FULL["prompt_len"]),
                    "--batch", str(FULL["batch"]), "--cache-len",
                    str(FIDELITY_SMOKE_CACHE), "--jobs", "4", "--store",
                    str(root / "build"), "--manifest", str(smoke_man)))
    smoke_rep = root / "smoke_report.json"
    res = plan_cli("fidelity", "--manifest", str(smoke_man), "--store",
                   str(root / "smoke_store"), "--name", "smoke", "--out",
                   str(smoke_rep))
    smoke = json.loads(smoke_rep.read_text())
    cli_ok(res, 0 if smoke["summary"]["passes"] else 1)
    # the fit as rates: ns/byte per level as GB/s, beside the data sheet's
    ns_per_byte = fit.model.ns_per_byte
    out["calibration"] = {
        "summary": fit.summary(), "holdout_err": fit.holdout_err,
        "baseline_holdout_err": fit.baseline_holdout_err,
        "passes": fit.passes(), "cli_rc": 0 if fit.passes() else 1,
        "ns_per_macc": fit.model.ns_per_macc, "ns_per_byte": ns_per_byte,
        "effective_gb_per_s": {lvl: (1.0 / v if v > 0 else None)
                               for lvl, v in ns_per_byte.items()},
        "hbm_data_sheet_gb_per_s": HBM_BYTES_PER_S / 1e9}
    out["smoke_fp32"] = {"summary": smoke["summary"],
                         "cli_rc": res.returncode}
    for arch, rep in reports.items():
        print(f"  {arch} (bf16): {out[arch]['rows']} rows, "
              f"{out[arch]['keys']} dispatched keys, B1 launched "
              f"{out[arch]['launches']} = {per_key} x "
              f"{out[arch]['keys']}, {out[arch]['seconds']:.1f} s; "
              f"Spearman rho per family {rep.families} (overall "
              f"{rep.overall}); passes {rep.passes()} (reported, not held)")
        for fam, frs in out[arch]["families"].items():
            print(f"    {fam}: {json.dumps(frs)}")
    print(f"  calibration (plan calibrate in a second process, exit "
          f"{out['calibration']['cli_rc']}): held-out |rel err| "
          f"calibrated {fit.holdout_err} vs compute-only "
          f"{fit.baseline_holdout_err}; ns/MAC {fit.model.ns_per_macc}, "
          f"ns/byte {ns_per_byte}; as rates (GB/s) "
          f"{out['calibration']['effective_gb_per_s']} beside the data "
          f"sheet's HBM3 {HBM_BYTES_PER_S / 1e9:.0f} GB/s (H100_LIKE has "
          f"no bandwidth entry); {cal_out.strip().splitlines()[-1]}")
    print(f"  smoke manifest (plan capture), fp32 through plan fidelity in "
          f"a second process: exit {res.returncode}, "
          f"{smoke['summary']}")
    return {"launches": counts, "shapes": shapes, "fidelity": out}


# ------------------------------------------------------------- phase 16
def capture_sched_full(checked: set, phase11: dict,
                       store_dir: pathlib.Path) -> dict:
    """Phase 11's deployment prewarmed through program capture (ROADMAP
    A10): a fresh store, the default ``prewarm_source="capture"`` and no
    arch_id, so the scheduler reads its GEMM groups off the model's own
    traced programs.  The capture allocates no device memory (the device
    allocations across construction are the two caches the scheduler
    makes, one per tensor), its groups
    differ from the enumerated tables' only where the reference's capture
    does (GQA-grouped attention products in jax's operand order, and the
    MLP products behind the opaque fused-MLP kernel), and the first replay
    makes no solver call and no store miss, launches B1 and goma_combine
    per pass as phase 11 at shapes phase 3 held, and gives phase 11's
    streams."""
    from repro_torch.configs import get_config
    from repro_torch.core import hopper_mapping
    from repro_torch.core.solver import reset_solver_stats, solver_stats
    from repro_torch.models import build_model
    from repro_torch.obs.registry import get_registry
    from repro_torch.obs.tracing import Tracer, set_tracer
    from repro_torch.planner import PlanStore
    from repro_torch.planner.batch import bucketed_serving_plan_shape_groups
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.sched import (ContinuousScheduler, SchedConfig,
                                           TraceClock, replay)
    cfg = dataclasses.replace(get_config("llama3-8b"), fused_mlp=True)
    model = build_model(cfg)
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    trace = sched_full_trace(cfg.vocab)
    scfg = ServeConfig(max_new_tokens=SCHED_FULL["new_tokens"],
                       cache_len=SCHED_FULL["cache_len"])
    store = PlanStore(store_dir)
    failures = get_registry().get("sched.prewarm_failures")
    clock = TraceClock()
    tracer = Tracer()
    prev = set_tracer(tracer)
    reset_solver_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    t0 = time.perf_counter()
    try:
        sched = ContinuousScheduler(
            Engine(model, params, scfg, plan_store=store),
            SchedConfig(slots=SCHED_FULL["slots"],
                        chunk_widths=SCHED_FULL["chunk_widths"]),
            clock=clock.now)
    finally:
        set_tracer(prev)
    prewarm_s = time.perf_counter() - t0
    # the device allocations across construction are the scheduler's two
    # caches (their tensors, one allocation each), nothing of the capture;
    # the bytes are reported beside them (the allocator rounds blocks up)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs
    cache_tensors = [*leaves(sched.slot_cache), *leaves(sched._prefill_cache)]
    peak = torch.cuda.max_memory_allocated() - base
    caches = sum(t.numel() * t.element_size() for t in cache_tensors)
    traces = tracer.by_name("capture.trace")
    capture_s = sum(sp.duration for sp in traces)
    prewarm = {"seconds": prewarm_s, "capture_seconds": capture_s,
               "programs": len(traces), "device_allocations": allocs,
               "cache_tensors": len(cache_tensors), "peak_delta_bytes": peak,
               "cache_bytes": caches, "solver_calls": solver_stats()["calls"],
               "prewarmed_plans": sched.prewarmed_plans,
               "prewarmed_chains": sched.prewarmed_chains,
               "store": store.stats()}
    if allocs != len(cache_tensors) or \
            len(traces) != len(SCHED_FULL["chunk_widths"]) + 1:
        raise AssertionError(f"the capture allocated device memory or "
                             f"traced another number of programs: "
                             f"{prewarm}")
    # the captured groups against the enumerated tables'
    enum = bucketed_serving_plan_shape_groups(
        "llama3-8b", slots=SCHED_FULL["slots"],
        chunk_widths=SCHED_FULL["chunk_widths"],
        cache_len=SCHED_FULL["cache_len"])
    T, hd, G = SCHED_FULL["cache_len"], cfg.head_dim, \
        cfg.n_heads // cfg.kv_heads
    ff, d = cfg.d_ff, cfg.d_model
    apart = {}
    for group, got in sched._plan_groups.items():
        # a chunk is one row of W tokens, decode a token in each slot;
        # attention's products are one per row and KV head (the weight)
        rows, S = ((SCHED_FULL["slots"], 1) if group == "decode" else
                   (int(group.removeprefix("chunk")),) * 2)
        diff = (sorted(set(enum[group]) - set(got)),
                sorted(set(got) - set(enum[group])))
        want = (sorted({(rows, T, hd), (rows, hd, T), (rows, ff, d),
                        (rows, d, ff)}),
                sorted({(T, S * G, hd), (hd, S * G, T)}))
        if diff != want:
            raise AssertionError(f"group {group}: enumerated only, captured "
                                 f"only {diff}, not {want}")
        apart[group] = diff
    reset_solver_stats()
    misses, hits = store.misses, store.hits
    torch.cuda.synchronize()
    reset_launches()
    seen = {}
    with recording_shapes(seen):
        results = replay(sched, trace, clock)
    torch.cuda.synchronize()
    counts = launch_counts()
    solves = solver_stats()["calls"]
    streams = {r.req_id: (r.tokens, r.finish_reason) for r in results}
    shapes = held_shapes(seen, counts, checked)
    hopper_mapping.set_plan_store(None)
    if solves or store.misses != misses or \
            get_registry().get("sched.prewarm_failures") != failures:
        raise AssertionError(f"the first replay after the capture prewarm "
                             f"made {solves} solver calls and "
                             f"{store.misses - misses} store misses, or a "
                             f"prewarm failed: {store.stats()}")
    passes = sched.metrics.prefill_chunks + sched.metrics.decode_steps
    want = {**{k: 0 for k in counts},
            "goma_matmul": 3 * cfg.layers * passes,
            "goma_combine": cfg.layers * passes}
    if counts != want:
        raise AssertionError(f"launches {counts} != {want} ({passes} "
                             f"forward passes; phase 11: "
                             f"{phase11['launches']})")
    if streams != phase11["streams"]:
        raise AssertionError(f"streams after the capture prewarm {streams} "
                             f"!= phase 11's {phase11['streams']}")
    summ = sched.metrics.summary()
    print(f"  capture prewarm: {prewarm_s} s ({capture_s} s tracing "
          f"{len(traces)} programs of {cfg.layers} layers); device "
          f"allocations across it {allocs} == the two caches' "
          f"{len(cache_tensors)} tensors (peak bytes {peak}, the caches' "
          f"{caches}); {prewarm['solver_calls']} solver calls, "
          f"{sched.prewarmed_plans} GEMM tilings, {sched.prewarmed_chains} "
          f"fused chains, store {prewarm['store']}")
    print(f"  captured vs enumerated groups (enumerated only, captured "
          f"only; ROADMAP A10): {apart}")
    print(f"  first replay: solver calls {solves}, store misses "
          f"{store.misses - misses}, hits {store.hits - hits}; streams == "
          f"phase 11's; forward passes {passes}, launches {counts}; "
          f"tokens/s {summ['tokens_per_s']}, ttft p50 {summ['ttft_p50_s']} "
          f"s, tpot p50 {summ['tpot_p50_s']} s")
    del sched, model, params, results
    free_device()
    return {"launches": counts, "shapes": shapes,
            "serve": {"prewarm": prewarm, "groups_apart": {
                g: [list(map(list, x)) for x in v] for g, v in apart.items()},
                "metrics": summ, "forward_passes": passes,
                "replay_solver_calls": solves,
                "replay_store_misses": store.misses - misses}}


def capture_fleet_smoke(checked: set, store_dir: pathlib.Path) -> dict:
    """Phase 14's fleet on llama3-8b's smoke config (2 replicas, prefix
    cache, spec at width 4) with a model drafter in place of the n-gram
    one, prewarmed through capture from a fresh store by the donor alone:
    the drafter's own ``draft.decode``/``draft.chunk`` groups are among
    the prewarmed groups with every plan in the store, the fleet's replay
    makes no solver call and no store miss, B2 runs once per layer and
    pass at shapes phase 3 held, and the streams are card == CPU ==
    static oracle."""
    from repro_torch.configs import get_config
    from repro_torch.core import hopper_mapping
    from repro_torch.core.solver import reset_solver_stats, solver_stats
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_to
    from repro_torch.planner import PlanStore
    from repro_torch.planner.batch import tile_plan_from_store
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.router import (ModelDrafter, PrefixCache,
                                            ReplicaRouter, RouterConfig)
    from repro_torch.serving.sched import SchedConfig
    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                              fused_mlp=True)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(SEED), "cpu")
    dparams = model.init_params(torch.Generator().manual_seed(SEED + 1),
                                "cpu")
    reqs = smoke_prefix_trace(cfg.vocab)
    scfg = ServeConfig(max_new_tokens=SCHED_SMOKE["new_tokens"],
                       cache_len=SCHED_SMOKE["cache_len"])
    knobs = dict(slots=SCHED_SMOKE["slots"],
                 chunk_widths=SCHED_SMOKE["chunk_widths"],
                 stop_token=SCHED_SMOKE["stop"],
                 spec_width=SPEC_SMOKE["spec_width"])

    def fleet(p, dp, store):
        return ReplicaRouter(
            Engine(model, p, scfg, plan_store=store),
            RouterConfig(replicas=2, sched=SchedConfig(**knobs)),
            drafter=ModelDrafter(Engine(model, dp, scfg, plan_store=store)),
            prefix_cache=PrefixCache(max(SCHED_SMOKE["chunk_widths"])))

    def route(router):
        return {r.req_id: (r.tokens, r.finish_reason)
                for r in router.route_trace(reqs)}

    try:
        cpu = route(fleet(params, dparams, PlanStore(store_dir / "cpu")))
        hopper_mapping.set_plan_store(None)
        store = PlanStore(store_dir / "card")
        card_params = tree_to(params, "cuda")
        reset_solver_stats()
        router = fleet(card_params, tree_to(dparams, "cuda"), store)
        prewarm = {"solver_calls": solver_stats()["calls"],
                   "puts": store.puts,
                   "groups": {g: len(v) for g, v in
                              router.scheds[0]._plan_groups.items()}}
        draft = {g: v for g, v in router.scheds[0]._plan_groups.items()
                 if g.startswith("draft.")}
        want = {"draft.decode", f"draft.chunk{SPEC_SMOKE['spec_width']}"}
        if set(draft) != want or not store.puts:
            raise AssertionError(f"the drafter's groups {sorted(draft)} are "
                                 f"not {sorted(want)}, or nothing was put")
        for s in {s for v in draft.values() for s in v}:
            tile_plan_from_store(store, *s, dtype_bytes=4)   # raises if not
        finite = watch_logits(model)
        reset_solver_stats()
        misses = store.misses
        reset_launches()
        seen = {}
        with recording_shapes(seen):
            card = route(router)
        launches = launch_counts()
        solves, missed = solver_stats()["calls"], store.misses - misses
    finally:
        hopper_mapping.set_plan_store(None)
    del model._lm_logits
    passes = len(finite)
    want_launches = {**{k: 0 for k in launches},
                     "goma_fused_matmul": cfg.layers * passes}
    if launches != want_launches or not all(bool(f) for f in finite):
        raise AssertionError(f"capture fleet launches {launches} != "
                             f"{want_launches} ({passes} passes), or "
                             f"non-finite logits")
    shapes = held_shapes(seen, launches, checked)
    if solves or missed:
        raise AssertionError(f"the fleet made {solves} solver calls and "
                             f"{missed} store misses after the prewarm")
    if card != cpu:
        raise AssertionError(f"card streams {card} != CPU streams {cpu}")
    oracle = Engine(model, card_params, ServeConfig(
        cache_len=SCHED_SMOKE["cache_len"]))
    for req in reqs:
        if card[req.req_id][0] != oracle_tokens(oracle, req):
            raise AssertionError(f"request {req.req_id}: {card[req.req_id]}"
                                 f" != the static oracle's")
    print(f"  capture-prewarmed fleet with a model drafter: prewarm "
          f"{prewarm}; the drafter's groups {draft}, every plan in the "
          f"store; replay solver calls {solves}, store misses {missed}")
    print(f"  streams card == cpu == static oracle: {card}")
    print(f"  forward passes {passes}, launches {launches}")
    return {"launches": launches, "shapes": shapes,
            "serve": {"prewarm": prewarm, "forward_passes": passes}}


# ------------------------------------------------------------- phase 17
def catalog_smoke(checked: set) -> dict:
    """The rest of the catalog's smoke configs, fp32, card tokens == CPU
    tokens: gemma2 with its fused MLP (B2) at a prompt past its window
    and a cache of three key blocks, llava with its 6-patch prefix (B2),
    seamless with its 6 frames (no GOMA kernel: its MLPs are plain, as
    the reference calls them), every B2 launch at a shape phase 3 held;
    and gemma2 behind the scheduler, card == CPU == static oracle."""
    runs = {}
    runs["serve gemma2-27b smoke"] = serve_smoke(
        "gemma2-27b", CATALOG_SMOKE["gemma2_prompt"], ("goma_fused_matmul",),
        cache_len=CATALOG_SMOKE["gemma2_cache"], checked=checked,
        fused_mlp=True)
    runs["serve llava-next-34b smoke"] = serve_smoke(
        "llava-next-34b", FULL["prompt_len"], ("goma_fused_matmul",),
        checked=checked, fused_mlp=True)
    launches = serve_smoke("seamless-m4t-medium", FULL["prompt_len"], ())
    if any(launches.values()):
        raise AssertionError(f"seamless smoke launched {launches}")
    runs["serve seamless-m4t-medium smoke"] = launches
    gemma = sched_smoke(checked, "gemma2-27b")
    runs["scheduler gemma2-27b smoke"] = gemma["launches"]
    return {"launches": runs, "shapes": {"scheduler gemma2-27b smoke":
                                         gemma["shapes"]}}


def gate_params(params: dict, layers: int) -> dict:
    """The served weights' first ``layers`` layers in fp32, made after
    the rest of the served layers are freed: the cut waits on the host
    while ``params["layers"]`` goes (the caller drops its references)."""
    from repro_torch.models.model import tree_to
    host = tree_to(first_layers(params["layers"], layers), "cpu")
    rest = {k: v for k, v in params.items() if k != "layers"}
    params.clear()
    free_device()
    return tree_float(dict(rest, layers=tree_to(host, "cuda")))


def gate_prefill(cfg, params32, prompts, extra) -> float:
    """The first prefill's logits at CATALOG_GATE_LAYERS layers in fp32:
    the kernel path (the fused MLP: B1 and goma_combine) against the
    plain path, within PATH_TOL of scale.  Returns the max abs error."""
    from repro_torch.models import build_model
    cfg4 = dataclasses.replace(cfg, layers=CATALOG_GATE_LAYERS,
                               compute_dtype="float32")
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                       device="cuda"), **(extra or {})}
    prefix = cfg.frontend_len if cfg.family == "vlm" else 0
    max_len = prefix + prompts.shape[1]
    with torch.inference_mode():
        want = build_model(dataclasses.replace(cfg4, fused_mlp=False)
                           ).prefill(params32, batch, max_len=max_len)[0]
        reset_launches()
        got = build_model(cfg4).prefill(params32, batch, max_len=max_len)[0]
    counts = launch_counts()
    if counts["goma_matmul"] != 3 * CATALOG_GATE_LAYERS:
        raise AssertionError(f"the gate's kernel path launched {counts}")
    return close_to_scale(got, want, PATH_TOL)


def gemma2_sched_trace(vocab: int) -> list:
    """GEMMA2_SCHED's trace: phase 11's Poisson arrivals and short
    prompts, with two requests' prompts past the window."""
    from repro_torch.serving.sched import TrafficConfig, poisson_trace
    g = GEMMA2_SCHED
    trace = poisson_trace(TrafficConfig(
        n_requests=g["requests"], arrival_rate=g["arrival_rate"],
        prompt_mix=(g["short"] + (1.0,),), max_new_tokens=g["new_tokens"],
        vocab=vocab, seed=SEED))
    rng = np.random.default_rng(SEED)
    for i in g["long_ids"]:
        n = int(rng.integers(g["long"][0], g["long"][1] + 1))
        trace[i] = dataclasses.replace(
            trace[i], tokens=rng.integers(0, vocab, (n,)).astype(np.int32))
    return trace


def gemma2_full(checked: set, store_dir: pathlib.Path, smi: str,
                out: pathlib.Path | None) -> dict:
    """gemma2-27b at its published widths and GEMMA2_LAYERS layers, bf16,
    fused MLP on (the chains do not fuse: three B1 launches and a
    goma_combine a layer a pass): the static generate (static_full), then
    GEMMA2_SCHED's trace behind the scheduler, prewarmed from a fresh
    plan store with the enumerated source (capture traces 9 key blocks a
    layer per program, PERF.md §7): exact launch counts, every launch at a shape phase 3 held, 0
    solver calls in both replays, the second one timed with equal
    streams; then the fp32 gate at CATALOG_GATE_LAYERS layers: the first
    prefill's kernel path against the plain path, and the trace again
    with every emitted token's logits row within PATH_TOL of scale of
    the teacher-forced static prefill."""
    from repro_torch.core.solver import reset_solver_stats, solver_stats
    from repro_torch.models import build_model
    from repro_torch.planner import PlanStore
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.sched import (ContinuousScheduler, SchedConfig,
                                           TraceClock, replay)
    cfg, model, params = make_full("gemma2-27b", fused_mlp=True,
                                   layers=GEMMA2_LAYERS)
    static = static_full(cfg, model, params, GEMMA2_FULL, checked, smi, out)
    free_device()

    g = GEMMA2_SCHED
    trace = gemma2_sched_trace(cfg.vocab)
    knobs = dict(slots=g["slots"], chunk_widths=g["chunk_widths"])
    scfg = ServeConfig(max_new_tokens=g["new_tokens"],
                       cache_len=g["cache_len"])
    store = PlanStore(store_dir)
    reset_solver_stats()
    t0 = time.perf_counter()
    clock = TraceClock()
    sched = ContinuousScheduler(
        Engine(model, params, scfg, plan_store=store),
        SchedConfig(**knobs, prewarm_source="enumerated"),
        arch_id="gemma2-27b", clock=clock.now)
    prewarm_s = time.perf_counter() - t0
    prewarm_solves = solver_stats()["calls"]
    print(f"  scheduler prewarm (enumerated, fresh store): "
          f"{sched.prewarmed_plans} GEMM tilings, {sched.prewarmed_chains} "
          f"chains, {prewarm_solves} solver calls in {prewarm_s} s")
    finite = watch_logits(model)
    reset_launches()
    reset_solver_stats()
    seen = {}
    with recording_shapes(seen):
        streams = {r.req_id: (r.tokens, r.finish_reason)
                   for r in replay(sched, trace, clock)}
    counts = launch_counts()
    first_solves = solver_stats()["calls"]
    del model._lm_logits
    passes = sched.metrics.prefill_chunks + sched.metrics.decode_steps
    want = {**{k: 0 for k in counts},
            "goma_matmul": 3 * cfg.layers * passes,
            "goma_combine": cfg.layers * passes}
    if counts != want or first_solves:
        raise AssertionError(f"scheduler launches {counts} != {want} "
                             f"({passes} passes) or {first_solves} solver "
                             f"calls")
    if len(finite) != passes or not all(bool(f) for f in finite):
        raise AssertionError(f"non-finite logits or {len(finite)} passes")
    shapes = held_shapes(seen, counts, checked)
    if any(len(streams[r.req_id][0]) != r.max_new_tokens for r in trace):
        raise AssertionError(f"bad streams {streams}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_solver_stats()
    timed, again = replay_trace(Engine(model, params, scfg, plan_store=store),
                                trace, arch_id="gemma2-27b",
                                prewarm_source="enumerated", **knobs)
    torch.cuda.synchronize()
    solves = solver_stats()["calls"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    if again != streams or solves:
        raise AssertionError(f"the timed replay made {solves} solver calls "
                             f"or gave other streams")
    summ = timed.metrics.summary()
    print(f"  scheduler: {len(trace)} requests (prompts "
          f"{[r.prompt_len for r in trace]}), streams {streams}")
    print(f"  forward passes {passes} ({sched.metrics.prefill_chunks} "
          f"prefill chunks, {sched.metrics.decode_steps} decode ticks), "
          f"launches {counts}, solver calls 0 and {solves}")
    print(f"  launches by shape (each held in phase 3): {seen}")
    print(f"  metrics: {summ}")
    print(f"  tokens/s {summ['tokens_per_s']}, ttft p50/p95 "
          f"{summ['ttft_p50_s']}/{summ['ttft_p95_s']} s, tpot p50 "
          f"{summ['tpot_p50_s']} s, peak memory {peak} GiB")
    del sched, timed

    # fp32: the served weights' first layers
    t0 = time.perf_counter()
    params32 = gate_params(params, CATALOG_GATE_LAYERS)
    del params
    prefill_err = gate_prefill(cfg, params32, static["prompts"], None)
    model32 = build_model(dataclasses.replace(
        cfg, layers=CATALOG_GATE_LAYERS, compute_dtype="float32"))
    clock = TraceClock()
    holder = {}
    rows, slot_of, on_token = capture_emitted_logits(model32, holder)
    sched = ContinuousScheduler(Engine(model32, params32, scfg),
                                SchedConfig(**knobs), clock=clock.now,
                                on_token=on_token)
    holder["scheds"] = [sched]
    results = replay(sched, trace, clock)
    del model32.decode_step
    errs = teacher_forced_errs(model32, params32, trace, results, rows)
    worst = max(max(e) for e in errs.values())
    print(f"  fp32 at {CATALOG_GATE_LAYERS} layers "
          f"({time.perf_counter() - t0:.1f} s): first prefill, kernel path "
          f"vs plain path, max abs err {prefill_err}; every emitted "
          f"token's logits row vs the teacher-forced static prefill, "
          f"largest max abs err {worst} (tol {PATH_TOL} x scale)")
    return {"launches": {"static": static["launches"], "scheduler": counts},
            "shapes": {"static": static["shapes"], "scheduler": shapes},
            "serve": {"static": static["serve"], "metrics": summ,
                      "peak_memory_gib": peak, "forward_passes": passes,
                      "prewarm_s": prewarm_s,
                      "prewarm_solver_calls": prewarm_solves,
                      "solver_calls": [first_solves, solves],
                      "fp32_prefill_err": prefill_err,
                      "fp32_logits_err": errs}}


def llava_full(checked: set, smi: str, out: pathlib.Path | None) -> dict:
    """llava-next-34b at its published widths, bf16, fused MLP on: the
    static generate with its 2880 patches (static_full); then, the model
    freed, the fp32 gate at CATALOG_GATE_LAYERS layers on the first
    prefill, kernel path against plain path."""
    cfg, model, params = make_full("llava-next-34b", fused_mlp=True)
    static = static_full(cfg, model, params, LLAVA_FULL, checked, smi, out)
    t0 = time.perf_counter()
    params32 = gate_params(params, CATALOG_GATE_LAYERS)
    del params
    err = gate_prefill(cfg, params32, static["prompts"], static["extra"])
    print(f"  fp32 at {CATALOG_GATE_LAYERS} layers "
          f"({time.perf_counter() - t0:.1f} s): first prefill, kernel path "
          f"vs plain path, max abs err {err} (tol {PATH_TOL} x scale)")
    return {"launches": static["launches"], "shapes": static["shapes"],
            "serve": dict(static["serve"], fp32_prefill_err=err)}


def seamless_full(checked: set, smi: str,
                  out: pathlib.Path | None) -> dict:
    """seamless-m4t-medium at its published widths, bf16: the static
    generate with its 1024 frames (static_full); no GOMA kernel launches
    (its MLPs are plain, as the reference calls them)."""
    cfg, model, params = make_full("seamless-m4t-medium")
    static = static_full(cfg, model, params, SEAMLESS_FULL, checked, smi,
                         out)
    return {"launches": static["launches"], "serve": static["serve"]}


# ------------------------------------------------------------- phase 18
def tp_smoke_setup(arch: str, knobs: dict):
    """A smoke config as serve_smoke serves it: (model, weights made on
    the CPU from the seed, prompts, the frontend's inputs or None,
    serving config)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeConfig
    model = build_model(dataclasses.replace(get_config(arch, smoke=True),
                                            **knobs))
    params = model.init_params(torch.Generator().manual_seed(SEED), "cpu")
    prompts = np.random.default_rng(SEED).integers(
        0, model.cfg.vocab, (FULL["batch"], FULL["prompt_len"])).astype(
        np.int32)
    return model, params, prompts, frontend_inputs(
        model.cfg, FULL["batch"], "cpu"), ServeConfig(
        max_new_tokens=FULL["new_tokens"], cache_len=32)


def smoke_kernels(cfg) -> tuple[str, ...]:
    """The kernels a smoke config's generate must launch on the card."""
    return tuple(name for name, on in (
        ("goma_fused_matmul", cfg.fused_mlp),
        ("wkv6_scan", cfg.use_pallas_scan and cfg.family == "rwkv"),
        ("ssd_scan", cfg.use_pallas_scan and cfg.family == "hybrid"))
        if on)


def tp_smoke_rank(world: int, arch: str, knobs: dict, checked: set) -> dict:
    """One rank of a smoke config sharded over ``world`` ranks: greedy
    tokens with the ranks on the CPU (gloo over CPU tensors) and on the
    card (gloo over CUDA tensors), every kernel the config runs launched
    on the card at a shape phase 3 held (B2 at the local d_ff, the scans
    at the rank's heads), and the generate's all_reduces exactly the
    layout's (a prefill and new - 1 decode passes)."""
    from repro_torch.dist.serve import shard_engine
    from repro_torch.models.model import tree_to
    from repro_torch.serving import Engine
    model, params, prompts, extra, scfg = tp_smoke_setup(arch, knobs)
    cpu = Engine(model, params, scfg)
    shard_engine(cpu, model_axis=world)
    cpu_tokens = cpu.generate(prompts, extra_batch=extra)
    card = Engine(model, tree_to(params, "cuda"), scfg)
    shard_engine(card, model_axis=world)
    reset_launches()
    seen = {}
    with recording_shapes(seen):
        card_tokens = card.generate(prompts, extra_batch=extra)
    launches = launch_counts()
    shapes = held_shapes(seen, launches, checked)
    missing = [k for k in smoke_kernels(model.cfg) if launches[k] <= 0]
    tp = card.model.tp
    want = (tp.per_pass(prefill=True)
            + (scfg.max_new_tokens - 1) * tp.per_pass(prefill=False))
    if missing or tp.all_reduces != want:
        raise AssertionError(f"the {arch} smoke run on {world} ranks never "
                             f"launched {missing} ({launches}), or made "
                             f"{tp.all_reduces} all_reduces, not {want}")
    return {"cpu": cpu_tokens, "card": card_tokens, "launches": launches,
            "shapes": shapes, "all_reduces": tp.all_reduces,
            "replicated": tp.replicated, "relaid": tp.relaid}


def all_reduce_ms(group, shape, dtype, reps: int = 20) -> float:
    """Median wall time of one gloo all_reduce of a CUDA tensor of
    ``shape`` over ``group``, from a synchronised card to a synchronised
    card (host-staged: the copies to and from the host included)."""
    import torch.distributed as dist
    x = torch.zeros(shape, dtype=dtype, device="cuda")
    dist.all_reduce(x, group=group)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(x, group=group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def full_prompts(cfg) -> np.ndarray:
    """Phase 5's prompts."""
    return np.random.default_rng(SEED).integers(
        0, cfg.vocab, (FULL["batch"], FULL["prompt_len"])).astype(np.int32)


def tp_full_rank(world: int, checked: set, store_dir: str) -> dict:
    """One rank of llama3-8b at its published widths and TP_SERVE's
    full_layers layers, bf16, fused MLP on, split over ``world`` ranks: the rank's slices made on the card
    leaf by leaf from phase 5's seed, the plan store prewarmed from the
    rank's own captured programs (rank 0 first, the others then read
    it), then phase 5's static generate: 0 solver calls, exact launches
    (three B1 and a goma_combine a layer a pass) at shapes phase 3 held,
    2 all_reduces a layer and 2 for the split vocabulary a pass, one
    token check a step; a second, timed generate with equal tokens, and
    the host time this rank spent inside its all_reduce calls in it
    (gloo stages a CUDA tensor through the host and returns after the
    host-side sum, with the copy back queued: the time includes waiting
    for the device work queued before the call and for the other
    ranks); the time of one all_reduce at the pass's shapes, alone."""
    from repro_torch.configs import get_config
    from repro_torch.core.solver import reset_solver_stats, solver_stats
    from repro_torch.dist.serve import shard_model
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.planner.store import PlanStore
    from repro_torch.serving import Engine, ServeConfig
    mesh = make_host_mesh(model=world)
    cfg = dataclasses.replace(get_config(FULL["arch"]), fused_mlp=True,
                              layers=TP_SERVE["full_layers"])
    model = shard_model(build_model(cfg), mesh)
    tp = model.tp
    B, S, new = FULL["batch"], FULL["prompt_len"], FULL["new_tokens"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    made = {"seconds": time.perf_counter() - t0,
            "weights_gib": torch.cuda.memory_allocated() / 2**30,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    prompts = full_prompts(cfg)
    eng = Engine(model, params, ServeConfig(max_new_tokens=new,
                                            cache_len=S + new + 8),
                 plan_store=PlanStore(store_dir))
    reset_solver_stats()
    t0 = time.perf_counter()
    planned = eng.prewarm_plans(FULL["arch"], B, S)
    prewarm = {"seconds": time.perf_counter() - t0, "tilings": planned,
               "solver_calls": solver_stats()["calls"]}
    finite = watch_logits(model)
    reset_solver_stats()
    reset_launches()
    tp.all_reduces = tp.token_checks = 0
    seen = {}
    t0 = time.perf_counter()
    with recording_shapes(seen):
        tokens = eng.generate(prompts)
    first_s = time.perf_counter() - t0
    counts, solves, passes = launch_counts(), solver_stats()["calls"], \
        len(finite)
    reduces, checks = tp.all_reduces, tp.token_checks
    del model._lm_logits
    if not all(bool(f) for f in finite):
        raise AssertionError("non-finite logits on a tensor-parallel rank")
    want = expected_launches(cfg, passes)
    per_pass = 2 * cfg.layers + 2
    if (solves or counts != want or reduces != per_pass * passes
            or checks != new):
        raise AssertionError(
            f"rank {mesh.rank} of {world}: {solves} solver calls, launches "
            f"{counts} (want {want}), {reduces} all_reduces (want "
            f"{per_pass} x {passes}), {checks} token checks (want {new})")
    shapes = held_shapes(seen, counts, checked)
    inside, reduce = [], tp.all_reduce

    def timed_reduce(x, *kind):
        t = time.perf_counter()
        y = reduce(x, *kind)
        inside.append(time.perf_counter() - t)
        return y

    tp.all_reduce = timed_reduce
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = eng.generate(prompts)
    dt = time.perf_counter() - t0
    del tp.all_reduce
    if not np.array_equal(again, tokens):
        raise AssertionError("a second greedy run gave other tokens")
    group, d, V = tp.group, cfg.d_model, cfg.padded_vocab
    reduce_ms = {
        f"{what} ({' x '.join(map(str, shape))} {dtype_name(dtype)})":
            all_reduce_ms(group, shape, dtype)
        for what, shape, dtype in (
            ("layer, decode", (B, 1, d), torch.bfloat16),
            ("layer, prefill", (B, S, d), torch.bfloat16),
            ("embedding, decode", (B, 1, d), torch.float32),
            ("logits, decode", (B, 1, V), torch.float32))}
    return {"tokens": tokens, "launches": counts, "shapes": shapes,
            "serve": {"tokens_per_s": B * new / dt, "seconds": dt,
                      "all_reduce_seconds_in_generate": sum(inside),
                      "all_reduce_share_of_generate": sum(inside) / dt,
                      "first_run_seconds": first_s, "forward_passes": passes,
                      "all_reduces_per_pass": reduces / passes,
                      "token_checks": checks, "solver_calls": solves,
                      "made": made, "prewarm": prewarm,
                      "peak_memory_gib":
                          torch.cuda.max_memory_allocated() / 2**30,
                      "all_reduce_ms": reduce_ms}}


def tp_gate_logits(mesh=None) -> torch.Tensor:
    """The first prefill's logits of llama3-8b at TP_SERVE's gate depth,
    full width, fp32, fused MLP on, weights from the seed (on ``mesh``,
    this rank's slices of the same weights), on the host."""
    from repro_torch.configs import get_config
    from repro_torch.dist.serve import shard_model
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(FULL["arch"]), fused_mlp=True,
                              layers=TP_SERVE["gate_layers"],
                              compute_dtype="float32")
    model = build_model(cfg)
    if mesh is not None:
        model = shard_model(model, mesh)
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    toks = torch.as_tensor(full_prompts(cfg), dtype=torch.int64,
                           device="cuda")
    with torch.inference_mode():
        logits = model.prefill(params, {"tokens": toks},
                               max_len=FULL["prompt_len"])[0]
    return logits.cpu()


def tp_rank(rank: int, world: int, checked: set, store_dir: str) -> dict:
    """Everything phase 18 runs on one rank of ``world``."""
    from repro_torch.launch.mesh import make_host_mesh
    out = {"smoke": {arch: tp_smoke_rank(world, arch, knobs, checked)
                     for arch, knobs in TP_SERVE["smoke"]}}
    out["full"] = tp_full_rank(world, checked, store_dir)
    free_device()
    out["gate"] = tp_gate_logits(make_host_mesh(model=world))
    return out


def tp_serve(checked: set, store_root: pathlib.Path) -> dict:
    """Phase 18: for each world of TP_SERVE, its ranks spawned over gloo on
    the one card (the kernels built by phase 2, so no rank builds them).
    The smoke configs' tokens card == CPU == the single-rank oracle on
    every rank; llama3-8b at full width and TP_SERVE's full_layers
    (tp_full_rank) with every rank's gates; the fp32 gate's logits within
    PATH_TOL of scale of the single rank's.  Reported: tokens/s, peak
    memory per rank, time per all_reduce."""
    from repro_torch.launch.mesh import run_ranks
    oracle = {arch: smoke_oracle(arch, knobs)
              for arch, knobs in TP_SERVE["smoke"]}
    want = tp_gate_logits()
    free_device()
    report, runs, shapes = {}, {}, {}
    for world in TP_SERVE["worlds"]:
        t0 = time.perf_counter()
        ranks = run_ranks(tp_rank, world, world, checked,
                          str(store_root / f"tp{world}"), timeout_s=300)
        seconds = time.perf_counter() - t0
        gate = []
        for r, got in enumerate(ranks):
            for arch, want_tokens in oracle.items():
                run = got["smoke"][arch]
                if not (np.array_equal(run["card"], want_tokens)
                        and np.array_equal(run["cpu"], want_tokens)):
                    raise AssertionError(
                        f"{arch} smoke on rank {r} of {world}: card "
                        f"{run['card'].tolist()}, cpu {run['cpu'].tolist()}, "
                        f"single rank {want_tokens.tolist()}")
            if not np.array_equal(got["full"]["tokens"],
                                  ranks[0]["full"]["tokens"]):
                raise AssertionError(f"rank {r} of {world} served other "
                                     f"tokens than rank 0")
            gate.append(close_to_scale(got["gate"], want, PATH_TOL))
        full = ranks[0]["full"]
        serve = dict(full["serve"], seconds_phase=seconds,
                     gate_max_abs_err=gate,
                     gate_scale=float(want.abs().max()),
                     peak_memory_gib_by_rank=[
                         g["full"]["serve"]["peak_memory_gib"]
                         for g in ranks])
        report[world] = serve
        for arch in oracle:
            runs[f"TP{world} {arch} smoke (rank 0)"] = \
                ranks[0]["smoke"][arch]["launches"]
            shapes[f"TP{world} {arch} smoke (rank 0)"] = \
                ranks[0]["smoke"][arch]["shapes"]
        runs[f"TP{world} llama3-8b full width (rank 0)"] = full["launches"]
        shapes[f"TP{world} llama3-8b full width (rank 0)"] = full["shapes"]
        print(f"  TP {world}: smoke tokens card == cpu == single rank "
              f"({', '.join(oracle)}); smoke all_reduces "
              f"{ {a: ranks[0]['smoke'][a]['all_reduces'] for a in oracle} }")
        print(f"  TP {world}: llama3-8b full width at "
              f"{TP_SERVE['full_layers']} layers, tokens "
              f"{full['tokens'].tolist()}")
        print(f"  TP {world}: {serve['tokens_per_s']} tokens/s; launches per "
              f"rank {full['launches']}; {serve['all_reduces_per_pass']} "
              f"all_reduces a pass, {serve['token_checks']} token checks")
        print(f"  TP {world}: peak memory by rank "
              f"{serve['peak_memory_gib_by_rank']} GiB; made "
              f"{serve['made']}; prewarm {serve['prewarm']}")
        print(f"  TP {world}: all_reduce ms (gloo over CUDA tensors, "
              f"host-staged, ranks sharing one card), each alone: "
              f"{serve['all_reduce_ms']}")
        print(f"  TP {world}: host seconds inside all_reduce in the timed "
              f"generate by rank (waits for queued device work and the "
              f"other ranks included): "
              f"{[g['full']['serve']['all_reduce_seconds_in_generate'] for g in ranks]}"
              f" of {[g['full']['serve']['seconds'] for g in ranks]} s")
        print(f"  TP {world}: fp32 gate at {TP_SERVE['gate_layers']} layers, "
              f"max abs err by rank {gate} (scale {serve['gate_scale']}, "
              f"tol {PATH_TOL} x scale); {seconds:.1f} s")
    return {"serve": report, "launches": runs, "shapes": shapes}


def smoke_oracle(arch: str, knobs: dict) -> np.ndarray:
    """A smoke config's greedy tokens on one CPU device (tp_smoke_setup's
    weights, prompts and frontend inputs)."""
    from repro_torch.serving import Engine
    model, params, prompts, extra, scfg = tp_smoke_setup(arch, knobs)
    return Engine(model, params, scfg).generate(prompts, extra_batch=extra)


# ------------------------------------------------------------- phase 19
def tp_smoke_scans() -> tuple[list, list]:
    """The B3 and B4 shapes (B, S, H, P[, N]) phase 19a's smoke configs
    launch on a rank at each TP of TP_REST: phase 4's batch, the prompt
    padded to the chunk, the rank's heads as its layout gives them (the
    time mix of rwkv6-7b smoke stays whole at TP 4, ROADMAP C14)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.models import build_model
    from repro_torch.models.parallel import TensorParallel
    wkv, ssd = [], []
    for n in TP_REST["worlds"]:
        mesh = HostMesh(shape={"data": 1, "model": n},
                        axis_names=("data", "model"), rank=0,
                        coords={"data": 0, "model": 0})
        for arch, _ in TP_REST["smoke"]:
            cfg = get_config(arch, smoke=True)
            S = -(-FULL["prompt_len"] // cfg.ssd_chunk) * cfg.ssd_chunk
            if cfg.family == "rwkv":
                tp = TensorParallel(build_model(cfg), mesh)
                wkv.append((FULL["batch"], S, tp.rwkv_heads, 64))
            elif cfg.family == "hybrid":
                tp = TensorParallel(build_model(cfg), mesh)
                ssd.append((FULL["batch"], S, tp.ssm_heads,
                            cfg.ssm_head_dim, cfg.ssm_state))
    return wkv, ssd


def streams_of(results) -> dict:
    return {r.req_id: (r.tokens, r.finish_reason) for r in results}


def sched_smoke_oracle(arch: str, knobs: dict, replicas: int = 0) -> dict:
    """Phase 10's trace on one CPU device through the scheduler (or a
    router of ``replicas``), every stream held against the static oracle:
    the streams."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.router import ReplicaRouter, RouterConfig
    from repro_torch.serving.sched import SchedConfig
    cfg = dataclasses.replace(get_config(arch, smoke=True), **knobs)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(SEED), "cpu")
    reqs = smoke_trace(cfg.vocab)
    scfg = ServeConfig(max_new_tokens=SCHED_SMOKE["new_tokens"],
                       cache_len=SCHED_SMOKE["cache_len"])
    sknobs = dict(slots=SCHED_SMOKE["slots"],
                  chunk_widths=SCHED_SMOKE["chunk_widths"],
                  stop_token=SCHED_SMOKE["stop"])
    if replicas:
        got = streams_of(ReplicaRouter(Engine(model, params, scfg),
                                       RouterConfig(
                                           replicas=replicas,
                                           sched=SchedConfig(**sknobs)))
                         .route_trace(reqs))
    else:
        _, got = replay_trace(Engine(model, params, scfg), reqs, **sknobs)
    oracle = Engine(model, params, ServeConfig(
        cache_len=SCHED_SMOKE["cache_len"]))
    for req in reqs:
        if got[req.req_id][0] != oracle_tokens(oracle, req):
            raise AssertionError(f"{arch} request {req.req_id}: one rank's "
                                 f"scheduler {got[req.req_id]} != the "
                                 f"static oracle")
    return got


def tp_sched_smoke_rank(world: int, arch: str, knobs: dict, checked: set,
                        store_dir: str, replicas: int = 0) -> dict:
    """One rank of phase 10's trace on a smoke config sharded over
    ``world`` ranks, behind a continuous scheduler (or a router of
    ``replicas``) in trace time from a RankClock: the streams with the
    ranks on the CPU and on the card; on the card from a fresh plan
    store that rank 0 prewarms first, with 0 solver calls in the replay,
    B2 (fused) once a layer a forward pass at shapes phase 3 held, and
    the broadcasts (2 a tick: rank 0's orders and its tick time)."""
    from repro_torch.configs import get_config
    from repro_torch.core.solver import reset_solver_stats, solver_stats
    from repro_torch.dist.serve import shard_engine
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_to
    from repro_torch.planner.store import PlanStore
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.router import RouterConfig
    from repro_torch.serving.router.tp import TPReplicaRouter
    from repro_torch.serving.sched import (ContinuousScheduler, SchedConfig,
                                           replay)
    from repro_torch.serving.sched.tp import RankClock
    cfg = dataclasses.replace(get_config(arch, smoke=True), **knobs)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(SEED), "cpu")
    reqs = smoke_trace(cfg.vocab)
    scfg = ServeConfig(max_new_tokens=SCHED_SMOKE["new_tokens"],
                       cache_len=SCHED_SMOKE["cache_len"])
    sknobs = SchedConfig(slots=SCHED_SMOKE["slots"],
                         chunk_widths=SCHED_SMOKE["chunk_widths"],
                         stop_token=SCHED_SMOKE["stop"])

    def deploy(params, store=None):
        eng = Engine(model, params, scfg, plan_store=store)
        shard_engine(eng, model_axis=world)
        if replicas:
            router = TPReplicaRouter(eng, RouterConfig(replicas=replicas,
                                                       sched=sknobs))
            return eng, router.scheds, lambda: router.route_trace(reqs)
        clock = RankClock(eng.model.tp)
        sched = ContinuousScheduler(eng, sknobs, clock=clock.now)
        return eng, [sched], lambda: replay(sched, reqs, clock)

    cpu = streams_of(deploy(params)[2]())
    eng, scheds, run = deploy(tree_to(params, "cuda"), PlanStore(store_dir))
    tp = eng.model.tp
    tp.broadcasts = 0
    reset_solver_stats()
    reset_launches()
    seen = {}
    with recording_shapes(seen):
        card = streams_of(run())
    launches = launch_counts()
    solves = solver_stats()["calls"]
    passes = sum(s.metrics.prefill_chunks + s.metrics.decode_steps
                 for s in scheds)
    ticks = sum(s.metrics.steps for s in scheds)
    want = {**{k: 0 for k in launches},
            "goma_fused_matmul": cfg.layers * passes * cfg.fused_mlp}
    if launches != want or solves or tp.broadcasts != 2 * ticks:
        raise AssertionError(
            f"{arch} scheduler smoke on {world} ranks: launches {launches} "
            f"(want {want}, {passes} forward passes), {solves} solver "
            f"calls, {tp.broadcasts} broadcasts in {ticks} ticks")
    return {"cpu": cpu, "card": card, "launches": launches,
            "shapes": held_shapes(seen, launches, checked),
            "ticks": ticks, "broadcasts": tp.broadcasts,
            "per_replica": [len(s.results) for s in scheds]}


def timed_collectives(tp) -> dict:
    """Wrap ``tp``'s all_reduce, broadcast and tokens_agree (instance
    attributes, so that ``del tp.all_reduce`` undoes it) to sum the host
    seconds spent inside each, into the returned dict.  A collective's
    time includes the wait for the ranks that reach it later."""
    inside = {"all_reduce": 0.0, "broadcast": 0.0, "tokens_agree": 0.0}

    def timed(name):
        fn = getattr(tp, name)

        def call(x, *kind):
            t = time.perf_counter()
            y = fn(x, *kind)
            inside[name] += time.perf_counter() - t
            return y
        return call

    for name in inside:
        setattr(tp, name, timed(name))
    return inside


def tp_sched_full_rank(world: int, checked: set, store_dir: str) -> dict:
    """One rank of phase 11's deployment (llama3-8b, bf16, fused MLP on) at
    TP_REST's depth, sharded over ``world`` ranks: the rank's slices made on the card leaf
    by leaf from the seed, the scheduler prewarmed by capture into a
    fresh store (rank 0 first, the others then read it), then phase 11's
    trace in trace time from a RankClock: 0 solver calls and 0 store
    misses, B1 3 and goma_combine 1 a layer and forward pass at shapes
    phase 3 held, finite logits; its metrics, peak memory, broadcasts a tick and
    host seconds inside all_reduce and broadcast.  Then the fp32 gate at
    TP_REST's depth: the trace again on the rank's fp32 slices, every
    emitted token's logits row within PATH_TOL of scale of the
    teacher-forced prefill of one unsharded model of the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.core.solver import reset_solver_stats, solver_stats
    from repro_torch.dist.serve import shard_model
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.planner.store import PlanStore
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.sched import (ContinuousScheduler, SchedConfig,
                                           replay)
    from repro_torch.serving.sched.tp import RankClock
    mesh = make_host_mesh(model=world)
    cfg = dataclasses.replace(get_config("llama3-8b"), fused_mlp=True,
                              layers=TP_REST["deploy_layers"])
    model = shard_model(build_model(cfg), mesh)
    tp = model.tp
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    weights = torch.cuda.memory_allocated() / 2**30
    trace = sched_full_trace(cfg.vocab)
    scfg = ServeConfig(max_new_tokens=SCHED_FULL["new_tokens"],
                       cache_len=SCHED_FULL["cache_len"])
    knobs = SchedConfig(slots=SCHED_FULL["slots"],
                        chunk_widths=SCHED_FULL["chunk_widths"])
    store = PlanStore(store_dir)
    clock = RankClock(tp)
    reset_solver_stats()
    t0 = time.perf_counter()
    sched = ContinuousScheduler(Engine(model, params, scfg,
                                       plan_store=store), knobs,
                                clock=clock.now)
    prewarm = {"seconds": time.perf_counter() - t0,
               "solver_calls": solver_stats()["calls"],
               "tilings": sched.prewarmed_plans, "store": store.stats()}
    finite = watch_logits(model)
    reset_solver_stats()
    reset_launches()
    misses = store.misses
    tp.all_reduces = tp.broadcasts = tp.token_checks = 0
    inside = timed_collectives(tp)
    seen = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_shapes(seen):
        results = replay(sched, trace, clock)
    wall = time.perf_counter() - t0
    del tp.all_reduce, tp.broadcast, tp.tokens_agree, model._lm_logits
    counts, solves = launch_counts(), solver_stats()["calls"]
    passes = sched.metrics.prefill_chunks + sched.metrics.decode_steps
    want = {**{k: 0 for k in counts},
            "goma_matmul": 3 * cfg.layers * passes,
            "goma_combine": cfg.layers * passes}
    if (solves or store.misses != misses or counts != want
            or len(finite) != passes or not all(bool(f) for f in finite)):
        raise AssertionError(
            f"rank {mesh.rank} of {world}: {solves} solver calls, "
            f"{store.misses - misses} store misses, launches {counts} (want "
            f"{want}), {len(finite)} passes of {passes} or non-finite "
            f"logits")
    shapes = held_shapes(seen, counts, checked)
    summ = sched.metrics.summary()
    serve = {"metrics": summ, "prewarm": prewarm, "weights_gib": weights,
             "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
             "forward_passes": passes, "ticks": summ["steps"],
             "replay_wall_seconds": wall,
             "broadcasts_per_tick": tp.broadcasts / summ["steps"],
             "all_reduces_per_pass": tp.all_reduces / passes,
             "token_checks": tp.token_checks, "host_seconds_inside": inside,
             "solver_calls": solves,
             "store_misses": store.misses - misses}
    streams = streams_of(results)
    del sched, params, results
    free_device()

    # fp32 at TP_REST's depth: the rank's slices against one whole model
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32",
                                layers=TP_REST["gate_layers"]["llama3-8b"])
    model32 = shard_model(build_model(cfg32), mesh)
    params32 = model32.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    clock = RankClock(model32.tp)
    holder = {}
    rows, slot_of, on_token = capture_emitted_logits(model32, holder)
    sched = ContinuousScheduler(Engine(model32, params32, scfg), knobs,
                                clock=clock.now, on_token=on_token)
    holder["scheds"] = [sched]
    results = replay(sched, trace, clock)
    del model32.decode_step, sched, params32
    free_device()
    whole = build_model(cfg32)
    errs = teacher_forced_errs(
        whole, whole.init_params(
            torch.Generator(device="cuda").manual_seed(SEED), "cuda"),
        trace, results, rows)
    serve["fp32_logits_max_err"] = max(max(e) for e in errs.values())
    serve["fp32_slots_used"] = len(set(slot_of.values()))
    return {"streams": streams, "launches": counts, "shapes": shapes,
            "serve": serve}


def tp_recurrent_rank(world: int, arch: str, knobs: dict,
                      checked: set) -> dict:
    """One rank of ``arch`` at its published widths, bf16, with the
    config ``knobs`` (the scan kernel; zamba2-2.7b's fused MLP), sharded
    over ``world`` ranks, on phases 8 and 9's static path: the rank's
    slices made on the card leaf by leaf from the seed, then one generate
    with exact launches (B3 or B4 once a layer in the prefill at the
    rank's heads; B1 3 and goma_combine 1 a shared-block application a
    pass) at shapes phase 3 held, the layout's all_reduces a pass and
    finite logits; a second, timed generate with equal tokens and the
    host seconds inside all_reduce.  Then the fp32 gate at TP_REST's
    depth: the first prefill's logits through the kernels against the
    plain path's (chunked scans, plain MLP), both on the rank's slices of
    the same weights, within PATH_TOL of scale."""
    from repro_torch.configs import get_config
    from repro_torch.dist.serve import shard_model
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, ServeConfig
    mesh = make_host_mesh(model=world)
    cfg = dataclasses.replace(get_config(arch), **knobs)
    model = shard_model(build_model(cfg), mesh)
    tp = model.tp
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    made = {"seconds": time.perf_counter() - t0,
            "weights_gib": torch.cuda.memory_allocated() / 2**30}
    B, S, new = FULL["batch"], RECURRENT["prompt_len"], FULL["new_tokens"]
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    eng = Engine(model, params, ServeConfig(max_new_tokens=new,
                                            cache_len=S + new + 8))
    finite = watch_logits(model)
    reset_launches()
    tp.all_reduces = 0
    seen = {}
    with recording_shapes(seen):
        tokens = eng.generate(prompts)
    counts, passes, reduces = launch_counts(), len(finite), tp.all_reduces
    del model._lm_logits
    want = expected_launches(cfg, passes)
    per_pass = (tp.per_pass(prefill=True)
                + (passes - 1) * tp.per_pass(prefill=False))
    if counts != want or reduces != per_pass or \
            not all(bool(f) for f in finite):
        raise AssertionError(
            f"{arch} rank {mesh.rank} of {world}: launches {counts} (want "
            f"{want}), {reduces} all_reduces (want {per_pass}), or "
            f"non-finite logits")
    shapes = held_shapes(seen, counts, checked)
    inside = timed_collectives(tp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = eng.generate(prompts)
    dt = time.perf_counter() - t0
    del tp.all_reduce, tp.broadcast, tp.tokens_agree
    if not np.array_equal(again, tokens):
        raise AssertionError("a second greedy run gave other tokens")
    serve = {"tokens_per_s": B * new / dt, "seconds": dt, "made": made,
             "forward_passes": passes,
             "all_reduces_per_pass": tp.per_pass(prefill=False),
             "all_reduce_seconds_in_generate": inside["all_reduce"],
             "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    del eng, params
    free_device()

    # fp32 at TP_REST's depth: kernel path against plain path
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32",
                                layers=TP_REST["gate_layers"][arch])
    model32 = shard_model(build_model(cfg32), mesh)
    params32 = model32.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    plain = dataclasses.replace(model32, cfg=dataclasses.replace(
        cfg32, use_pallas_scan=False, fused_mlp=False))
    toks = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
    with torch.inference_mode():
        got, want = (m.prefill(params32, {"tokens": toks}, max_len=S)[0]
                     for m in (model32, plain))
    serve["fp32_gate_max_abs_err"] = close_to_scale(got, want, PATH_TOL)
    serve["fp32_gate_scale"] = float(want.abs().max())
    return {"tokens": tokens, "launches": counts, "shapes": shapes,
            "serve": serve}


def tp_rest_rank(rank: int, world: int, checked: set,
                 store_root: str) -> dict:
    """Everything phase 19 runs on one rank of ``world``: 19a and 19b on
    every world, 19c and 19d on TP_REST's full world.  The ranks share
    the host's cores: each takes its share for torch's CPU threads, so
    that the CPU runs and the ranks' host loops do not oversubscribe
    them."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    out = {"smoke": {arch: tp_smoke_rank(world, arch, knobs, checked)
                     for arch, knobs in TP_REST["smoke"]},
           "sched": {}}
    for i, (arch, knobs) in enumerate(TP_REST["sched"]):
        out["sched"][sched_name(arch, knobs)] = tp_sched_smoke_rank(
            world, arch, knobs, checked, f"{store_root}/sched{i}")
    if world != TP_REST["full_world"]:
        return out
    out["router"] = tp_sched_smoke_rank(
        world, *TP_REST["sched"][0], checked, f"{store_root}/router",
        replicas=TP_REST["replicas"])
    out["full"] = tp_sched_full_rank(world, checked, f"{store_root}/full")
    free_device()
    out["recurrent"] = {}
    for arch, knobs in TP_REST["recurrent"]:
        out["recurrent"][arch] = tp_recurrent_rank(world, arch, knobs,
                                                   checked)
        free_device()
    return out


def sched_name(arch: str, knobs: dict) -> str:
    return arch + ("" if arch != "llama3-8b" else
                   " fused" if knobs.get("fused_mlp") else " unfused")


def tp_rest(checked: set, store_root: pathlib.Path,
            recurrent: dict) -> dict:
    """Phase 19: for each world of TP_REST, its ranks spawned over gloo on
    the one card.  19a: the recurrent, hybrid, encdec and vlm smoke
    configs card == CPU == one rank with exact all_reduces; 19b: phase
    10's trace behind the scheduler on llama3-8b (fused MLP on and off)
    and deepseek-moe-16b smoke, card == CPU == one rank's scheduler ==
    the static oracle with 0 solver calls after rank 0's prewarm, and a
    router of 2 replicas at TP 2 == the one-rank router; on TP 2 also
    19c, phase 11's deployment at TP_REST's depth (every rank the same
    streams, the fp32 gate), and 19d, rwkv6-7b and zamba2-2.7b at full
    width (every rank the same tokens, the fp32 gates), reported beside
    phases 8 and 9's (``recurrent``) TP 1 numbers."""
    from repro_torch.launch.mesh import run_ranks
    oracle = {arch: smoke_oracle(arch, knobs)
              for arch, knobs in TP_REST["smoke"]}
    sched_oracle = {sched_name(arch, knobs): sched_smoke_oracle(arch, knobs)
                    for arch, knobs in TP_REST["sched"]}
    router_oracle = sched_smoke_oracle(*TP_REST["sched"][0],
                                       replicas=TP_REST["replicas"])
    free_device()
    report, runs, shapes = {}, {}, {}
    for world in TP_REST["worlds"]:
        t0 = time.perf_counter()
        ranks = run_ranks(tp_rest_rank, world, world, checked,
                          str(store_root / f"tp{world}"), timeout_s=600)
        seconds = time.perf_counter() - t0
        for r, got in enumerate(ranks):
            for arch, want in oracle.items():
                run = got["smoke"][arch]
                if not (np.array_equal(run["card"], want)
                        and np.array_equal(run["cpu"], want)):
                    raise AssertionError(
                        f"{arch} smoke on rank {r} of {world}: card "
                        f"{run['card'].tolist()}, cpu {run['cpu'].tolist()},"
                        f" one rank {want.tolist()}")
            for name, want in sched_oracle.items():
                run = got["sched"][name]
                if run["card"] != want or run["cpu"] != want:
                    raise AssertionError(
                        f"{name} scheduler smoke on rank {r} of {world}: "
                        f"card {run['card']}, cpu {run['cpu']}, one rank "
                        f"{want}")
            if "router" in got and (got["router"]["card"] != router_oracle
                                    or got["router"]["cpu"]
                                    != router_oracle):
                raise AssertionError(f"router on rank {r} of {world}: "
                                     f"{got['router']} != one rank's "
                                     f"{router_oracle}")
            if "full" in got and (
                    got["full"]["streams"] != ranks[0]["full"]["streams"]
                    or any(not np.array_equal(
                        got["recurrent"][a]["tokens"],
                        ranks[0]["recurrent"][a]["tokens"])
                        for a in got["recurrent"])):
                raise AssertionError(f"rank {r} of {world} served other "
                                     f"streams or tokens than rank 0")
        first = ranks[0]
        for arch in oracle:
            key = f"TP{world} {arch} smoke (rank 0)"
            runs[key] = first["smoke"][arch]["launches"]
            shapes[key] = first["smoke"][arch]["shapes"]
        for name in sched_oracle:
            key = f"TP{world} scheduler {name} smoke (rank 0)"
            runs[key] = first["sched"][name]["launches"]
            shapes[key] = first["sched"][name]["shapes"]
        print(f"  TP {world} ({seconds:.1f} s): smoke tokens card == cpu == "
              f"one rank ({', '.join(oracle)}); all_reduces a generate "
              f"{ {a: first['smoke'][a]['all_reduces'] for a in oracle} }; "
              f"replicated { {a: first['smoke'][a]['replicated'] for a in oracle} }, "
              f"relaid { {a: first['smoke'][a]['relaid'] for a in oracle} }")
        print(f"  TP {world}: scheduler smoke streams card == cpu == one "
              f"rank's scheduler == static oracle ({', '.join(sched_oracle)});"
              f" launches { {n: first['sched'][n]['launches'] for n in sched_oracle} }; "
              f"ticks and broadcasts "
              f"{ {n: (first['sched'][n]['ticks'], first['sched'][n]['broadcasts']) for n in sched_oracle} }")
        report[world] = {"seconds": seconds}
        if "full" not in first:
            continue
        print(f"  TP {world}: router of {TP_REST['replicas']} replicas "
              f"== one-rank router; requests by replica "
              f"{first['router']['per_replica']}")
        runs[f"TP{world} router llama3-8b smoke (rank 0)"] = \
            first["router"]["launches"]
        shapes[f"TP{world} router llama3-8b smoke (rank 0)"] = \
            first["router"]["shapes"]
        full = first["full"]
        serve = dict(full["serve"],
                     fp32_logits_max_err_by_rank=[
                         g["full"]["serve"]["fp32_logits_max_err"]
                         for g in ranks],
                     peak_memory_gib_by_rank=[
                         g["full"]["serve"]["peak_memory_gib"]
                         for g in ranks],
                     host_seconds_inside_by_rank=[
                         g["full"]["serve"]["host_seconds_inside"]
                         for g in ranks])
        report[world]["scheduler"] = serve
        key = f"TP{world} scheduler llama3-8b full width (rank 0)"
        runs[key], shapes[key] = full["launches"], full["shapes"]
        summ = serve["metrics"]
        print(f"  TP {world}: phase 11's deployment at "
              f"{TP_REST['deploy_layers']} layers, streams equal on every "
              f"rank; forward passes "
              f"{serve['forward_passes']}, launches {full['launches']}; "
              f"solver calls {serve['solver_calls']}, store misses "
              f"{serve['store_misses']}; prewarm {serve['prewarm']}")
        print(f"  TP {world}: tokens/s {summ['tokens_per_s']}, ttft "
              f"p50/p95 {summ['ttft_p50_s']}/{summ['ttft_p95_s']} s, tpot "
              f"p50 {summ['tpot_p50_s']} s, ticks {serve['ticks']}, "
              f"broadcasts a tick {serve['broadcasts_per_tick']}, "
              f"all_reduces a pass {serve['all_reduces_per_pass']}; "
              f"replay {serve['replay_wall_seconds']} s wall; host seconds "
              f"inside by rank {serve['host_seconds_inside_by_rank']}; "
              f"weights {serve['weights_gib']} GiB, peak memory by rank "
              f"{serve['peak_memory_gib_by_rank']} GiB")
        print(f"  TP {world}: fp32 gate at "
              f"{TP_REST['gate_layers']['llama3-8b']} layers, every emitted "
              f"token vs one rank's teacher-forced prefill, max abs err by "
              f"rank {serve['fp32_logits_max_err_by_rank']} (tol {PATH_TOL} "
              f"x scale)")
        report[world]["recurrent"] = {}
        for arch, run in first["recurrent"].items():
            rs = dict(run["serve"],
                      fp32_gate_max_abs_err_by_rank=[
                          g["recurrent"][arch]["serve"]
                          ["fp32_gate_max_abs_err"] for g in ranks],
                      peak_memory_gib_by_rank=[
                          g["recurrent"][arch]["serve"]["peak_memory_gib"]
                          for g in ranks])
            report[world]["recurrent"][arch] = rs
            key = f"TP{world} serve {arch} full width (rank 0)"
            runs[key], shapes[key] = run["launches"], run["shapes"]
            print(f"  TP {world}: {arch} at full width, tokens "
                  f"{run['tokens'].tolist()} on every rank; launches "
                  f"{run['launches']}; {rs['all_reduces_per_pass']} "
                  f"all_reduces a decode pass; {rs['tokens_per_s']} tokens/s"
                  f" (TP 1: {recurrent[arch]['serve']['tokens_per_s']}), "
                  f"{rs['all_reduce_seconds_in_generate']} of "
                  f"{rs['seconds']} s inside all_reduce (rank 0); weights "
                  f"{rs['made']} ; peak memory by rank "
                  f"{rs['peak_memory_gib_by_rank']} GiB; fp32 gate at "
                  f"{TP_REST['gate_layers'][arch]} layers, max abs err by "
                  f"rank {rs['fp32_gate_max_abs_err_by_rank']} (scale "
                  f"{rs['fp32_gate_scale']}, tol {PATH_TOL} x scale)")
    return {"serve": report, "launches": runs, "shapes": shapes}


# -------------------------------------------------------------- phase 20
def kernel_checks() -> dict:
    """Each kernel's phase-3 check by the name recording_shapes gives its
    launches: f(shape, dtype, gen) holds it against its plain version at
    that shape, untimed."""
    return {
        "goma_matmul": lambda sh, dt, gen: check_b1(sh, dt, gen,
                                                    timed=False),
        "goma_fused_matmul": lambda sh, dt, gen: check_b2(
            *sh, dt, gen, timed=False),
        "goma_combine": lambda sh, dt, gen: check_combine(sh, dt, gen,
                                                          timed=False),
        "wkv6_scan": lambda sh, dt, gen: check_wkv6(sh[:4], sh[4], dt, gen,
                                                    timed=False),
        "ssd_scan": lambda sh, dt, gen: check_ssd(sh[:5], sh[5], dt, gen,
                                                  timed=False)}


def hold_new_shapes(seen: dict, checked: set, gen) -> list:
    """Hold every kernel launch recorded in ``seen`` at a shape no earlier
    check held against its plain version there and then (untimed), and
    add it to ``checked``; returns the shapes held here."""
    held = []
    for key in sorted(seen):
        if key in checked:
            continue
        name, shape, dtype = key
        row = kernel_checks()[name](shape, getattr(torch, dtype), gen)
        held.append({"kernel": name, "shape": list(shape), "dtype": dtype,
                     "max_abs_err": row["max_abs_err"]})
        checked.add(key)
    return held


def clone_tree(tree: dict) -> dict:
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def smoke_batches(cfg, steps: int, device) -> list:
    """host_batch's stream for a smoke config, as the loop takes it, with
    the frontends' zero stub (launch.train's) for encdec and vlm."""
    from repro_torch.data import DataConfig, RankRows, global_arrays
    dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN["smoke_seq"],
                    global_batch=TRAIN["smoke_batch"], seed=SEED)
    stub = {}
    if cfg.family in ("encdec", "vlm"):
        key = "frames" if cfg.family == "encdec" else "patches"
        stub = {key: torch.zeros((TRAIN["smoke_batch"], cfg.frontend_len,
                                  cfg.d_model), device=device)}
    return [{**global_arrays(dc, i, RankRows(device)), **stub}
            for i in range(steps)]


def train_steps(model, params, batches) -> list:
    """The losses of jit_train_step over ``batches`` (params updated in
    place), at the CPU tests' lr 3e-3 with a warmup of 2."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import jit_train_step
    step = jit_train_step(model, opt.AdamWConfig(
        lr=3e-3, warmup_steps=2, total_steps=20))
    state = opt.init_state(params)
    losses = []
    for b in batches:
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    return losses


def grad_refusal(model, params, batch) -> str:
    """The error a loss under grad raises through the kernel path."""
    from repro_torch.kernels.goma_gemm import NoBackwardError
    from repro_torch.training import optimizer as opt
    live = opt.tree_map(lambda t: t.detach().requires_grad_(), params)
    try:
        model.loss(live, batch, remat=False)
    except NoBackwardError as e:
        return str(e)
    raise AssertionError(f"{model.cfg.name}: a loss under grad ran through "
                         f"the kernels without an error")


def train_smoke(checked: set, gen) -> dict:
    """20a: every smoke config of ARCHS, fp32, TRAIN's smoke steps of
    AdamW on the card against the same steps on the CPU (one set of fp32
    masters made on the CPU, host_batch's stream), losses within
    TRAIN_TOL of scale; then, with the fused MLP and the scan kernels on,
    the loss without grad on the card (B2, or B1 and goma_combine; B3,
    B4) against the plain loss within TRAIN_TOL, every launch held against
    its plain version at its shape, and under grad the kernel path raises
    on the card with the CPU's error."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_to
    rows, runs, shapes, held = {}, {}, {}, []
    for arch in sorted(ARCHS):
        cfg = get_config(arch, smoke=True)
        model = build_model(cfg)
        params = model.init_params(torch.Generator().manual_seed(SEED),
                                   "cpu", masters=True)
        card_params = tree_to(params, "cuda")
        steps = TRAIN["smoke_steps"]
        # the steps update copies in place
        cpu = train_steps(model, clone_tree(params),
                          smoke_batches(cfg, steps, "cpu"))
        card = train_steps(model, clone_tree(card_params),
                           smoke_batches(cfg, steps, "cuda"))
        scale = max(1.0, max(map(abs, cpu)))
        gap = max(abs(a - b) for a, b in zip(card, cpu))
        if not gap <= TRAIN_TOL * scale:
            raise AssertionError(f"{arch} smoke: card losses {card} != CPU "
                                 f"losses {cpu}")
        kcfg = dataclasses.replace(cfg, fused_mlp=True,
                                   use_pallas_scan=True)
        kmodel = build_model(kcfg)
        batch = smoke_batches(cfg, 1, "cuda")[0]
        reset_launches()
        seen = {}
        with torch.no_grad(), recording_shapes(seen):
            got = float(kmodel.loss(card_params, batch))
        launches = launch_counts()
        held += hold_new_shapes(seen, checked, gen)
        run = held_shapes(seen, launches, checked)
        with torch.no_grad():
            want = float(model.loss(card_params, batch))
        kernel_gap = abs(got - want)
        if not kernel_gap <= TRAIN_TOL * max(1.0, abs(want)):
            raise AssertionError(f"{arch} smoke: kernel-path loss {got} != "
                                 f"plain loss {want}")
        refusal = None
        if any(launches.values()):
            errors = [grad_refusal(kmodel, p, {k: v.to(dev) for k, v in
                                               batch.items()})
                      for dev, p in (("cuda", card_params), ("cpu", params))]
            if errors[0] != errors[1]:
                raise AssertionError(f"{arch}: the card refuses with "
                                     f"{errors[0]!r}, the CPU with "
                                     f"{errors[1]!r}")
            refusal = errors[0]
        elif cfg.family not in ("moe", "encdec"):
            raise AssertionError(f"{arch} smoke: the kernel path launched "
                                 f"no kernel")
        rows[arch] = {"card_losses": card, "cpu_losses": cpu,
                      "max_loss_gap": gap, "kernel_loss": got,
                      "plain_loss": want, "kernel_loss_gap": kernel_gap,
                      "launches": launches, "refusal": refusal}
        runs[f"train {arch} smoke, loss without grad"] = launches
        shapes[f"train {arch} smoke, loss without grad"] = run
        print(f"  {arch} smoke: card {card} vs cpu {cpu} (gap {gap:.3g}); "
              f"kernel loss {got} vs plain {want} (gap {kernel_gap:.3g}), "
              f"launches { {k: v for k, v in launches.items() if v} }")
    print(f"  held here at new shapes: {held}")
    print(f"  under grad the kernel path raises, card == CPU: "
          f"{sorted({r['refusal'] for r in rows.values() if r['refusal']})}")
    return {"rows": rows, "launches": runs, "shapes": shapes, "held": held}


def full_model(layers: int | None = None, **knobs):
    """stablelm-1.6b at its published widths (the first ``layers``
    layers when given), with the config ``knobs`` set: (cfg, model)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(TRAIN["arch"]), **knobs)
    if layers is not None:
        cfg = dataclasses.replace(cfg, layers=layers)
    return cfg, build_model(cfg)


def train_full_setup(layers: int | None = None, **knobs):
    """``full_model``, its fp32 masters made on the card from the seed,
    and AdamW's zero moments: (cfg, model, params, opt_state)."""
    from repro_torch.training import optimizer as opt
    cfg, model = full_model(layers, **knobs)
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), "cuda",
        masters=True)
    return cfg, model, params, opt.init_state(params)


def full_optimizer():
    from repro_torch.training import optimizer as opt
    return opt.AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                           total_steps=TRAIN["steps"])


def full_data(cfg):
    from repro_torch.data import DataConfig
    return DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                      global_batch=TRAIN["batch"], seed=SEED)


def train_full(checked: set, smi: str, out: pathlib.Path | None) -> dict:
    """20b: TRAIN's steps of stablelm-1.6b at full width through
    run_training (no checkpoint): every loss finite (the loop's NaN guard
    raises otherwise) and the last 5 losses' mean below the first 5's;
    reported: the median step time, tokens/s, peak memory, the straggler
    count, and one more step under the profiler (the device's idle
    share).  Then the loss without grad with the fused MLP on: B1 3 and
    goma_combine 1 a layer, each launch at a shape phase 3 held; its bf16
    gap to the plain loss reported, and the fp32 gate at TRAIN's
    gate_layers layers: the kernel path's loss and last hidden states
    within PATH_TOL of scale of the plain path's."""
    from repro_torch.data import RankRows, global_arrays
    from repro_torch.models import build_model
    from repro_torch.training import LoopConfig, run_training
    from repro_torch.training.train_step import jit_train_step
    free_device()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, params, state = train_full_setup()
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    made = {"parameters": n, "seconds": time.perf_counter() - t0,
            "gib_with_moments": torch.cuda.memory_allocated() / 2**30}
    print(f"  {cfg.name}: {n} parameters, fp32 masters and moments "
          f"{made['gib_with_moments']} GiB, made in {made['seconds']:.1f} s")
    step = jit_train_step(model, full_optimizer(), remat=True)
    data = full_data(cfg)
    params, state, loop = run_training(
        step, params, state, data, RankRows("cuda"),
        LoopConfig(total_steps=TRAIN["steps"], ckpt_every=10**9,
                   log_every=5), None, log=lambda s: print(f"  {s}"))
    losses = loop.losses
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"{cfg.name} did not descend: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(loop.step_seconds)
    tokens = TRAIN["batch"] * TRAIN["seq"]
    batch = global_arrays(data, TRAIN["steps"], RankRows("cuda"))
    prof = profile_run(lambda: step(params, state, batch), smi, out,
                       "profile_train", host_ops=False)
    report = {"device": smi, "made": made, "losses": losses,
              "step_seconds": loop.step_seconds, "median_step_s": med,
              "tokens_per_s": tokens / med, "peak_memory_gib": peak,
              "straggler_steps": loop.straggler_steps,
              "profiled_step": {k: prof[k] for k in (
                  "wall_ms", "device_busy_ms", "device_busy_share",
                  "device_idle_share", "device_kernel_launches")}}
    print(f"  {cfg.name} training on {smi}: median step {med} s, "
          f"{report['tokens_per_s']} tokens/s, peak {peak} GiB, "
          f"{loop.straggler_steps} straggler steps; losses {losses}")
    del state, step
    free_device()
    # the loss without grad through B1 and goma_combine, bf16
    kmodel = build_model(dataclasses.replace(cfg, fused_mlp=True))
    reset_launches()
    seen = {}
    with torch.no_grad():
        with recording_shapes(seen):
            got = float(kmodel.loss(params, batch))
        launches = launch_counts()
        want = float(model.loss(params, batch))
    run = held_shapes(seen, launches, checked)
    expect = {"goma_matmul": 3 * cfg.layers, "goma_fused_matmul": 0,
              "goma_combine": cfg.layers, "wkv6_scan": 0, "ssd_scan": 0}
    if launches != expect:
        raise AssertionError(f"the loss launched {launches}, not {expect}")
    report["kernel_loss"] = {"launches": launches, "bf16_kernel_loss": got,
                             "bf16_plain_loss": want,
                             "bf16_gap": abs(got - want)}
    # the fp32 gate at the first layers
    gate = dict(params, layers=first_layers(params["layers"],
                                            TRAIN["gate_layers"]))
    g32 = dict(compute_dtype="float32", layers=TRAIN["gate_layers"])

    def gate_run(fused):
        m = build_model(dataclasses.replace(cfg, fused_mlp=fused, **g32))
        with torch.no_grad():
            x = m._embed_in(gate, batch["tokens"])
            x, _ = m._forward_stack(gate, x, torch.arange(
                x.shape[1], device="cuda"))
            return m.loss(gate, batch), x
    (kl, kx), (pl, px) = gate_run(True), gate_run(False)
    report["kernel_loss"].update(
        fp32_gate_layers=TRAIN["gate_layers"],
        fp32_loss_err=close_to_scale(kl, pl, PATH_TOL),
        fp32_hidden_err=close_to_scale(kx, px, PATH_TOL),
        fp32_hidden_scale=float(px.abs().max()))
    print(f"  loss without grad, fused MLP: launches {launches}, bf16 "
          f"kernel {got} vs plain {want}; fp32 gate at "
          f"{TRAIN['gate_layers']} layers: loss err "
          f"{report['kernel_loss']['fp32_loss_err']}, hidden err "
          f"{report['kernel_loss']['fp32_hidden_err']} (scale "
          f"{report['kernel_loss']['fp32_hidden_scale']})")
    del params, gate, kx, px
    free_device()
    return {"serve": report, "launches": launches, "shapes": run}


def resume_run(arch: str, layers: int | None, root: pathlib.Path) -> dict:
    """20c: TRAIN's resume steps straight against half of them, a save, a
    restore in a fresh manager and the other half, through the donated
    step, bitwise (losses and every leaf), under deterministic
    algorithms.  The checkpoint's bytes and the save and restore
    seconds are reported."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, RankRows, global_arrays
    from repro_torch.models import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import jit_train_step
    n, half = TRAIN["resume_steps"], TRAIN["resume_steps"] // 2
    if arch == TRAIN["arch"]:
        cfg, model = full_model(layers)
        ocfg, data = full_optimizer(), full_data(cfg)
    else:
        cfg = get_config(arch, smoke=True)
        model = build_model(cfg)
        ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=20)
        data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN["smoke_seq"],
                          global_batch=TRAIN["smoke_batch"], seed=SEED)

    def fresh():
        p = model.init_params(torch.Generator(device="cuda").manual_seed(
            SEED), "cuda", masters=True)
        return p, opt.init_state(p)

    def run(params, state, start, stop):
        step = jit_train_step(model, ocfg, remat=True)
        losses = []
        for i in range(start, stop):
            params, state, m = step(params, state, global_arrays(
                data, i, RankRows("cuda")))
            losses.append(float(m["loss"]))
        return params, state, losses

    p_ref, _, l_ref = run(*fresh(), 0, n)
    ref = [t.clone() for t in opt.tree_leaves(p_ref)]
    del p_ref
    free_device()
    p, s, l_a = run(*fresh(), 0, half)
    d = root / cfg.name
    t0 = time.perf_counter()
    mgr = CheckpointManager(d, async_save=True)
    mgr.save(half, (p, s))
    mgr.wait()
    save_s = time.perf_counter() - t0
    like = (p, s)
    t0 = time.perf_counter()
    (p, s), step0 = CheckpointManager(d).restore(like)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del like
    p, s, l_b = run(p, s, step0, n)
    equal = l_a + l_b == l_ref and all(
        torch.equal(a, b) for a, b in zip(opt.tree_leaves(p), ref))
    nbytes = sum(f.stat().st_size for f in d.rglob("*") if f.is_file())
    row = {"steps": n, "layers": cfg.layers, "losses": l_ref,
           "resumed_losses": l_a + l_b, "bitwise_equal": equal,
           "checkpoint_bytes": nbytes, "save_s": save_s,
           "restore_s": restore_s}
    print(f"  {cfg.name} ({cfg.layers} layers): {n} steps straight == "
          f"{half} + save + restore + {n - half}: {equal}; checkpoint "
          f"{nbytes} bytes, save {save_s:.2f} s, restore {restore_s:.2f} s")
    if not equal:
        raise AssertionError(f"{cfg.name}: the resumed run differs: "
                             f"{l_a + l_b} vs {l_ref}")
    del p, s, ref
    free_device()
    return row


def train_resume(root: pathlib.Path) -> dict:
    """20c on the llama3-8b smoke config and stablelm-1.6b at TRAIN's
    resume layers, the checkpoints in ``root``."""
    torch.use_deterministic_algorithms(True)
    try:
        return {"llama3-8b smoke": resume_run("llama3-8b", None, root),
                f"{TRAIN['arch']} {TRAIN['resume_layers']} layers":
                    resume_run(TRAIN["arch"], TRAIN["resume_layers"], root)}
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)


def fingerprint(params) -> list[int]:
    """An int64 fingerprint of every leaf's bits (a position-weighted sum
    of the fp32 bit patterns, wrapping): equal bits give equal
    fingerprints, computed on the card."""
    from repro_torch.training import optimizer as opt
    out = []
    for t in opt.tree_leaves(params):
        acc = 0
        bits = t.detach().reshape(-1).view(torch.int32)
        for i, chunk in enumerate(bits.split(1 << 24)):
            w = torch.arange(chunk.numel(), device=chunk.device) % 65521 + i
            acc += int((chunk.to(torch.int64) * (w + 1)).sum())
        out.append(acc)
    return out


def train_dp_rank(rank: int, world: int, mode: str) -> dict:
    """20d, one rank: stablelm-1.6b at TRAIN's dp layers in fp32 (the same
    masters from the seed on every rank), TRAIN's dp steps of jit_train_step over
    the default group, on this rank's rows of the global batch: every
    step's (mean) loss, seconds, all_reduce calls, bytes and seconds, and
    the parameters' fingerprint."""
    from repro_torch.data import RankRows, global_arrays
    from repro_torch.training.train_step import jit_train_step
    cfg, model, params, state = train_full_setup(
        TRAIN["dp_layers"], compute_dtype=TRAIN["dp_dtype"])
    step = jit_train_step(model, full_optimizer(), remat=True,
                          compress=mode == "compressed")
    data = full_data(cfg)
    rows = []
    for i in range(TRAIN["dp_steps"]):
        batch = global_arrays(data, i, RankRows("cuda", rank, world))
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        loss = float(m["loss"])
        rows.append({"loss": loss, "step_s": time.perf_counter() - t0,
                     "comm": dict(step.comm),
                     "fingerprint": fingerprint(params)})
    return {"rows": rows, "peak_memory_gib":
            torch.cuda.max_memory_allocated() / 2**30}


def training_phase(checked: set, gen, smi: str, out: pathlib.Path | None,
                   ckpt_root: pathlib.Path) -> dict:
    """Phase 20: 20a-20d, each part's seconds printed."""
    report, runs, shapes = {}, {}, {}
    t0 = time.perf_counter()
    smoke = train_smoke(checked, gen)
    runs.update(smoke["launches"])
    shapes.update(smoke["shapes"])
    report["smoke"] = {"rows": smoke["rows"], "held": smoke["held"],
                       "seconds": time.perf_counter() - t0}
    print(f"  20a: {report['smoke']['seconds']:.1f} s")
    t0 = time.perf_counter()
    full = train_full(checked, smi, out)
    name = f"train {TRAIN['arch']} full width, loss without grad"
    runs[name], shapes[name] = full["launches"], full["shapes"]
    report["full"] = dict(full["serve"], seconds=time.perf_counter() - t0)
    print(f"  20b: {report['full']['seconds']:.1f} s")
    t0 = time.perf_counter()
    report["resume"] = dict(train_resume(ckpt_root),
                            seconds=time.perf_counter() - t0)
    print(f"  20c: {report['resume']['seconds']:.1f} s")
    t0 = time.perf_counter()
    report["data_parallel"] = dict(train_dp(),
                                   seconds=time.perf_counter() - t0)
    print(f"  20d: {report['data_parallel']['seconds']:.1f} s")
    return {"report": report, "launches": runs, "shapes": shapes}


def train_dp() -> dict:
    """20d: TRAIN's dp ranks over gloo on the one card, by the exact mean
    and by the int8 error-feedback all-reduce: every rank's parameters
    bitwise equal after every step (their fingerprints), the exact mean's
    losses within TRAIN_TOL of scale of one rank's on the whole global
    batch, the compressed mode's loss gap reported; bytes a step and the
    host seconds inside all_reduce (gloo stages CUDA tensors through the
    host: not NVLink numbers)."""
    from repro_torch.data import RankRows, global_arrays
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.training.train_step import jit_train_step
    free_device()
    cfg, model, params, state = train_full_setup(
        TRAIN["dp_layers"], compute_dtype=TRAIN["dp_dtype"])
    step = jit_train_step(model, full_optimizer(), remat=True)
    one = []
    for i in range(TRAIN["dp_steps"]):
        params, state, m = step(params, state, global_arrays(
            full_data(cfg), i, RankRows("cuda")))
        one.append(float(m["loss"]))
    n = sum(t.numel() for t in leaves(params))
    del params, state, step
    free_device()
    world = TRAIN["dp_world"]
    report = {"one_rank_losses": one, "parameters": n, "world": world}
    for mode in ("exact", "compressed"):
        t0 = time.perf_counter()
        ranks = run_ranks(train_dp_rank, world, world, mode, timeout_s=600)
        seconds = time.perf_counter() - t0
        for r, got in enumerate(ranks):
            for i, (a, b) in enumerate(zip(got["rows"], ranks[0]["rows"])):
                if a["fingerprint"] != b["fingerprint"] or \
                        a["loss"] != b["loss"]:
                    raise AssertionError(f"{mode}: rank {r} holds other "
                                         f"parameters than rank 0 after "
                                         f"step {i}")
        losses = [row["loss"] for row in ranks[0]["rows"]]
        gap = max(abs(a - b) for a, b in zip(losses, one))
        if mode == "exact" and not gap <= TRAIN_TOL * max(
                1.0, max(map(abs, one))):
            raise AssertionError(f"exact mean: losses {losses} vs one "
                                 f"rank's {one}")
        report[mode] = {
            "losses": losses, "loss_gap_to_one_rank": gap,
            "seconds_phase": seconds,
            "step_seconds": [row["step_s"] for row in ranks[0]["rows"]],
            "all_reduce_calls": ranks[0]["rows"][-1]["comm"]["calls"],
            "all_reduce_bytes_a_step": ranks[0]["rows"][-1]["comm"]["bytes"],
            "all_reduce_seconds_by_rank": [
                [row["comm"]["seconds"] for row in g["rows"]]
                for g in ranks],
            "peak_memory_gib_by_rank": [g["peak_memory_gib"]
                                        for g in ranks]}
        print(f"  DP {world} ({mode}): losses {losses} (one rank {one}, "
              f"gap {gap:.3g}); ranks bitwise equal after every step; "
              f"{report[mode]['all_reduce_calls']} all_reduces, "
              f"{report[mode]['all_reduce_bytes_a_step']} bytes a step; "
              f"seconds a step {report[mode]['step_seconds']}, inside "
              f"all_reduce by rank "
              f"{report[mode]['all_reduce_seconds_by_rank']}; peak "
              f"{report[mode]['peak_memory_gib_by_rank']} GiB; "
              f"{seconds:.1f} s")
    return report


# ------------------------------------------------------------- phase 21
def mesh_of(shape: tuple, rank: int):
    """A (data, model) mesh description at ``rank``'s coordinates (no
    process group): the layouts a rank of that mesh computes."""
    from repro_torch.launch.mesh import HostMesh
    data, model = shape
    return HostMesh(shape={"data": data, "model": model},
                    axis_names=("data", "model"), rank=rank,
                    coords={"data": rank // model, "model": rank % model})


def smoke_rows(cfg, i: int, mesh=None) -> dict:
    """The smoke steps' batch ``i`` on the card: the whole global batch
    without ``mesh``, else this rank's rows of it on ``mesh``."""
    from repro_torch.data import DataConfig, RankRows, global_arrays
    rows = (RankRows("cuda") if mesh is None else
            RankRows("cuda", mesh.coords["data"], mesh.shape["data"]))
    dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN["smoke_seq"],
                    global_batch=TRAIN["smoke_batch"], seed=SEED)
    batch = global_arrays(dc, i, rows)
    if cfg.family in ("encdec", "vlm"):
        key = "frames" if cfg.family == "encdec" else "patches"
        batch[key] = torch.zeros((batch["tokens"].shape[0],
                                  cfg.frontend_len, cfg.d_model),
                                 device="cuda")
    return batch


def sharded_first_grads(model, params, cfg, mesh=None) -> dict:
    """path -> the gradient of the first smoke batch as the update takes
    it, on the host: one rank's on the whole batch without ``mesh``,
    else this rank's of its rows, reduced over the mesh
    (``ShardedLayout.reduce_grads``, after the FSDP gather's
    reduce-scatter in the backward)."""
    from repro_torch.dist.fsdp import ShardedLayout
    from repro_torch.sharding.rules import flatten_with_paths
    from repro_torch.training.train_step import _grads_of
    _, grads = _grads_of(model, params, smoke_rows(cfg, 0, mesh),
                         microbatches=1, remat=True)
    if mesh is not None:
        grads = ShardedLayout(model).reduce_grads(grads)
    return {p: g.cpu() for p, g in flatten_with_paths(grads)}


def sharded_smoke_steps(model, params, cfg, mesh=None) -> tuple:
    """TRAIN's smoke steps of jit_train_step on the card at the CPU
    tests' lr (one rank on the whole batch without ``mesh``, else this
    rank's rows of it on ``mesh``): (losses, params, the step)."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import jit_train_step
    step = jit_train_step(model, opt.AdamWConfig(
        lr=3e-3, warmup_steps=2, total_steps=20), mesh=mesh)
    state = opt.init_state(params)
    losses = []
    for i in range(TRAIN["smoke_steps"]):
        params, state, m = step(params, state, smoke_rows(cfg, i, mesh))
        losses.append(float(m["loss"]))
    return losses, params, step


def sharded_cfg(name: str):
    """A SHARDED smoke config by name: an arch's smoke config, or one of
    SHARDED's widened ones."""
    from repro_torch.configs import get_config
    arch, over = SHARDED["widened"].get(name, (name, {}))
    return dataclasses.replace(get_config(arch, smoke=True), **over)


def smoke_masters(name: str):
    """A SHARDED smoke config's model and fp32 masters, made on the CPU
    from the seed and moved to the card (every rank and one rank
    alike)."""
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_to
    model = build_model(sharded_cfg(name))
    return model, tree_to(model.init_params(
        torch.Generator().manual_seed(SEED), "cpu", masters=True), "cuda")


def sharded_smoke_rank(shape: tuple, mode: str, checked: set,
                       root: str) -> dict:
    """21a on one rank of ``shape`` (a mesh of the whole world): every
    SHARDED smoke config's reduced gradients of the first batch, then its
    steps (losses, this rank's slices and the gathered parameters, on the
    host); at SHARDED's mesh also the
    kernels' loss without grad against the plain loss (every launch at a
    shape held against its plain version, here or in phase 3), the grad
    refusal, shard_engine(mode="fsdp")'s greedy tokens, and a checkpoint
    of the saved configs into ``root``."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dist.fsdp import ShardedLayout
    from repro_torch.dist.serve import shard_engine, shard_model
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_to
    from repro_torch.serving import Engine
    from repro_torch.sharding.rules import flatten_with_paths
    from repro_torch.training import optimizer as opt
    mesh = make_host_mesh(data=shape[0], model=shape[1])
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for arch, knobs in SHARDED["smoke"]:
        base, params = smoke_masters(arch)
        model = shard_model(base, mesh, mode=mode)
        params = ShardedLayout(model).shard(params)
        grads = sharded_first_grads(model, params, base.cfg, mesh)
        losses, params, step = sharded_smoke_steps(model, params, base.cfg,
                                                   mesh)
        layout = step.layout
        run = {"grads": grads, "losses": losses, "comm": step.comm,
               "local": tree_to(dict(flatten_with_paths(params)), "cpu"),
               "whole": {p: layout.whole(p, t).cpu()
                         for p, t in flatten_with_paths(params)}}
        if shape == SHARDED["mesh"]:
            kcfg = dataclasses.replace(base.cfg, **knobs)
            kmodel = shard_model(build_model(kcfg), mesh, mode=mode)
            batch = smoke_batches(base.cfg, 1, "cuda")[0]
            rows = TRAIN["smoke_batch"] // mesh.shape["data"]
            lo = mesh.coords["data"] * rows
            batch = {k: v[lo:lo + rows] for k, v in batch.items()}
            reset_launches()
            seen = {}
            with torch.no_grad():
                with recording_shapes(seen):
                    got = float(kmodel.loss(params, batch))
                launches = launch_counts()
                want = float(model.loss(params, batch))
            held = hold_new_shapes(seen, checked, gen)
            run.update(kernel_loss=got, plain_loss=want, launches=launches,
                       shapes=held_shapes(seen, launches, checked),
                       held=held)
            if any(launches.values()):
                run["refusal"] = grad_refusal(kmodel, params, batch)
            if arch in SHARDED["serve"]:
                smodel, sparams, prompts, extra, scfg = tp_smoke_setup(
                    arch, knobs)
                eng = Engine(smodel, tree_to(sparams, "cuda"), scfg)
                shard_engine(eng, model_axis=shape[1], data_axis=shape[0],
                             mode="fsdp")
                run["tokens"] = eng.generate(prompts, extra_batch=extra)
            if arch in SHARDED["saved"]:
                CheckpointManager(f"{root}/{arch}", async_save=False,
                                  layout=layout).save(
                    TRAIN["smoke_steps"],
                    (params, opt.init_state(params)))
        out[arch] = run
        free_device()
    if shape == SHARDED["mesh"]:
        out["restored"] = {}
        for rshape in SHARDED["restore"]:
            rmesh = make_host_mesh(data=rshape[0], model=rshape[1])
            for arch in SHARDED["saved"]:
                base, like = smoke_masters(arch)
                rmodel = shard_model(base, rmesh, mode="fsdp")
                rlayout = ShardedLayout(rmodel)
                like = rlayout.shard(like)
                (got, _), step0 = CheckpointManager(
                    f"{root}/{arch}", layout=rlayout).restore(
                    (like, opt.init_state(like)))
                out["restored"][rshape, arch] = {
                    "step": step0, "whole": {
                        p: rlayout.whole(p, t).cpu()
                        for p, t in flatten_with_paths(got)}}
    return out


def sharded_full_rank(rank: int) -> dict:
    """21b on one rank of SHARDED's (2, 2) mesh: stablelm-1.6b at TRAIN's
    dp layers in fp32, FSDP + TP, TRAIN's dp steps of the global batch
    (each step's loss, seconds and collectives by kind), the peak
    memory; then the loss without grad through the fused MLP (B1 and
    goma_combine at this rank's MLP) and the plain loss, fp32."""
    from repro_torch.data import RankRows, global_arrays
    from repro_torch.dist.serve import shard_model
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training.train_step import jit_train_step
    free_device()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_host_mesh(data=SHARDED["mesh"][0], model=SHARDED["mesh"][1])
    cfg, base = full_model(TRAIN["dp_layers"],
                           compute_dtype=TRAIN["dp_dtype"])
    model = shard_model(base, mesh, mode="fsdp")
    t0 = time.perf_counter()
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), "cuda",
        masters=True)
    from repro_torch.training import optimizer as opt
    state = opt.init_state(params)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    step = jit_train_step(model, full_optimizer(), mesh=mesh, remat=True)
    data = full_data(cfg)
    rows = RankRows("cuda", mesh.coords["data"], mesh.shape["data"])
    steps = []
    for i in range(TRAIN["dp_steps"]):
        batch = global_arrays(data, i, rows)
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        loss = float(m["loss"])
        steps.append({"loss": loss, "step_s": time.perf_counter() - t0,
                      "comm": step.comm})
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_local = sum(t.numel() for t in leaves(params))
    del state
    free_device()
    kmodel = shard_model(dataclasses.replace(base, cfg=dataclasses.replace(
        cfg, fused_mlp=True)), mesh, mode="fsdp")
    batch = global_arrays(data, 0, rows)
    reset_launches()
    seen = {}
    with torch.no_grad():
        with recording_shapes(seen):
            got = float(kmodel.loss(params, batch))
        launches = launch_counts()
        want = float(model.loss(params, batch))
    return {"steps": steps, "peak_memory_gib": peak, "made_s": made,
            "local_parameters": n_local, "coords": dict(mesh.coords),
            "kernel_loss": got, "plain_loss": want, "launches": launches,
            "seen": seen}


def reshard_full_rank(rank: int, root: str) -> dict:
    """21c on one rank: stablelm-1.6b's fp32 parameters at SHARDED's
    reshard layers, made on (2, 2), saved there (one checkpoint of whole
    leaves, rank 0 writing), restored onto (4, 1); whether this rank's
    restored slices are bitwise its (4, 1) block of the parameters drawn
    again whole from the seed, and the seconds of the save and the
    restore."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dist.fsdp import ShardedLayout
    from repro_torch.dist.serve import shard_model
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.rules import flatten_with_paths
    free_device()
    _, base = full_model(SHARDED["reshard_layers"])
    mesh = make_host_mesh(data=SHARDED["mesh"][0], model=SHARDED["mesh"][1])
    model = shard_model(base, mesh, mode="fsdp")
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), "cuda",
        masters=True)
    layout = ShardedLayout(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr = CheckpointManager(root, async_save=True, layout=layout)
    mgr.save(1, params)
    mgr.wait()
    save_s = time.perf_counter() - t0
    del params
    free_device()
    rmesh = make_host_mesh(data=4, model=1)
    rmodel = shard_model(base, rmesh, mode="fsdp")
    rlayout = ShardedLayout(rmodel)
    like = rmodel.init_params(torch.Generator(), "meta", masters=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, step0 = CheckpointManager(root, layout=rlayout).restore(
        like, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    whole = dict(flatten_with_paths(base.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), "cuda",
        masters=True)))
    equal = all(torch.equal(t, rlayout.place(p, whole[p]))
                for p, t in flatten_with_paths(got))
    return {"save_s": save_s, "restore_s": restore_s, "step": step0,
            "equal": equal}


def sharded_rank(rank: int, checked: set, root: str) -> dict:
    """Everything phase 21 runs on one rank of the world of 4."""
    out = {"smoke": {}}
    t0 = time.perf_counter()
    for shape, mode in SHARDED["meshes"]:
        out["smoke"][shape] = sharded_smoke_rank(shape, mode, checked,
                                                 f"{root}/smoke")
    out["smoke_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["full"] = sharded_full_rank(rank)
    out["full_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["reshard"] = reshard_full_rank(rank, f"{root}/full")
    out["reshard_s"] = time.perf_counter() - t0
    return out


def sharded_pair_rank(rank: int, checked: set, root: str) -> dict:
    """21a's (1, 2) mesh, on one rank of a world of 2."""
    shape, mode = SHARDED["pair"]
    return sharded_smoke_rank(shape, mode, checked, root)


def rank_places(shape: tuple, cfg) -> list:
    """Each rank of ``shape``'s placement of a whole leaf: (path, whole)
    -> the rank's slice under its TP and FSDP layouts."""
    from repro_torch.dist.fsdp import FullyShardedData
    from repro_torch.models import build_model
    from repro_torch.models.parallel import TensorParallel
    places = []
    for r in range(math.prod(shape)):
        m = build_model(cfg)
        lay = dataclasses.replace(m, tp=TensorParallel(m, mesh_of(shape, r)))
        lay.fsdp = FullyShardedData(lay)
        places.append(lambda path, t, lay=lay:
                      lay.fsdp.place(path, lay.tp.place(path, t)))
    return places


def grad_gap(ranks: list, want: dict, places: list) -> float:
    """The largest gap of a rank's reduced gradients from its slices of
    one rank's (``want``), each leaf's over max(1, max|g|) of its whole
    gradient."""
    return max(float((got["grads"][path] - place(path, g)).abs().max())
               / max(1.0, float(g.abs().max()))
               for got, place in zip(ranks, places)
               for path, g in want.items())


def same_slices(ranks: list, places: list) -> int:
    """Raise unless ranks whose layouts place the same block of a leaf
    (an index probe placed by each rank's layout) hold it bitwise
    equal; the pairs compared."""
    pairs = 0
    for path, whole in ranks[0]["whole"].items():
        probe = torch.arange(whole.numel(), dtype=torch.float64).reshape(
            whole.shape)
        blocks = [place(path, probe) for place in places]
        for r in range(1, len(ranks)):
            for q in range(r):
                if blocks[r].shape == blocks[q].shape and \
                        torch.equal(blocks[r], blocks[q]):
                    pairs += 1
                    if not torch.equal(ranks[r]["local"][path],
                                       ranks[q]["local"][path]):
                        raise AssertionError(
                            f"ranks {q} and {r} hold the same block of "
                            f"{path} with other bits")
    return pairs


def sharded_training(checked: set, smi: str, store_root: pathlib.Path,
                     one_rank_losses: list) -> dict:
    """Phase 21: 21a-21c (SHARDED), the ranks over gloo on the one card,
    each part's seconds printed; ``one_rank_losses``: 20d's losses of one
    rank on the whole batch (the same seed, layers and steps)."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.model import tree_to
    from repro_torch.sharding.rules import flatten_with_paths
    report, runs, shapes = {"device": smi}, {}, {}
    t0 = time.perf_counter()
    # one rank on the card: each smoke config's first gradients and steps,
    # and the serving oracle on the CPU
    one = {}
    for arch, knobs in SHARDED["smoke"]:
        model, params = smoke_masters(arch)
        grads = sharded_first_grads(model, params, model.cfg)
        losses, params, _ = sharded_smoke_steps(model, params, model.cfg)
        one[arch] = (losses, tree_to(dict(flatten_with_paths(params)),
                                     "cpu"), grads)
    oracle = {arch: smoke_oracle(arch, knobs) for arch, knobs
              in SHARDED["smoke"] if arch in SHARDED["serve"]}
    free_device()
    t1 = time.perf_counter()
    # the world of 2 runs beside the world of 4 (its smoke configs take
    # little of the card; each spawn costs seconds)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = pool.submit(run_ranks, sharded_pair_rank, 2, checked,
                              str(store_root / "pair"), timeout_s=600)
        world = run_ranks(sharded_rank, 4, checked,
                          str(store_root / "world"), timeout_s=900)
        pair = pending.result()
    report["seconds_parts"] = {
        "one_rank_references": t1 - t0,
        "worlds_of_2_and_4": time.perf_counter() - t1,
        "21a_in_world_of_4": world[0]["smoke_s"],
        "21b": world[0]["full_s"], "21c": world[0]["reshard_s"]}
    print(f"  phase 21's parts, s: {report['seconds_parts']}")
    smoke = {SHARDED["pair"][0]: pair}
    smoke.update({shape: [r["smoke"][shape] for r in world]
                  for shape, _ in SHARDED["meshes"]})
    rows, faults = {}, []
    for shape, ranks in smoke.items():
        for arch, knobs in SHARDED["smoke"]:
            losses, params, grads = one[arch]
            got = [r[arch] for r in ranks]
            places = rank_places(shape, sharded_cfg(arch))
            g_gap = grad_gap(got, grads, places)
            if not g_gap <= SHARDED_TOL:
                faults.append(f"{arch} on {shape}: reduced gradients "
                              f"{g_gap} of max(1, max|g|) from one rank's "
                              f"slices")
            scale = max(1.0, max(map(abs, losses)))
            loss_gap = max(abs(a - b) for g in got
                           for a, b in zip(g["losses"], losses))
            param_gap = max(
                float(torch.linalg.vector_norm(g["whole"][p] - w))
                / max(1.0, float(torch.linalg.vector_norm(w)))
                for g in got for p, w in params.items())
            if not (loss_gap <= SHARDED_TOL * scale
                    and param_gap <= SHARDED_PARAM_TOL):
                faults.append(
                    f"{arch} on {shape}: losses {got[0]['losses']} vs one "
                    f"rank's {losses} (gap {loss_gap}), parameters "
                    f"{param_gap} of scale from one rank's")
            try:
                pairs = same_slices(got, places)
            except AssertionError as e:
                faults.append(f"{arch} on {shape}: {e}")
                pairs = None
            row = {"losses": got[0]["losses"], "grad_gap": g_gap,
                   "loss_gap": loss_gap,
                   "param_gap": param_gap, "same_slice_pairs": pairs,
                   "comm_calls": {k: v["calls"]
                                  for k, v in got[0]["comm"].items()}}
            if shape == SHARDED["mesh"]:
                k = got[0]
                gap = abs(k["kernel_loss"] - k["plain_loss"])
                if not gap <= TRAIN_TOL * max(1.0, abs(k["plain_loss"])):
                    faults.append(f"{arch} on {shape}: kernel-path loss "
                                  f"{k['kernel_loss']} != plain "
                                  f"{k['plain_loss']}")
                if any(k["launches"].values()) and not k.get("refusal"):
                    faults.append(f"{arch}: the kernel path ran under "
                                  f"grad")
                if arch in oracle:
                    for r, g in enumerate(got):
                        if not np.array_equal(g["tokens"], oracle[arch]):
                            faults.append(
                                f"{arch} shard_engine(mode='fsdp') rank "
                                f"{r}: {g['tokens'].tolist()} != one "
                                f"rank's {oracle[arch].tolist()}")
                row.update(kernel_loss_gap=gap, launches=k["launches"],
                           held=k["held"], refusal=k.get("refusal"))
                if arch in oracle:
                    row["fsdp_tokens"] = g["tokens"].tolist()
                name = f"sharded training {arch} smoke {shape}, loss " \
                       f"without grad (rank 0)"
                runs[name], shapes[name] = k["launches"], k["shapes"]
            rows[f"{arch} {shape}"] = row
    restored = {}
    for (rshape, arch), r0 in world[0]["smoke"][SHARDED["mesh"]][
            "restored"].items():
        saved = smoke[SHARDED["mesh"]][0][arch]["whole"]
        for r in world:
            got = r["smoke"][SHARDED["mesh"]]["restored"][rshape, arch]
            if got["step"] != TRAIN["smoke_steps"] or not all(
                    torch.equal(got["whole"][p], w)
                    for p, w in saved.items()):
                faults.append(f"{arch}: the (2, 2) checkpoint restored "
                              f"onto {rshape} differs")
        restored[f"{arch} {rshape}"] = "bitwise equal"
    report["smoke"] = {"rows": rows, "restored": restored}
    for name, row in rows.items():
        print(f"  21a {name}: gradients {row['grad_gap']:.3g} of scale from "
              f"one rank's slices; losses {row['losses']} (gap "
              f"{row['loss_gap']:.3g}, parameters {row['param_gap']:.3g} "
              f"of scale), "
              f"{row['same_slice_pairs']} rank pairs hold one slice bitwise"
              + (f"; kernel loss gap {row['kernel_loss_gap']:.3g}, "
                 f"launches "
                 f"{ {k: v for k, v in row['launches'].items() if v} }"
                 if "launches" in row else "")
              + (f"; shard_engine(mode='fsdp') tokens == one rank's on "
                 f"every rank: {row['fsdp_tokens']}"
                 if "fsdp_tokens" in row else ""))
    print(f"  21a checkpoints (2, 2) -> {restored}")
    if faults:
        raise AssertionError("21a: " + "; ".join(faults))
    # 21b
    full = [r["full"] for r in world]
    scale = max(1.0, max(map(abs, one_rank_losses)))
    losses = [s["loss"] for s in full[0]["steps"]]
    gap = max(abs(a - b) for a, b in zip(losses, one_rank_losses))
    if any([s["loss"] for s in f["steps"]] != losses for f in full) or \
            not gap <= TRAIN_TOL * scale:
        raise AssertionError(f"21b: losses {losses} vs one rank's "
                             f"{one_rank_losses}")
    k = full[0]
    launches = k["launches"]
    expect = {"goma_matmul": 3 * TRAIN["dp_layers"], "goma_fused_matmul": 0,
              "goma_combine": TRAIN["dp_layers"], "wkv6_scan": 0,
              "ssd_scan": 0}
    if any(f["launches"] != expect for f in full):
        raise AssertionError(f"21b: the loss without grad launched "
                             f"{[f['launches'] for f in full]}, not {expect}")
    name = f"sharded training {TRAIN['arch']} (2, 2), loss without grad " \
           f"(rank 0)"
    runs[name] = launches
    shapes[name] = held_shapes(k["seen"], launches, checked)

    def by_kind(f, i):
        return {kind: {"calls": v["calls"], "bytes": v["bytes"],
                       "seconds": v["seconds"]}
                for kind, v in f["steps"][i]["comm"].items()}
    report["full"] = {
        "losses": losses, "one_rank_losses": one_rank_losses,
        "loss_gap": gap, "step_seconds_by_rank": [
            [s["step_s"] for s in f["steps"]] for f in full],
        "peak_memory_gib_by_rank": [f["peak_memory_gib"] for f in full],
        "local_parameters_by_rank": [f["local_parameters"] for f in full],
        "made_s_by_rank": [f["made_s"] for f in full],
        "collectives_last_step_by_rank": [by_kind(f, -1) for f in full],
        "kernel_loss": k["kernel_loss"], "plain_loss": k["plain_loss"],
        "fp32_kernel_loss_gap": abs(k["kernel_loss"] - k["plain_loss"]),
        "launches": launches, "seconds": world[0]["full_s"]}
    rf = report["full"]
    print(f"  21b {TRAIN['arch']} at {TRAIN['dp_layers']} layers, fp32, "
          f"(2, 2) FSDP + TP on {smi}: losses {losses} (one rank "
          f"{one_rank_losses}, gap {gap:.3g}); step seconds by rank "
          f"{rf['step_seconds_by_rank']}; peak GiB by rank "
          f"{rf['peak_memory_gib_by_rank']}; local parameters "
          f"{rf['local_parameters_by_rank']}")
    for r, c in enumerate(rf["collectives_last_step_by_rank"]):
        print(f"  21b rank {r} collectives in step {TRAIN['dp_steps']} "
              f"(gloo over CUDA tensors staged through the host, the ranks "
              f"sharing one card; host seconds, waits included): {c}")
    print(f"  21b loss without grad, fused MLP: launches {launches} a rank, "
          f"fp32 kernel {k['kernel_loss']} vs plain {k['plain_loss']} (gap "
          f"{rf['fp32_kernel_loss_gap']:.3g}); {rf['seconds']:.1f} s")
    # 21c
    rs = [r["reshard"] for r in world]
    if not all(r["equal"] and r["step"] == 1 for r in rs):
        raise AssertionError("21c: the checkpoint restored onto (4, 1) "
                             "differs from the (2, 2) parameters")
    ckpt = store_root / "world" / "full"
    nbytes = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    report["reshard"] = {
        "layers": SHARDED["reshard_layers"], "checkpoint_bytes": nbytes,
        "save_s_by_rank": [r["save_s"] for r in rs],
        "restore_s_by_rank": [r["restore_s"] for r in rs],
        "bitwise_equal": True, "seconds": world[0]["reshard_s"]}
    print(f"  21c {TRAIN['arch']} at {SHARDED['reshard_layers']} layers: "
          f"saved on (2, 2), restored onto (4, 1), every leaf bitwise equal; "
          f"{nbytes} bytes, save s by rank "
          f"{report['reshard']['save_s_by_rank']}, restore s by rank "
          f"{report['reshard']['restore_s_by_rank']}")
    shutil.rmtree(store_root, ignore_errors=True)
    report["seconds"] = time.perf_counter() - t0
    return {"report": report, "launches": runs, "shapes": shapes}


# ------------------------------------------------------------- phase 22
def roofline_phase(decode: dict, train: dict, smi: str,
                   out: pathlib.Path | None) -> dict:
    """Phase 22: the Hopper roofline of two measured steps, from the
    port's analyzer on meta tensors (``launch.hlo_analysis``), against
    what phases 5 and 20b measured on the card in this run.  22a: phase
    5's llama3-8b decode step (batch 4, bf16, fused MLP, all 32 layers, at
    its profiled position and cache): the analyzer's B1 and goma_combine
    calls and their shapes must be the profiled step's and phase 5's a
    pass, and its bound max(t_compute, t_memory) at most the step's device
    busy time.  22b: phase 20b's stablelm-1.6b train step (8 x 512, fp32
    masters, bf16, full remat, AdamW): its bound at most 20b's profiled
    device busy time; its model flops over the median step's wall time
    and the bf16 peak is the measured MFU."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.hlo_analysis import analyze_program
    from repro_torch.launch.roofline import Roofline, model_flops_estimate
    from repro_torch.models import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import jit_train_step
    gen = torch.Generator()
    # 22a
    cfg = dataclasses.replace(get_config(FULL["arch"]), fused_mlp=True)
    model = build_model(cfg)
    params = model.init_params(gen, "meta")
    cache = model.init_cache(decode["batch"], decode["cache_len"], "meta")
    tok = torch.empty((decode["batch"], 1), dtype=torch.int64,
                      device="meta")

    def step(params, cache, tok):
        with torch.inference_mode():
            return model.decode_step(params, cache, tok, decode["index"])
    a = analyze_program(step, params, cache, tok)
    rl = Roofline(a["flops"], a["bytes"], 0, 1,
                  flops_by_dtype=a["flops_by_dtype"])
    calls = {f"{name} {shape} bfloat16": n
             for name, row in a["kernels"].items()
             for shape, n in row["shapes"].items()}
    per_pass = {k: v for k, v in expected_launches(cfg, 1).items() if v}
    if calls != decode["calls"] or per_pass != {
            k: v["calls"] for k, v in a["kernels"].items()}:
        raise AssertionError(f"analyzed kernel calls {calls} != the "
                             f"profiled step's {decode['calls']} or phase "
                             f"5's a pass {per_pass}")
    bound = max(rl.t_compute, rl.t_memory) * 1e3
    dec = {"flops_by_dtype": a["flops_by_dtype"], "bytes": a["bytes"],
           "t_compute_ms": rl.t_compute * 1e3,
           "t_memory_ms": rl.t_memory * 1e3, "bound_ms": bound,
           "bound_by": rl.bottleneck, "kernels": a["kernels"],
           "trace_s": a["trace_s"], "device_busy_ms":
           decode["device_busy_ms"], "wall_ms": decode["wall_ms"],
           "bound_over_busy": bound / decode["device_busy_ms"],
           "bound_over_wall": bound / decode["wall_ms"]}
    print(f"  22a llama3-8b decode step on {smi}: analyzer {a['flops']:.6g} "
          f"flops {a['flops_by_dtype']}, {a['bytes']:.6g} bytes, "
          f"t_compute {dec['t_compute_ms']} ms, t_memory "
          f"{dec['t_memory_ms']} ms (traced in {a['trace_s']:.1f} s); "
          f"device busy {decode['device_busy_ms']} ms of wall "
          f"{decode['wall_ms']} ms; bound / busy {dec['bound_over_busy']}, "
          f"bound / wall {dec['bound_over_wall']}; kernel calls {calls}")
    if bound > decode["device_busy_ms"]:
        raise AssertionError(f"22a: the bound {bound} ms exceeds the device "
                             f"busy {decode['device_busy_ms']} ms: a counting "
                             f"fault")
    # 22b
    del model, params, cache
    tcfg, tmodel = full_model()
    params = tmodel.init_params(gen, "meta", masters=True)
    batch = tmodel.input_specs(ShapeSpec("train", TRAIN["seq"],
                                         TRAIN["batch"], "train"))
    a = analyze_program(jit_train_step(tmodel, full_optimizer(),
                                       remat=True),
                        params, opt.init_state(params), batch)
    rl = Roofline(a["flops"], a["bytes"], 0, 1,
                  flops_by_dtype=a["flops_by_dtype"])
    n_params = sum(t.numel() for t in leaves(params))
    model_flops = model_flops_estimate(
        tcfg, ShapeSpec("train", TRAIN["seq"], TRAIN["batch"], "train"),
        n_params)
    busy = train["profiled_step"]["device_busy_ms"]
    step_s = train["median_step_s"]
    bound = max(rl.t_compute, rl.t_memory) * 1e3
    tr = {"flops_by_dtype": a["flops_by_dtype"], "bytes": a["bytes"],
          "t_compute_ms": rl.t_compute * 1e3,
          "t_memory_ms": rl.t_memory * 1e3, "bound_ms": bound,
          "bound_by": rl.bottleneck, "trace_s": a["trace_s"],
          "memory": a["memory"], "model_flops": model_flops,
          "device_busy_ms": busy,
          "profiled_wall_ms": train["profiled_step"]["wall_ms"],
          "median_step_s": step_s, "bound_over_busy": bound / busy,
          "compute_over_busy": rl.t_compute * 1e3 / busy,
          "mfu": model_flops / (step_s * roofline.PEAK_FLOPS["bfloat16"])}
    print(f"  22b stablelm-1.6b train step on {smi}: analyzer "
          f"{a['flops']:.6g} flops {a['flops_by_dtype']}, {a['bytes']:.6g} "
          f"bytes, t_compute {tr['t_compute_ms']} ms, t_memory "
          f"{tr['t_memory_ms']} ms (traced in {a['trace_s']:.1f} s); device "
          f"busy {busy} ms, median step {step_s} s; bound / busy "
          f"{tr['bound_over_busy']}, model flops {model_flops:.6g}, MFU "
          f"{tr['mfu']}")
    if bound > busy:
        raise AssertionError(f"22b: the bound {bound} ms exceeds the device "
                             f"busy {busy} ms: a counting fault")
    report = {"device": smi, "decode": dec, "train": tr}
    if out is not None:
        (out / "roofline.json").write_text(json.dumps(report, indent=1))
    return report


def profile_run(fn, smi: str, out: pathlib.Path | None, name: str, *,
                host_ops: bool = True) -> dict:
    """One more run of fn (a generate, a scheduler replay) under
    torch.profiler: device time by kernel, the device's busy and idle
    shares of the wall time, and the port kernels' shares, to
    out/<name>.{json,txt} (with ``out``) and returned.  Without
    ``host_ops`` only the device is traced, which keeps a long replay's
    trace small; the shares need nothing else."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * host_ops
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: the aten ops that launched them carry the
    # same time again
    rows = sorted(({"name": e.key, "calls": e.count,
                    "device_ms": e.self_device_time_total / 1e3}
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    port = {k: sum(r["device_ms"] for r in rows if frag in r["name"])
            for k, frag in PORT_KERNELS.items()}
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    summary = {"device": smi, "wall_ms": wall_ms, "device_busy_ms": busy,
               "device_kernel_launches": sum(r["calls"] for r in rows),
               "device_busy_share": busy / wall_ms,
               "device_idle_share": 1 - busy / wall_ms,
               "port_kernels_ms": port,
               "port_kernels_share_of_busy": {k: v / busy
                                              for k, v in port.items()},
               "top": rows[:20]}
    if out is not None:
        (out / f"{name}.json").write_text(json.dumps(summary, indent=1))
        table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=25)
        (out / f"{name}.txt").write_text(f"{smi}\n{table}\n")
    print(f"  profiled {name}: wall {wall_ms} ms, device busy {busy} ms "
          f"(share {busy / wall_ms}), port kernels {port} ms")
    for r in rows[:8]:
        print(f"    {r['device_ms']:10.3f} ms {r['calls']:6d}  "
              f"{r['name'][:80]}")
    return summary


# --------------------------------------------------------------- phase 23
# the fused attention kernel (kernels/attention.py) against its plain
# version and the walk: (name, B, S, H, KV, hd, causal, first position).
# stablelm-1.6b's training shape and a GQA shape at head size 128 (32
# query heads on 8 KV heads), each also at a ragged length with positions
# that do not start at 0, and a non-causal call (the encoder's kind)
ATTN_SHAPES = (("train4k", 2, 4096, 32, 32, 64, True, 0),
               ("train4k ragged", 2, 4001, 32, 32, 64, True, 100),
               ("gqa hd128", 2, 4096, 32, 8, 128, True, 0),
               ("gqa hd128 ragged", 2, 3001, 32, 8, 128, True, 100),
               ("non-causal", 2, 1000, 16, 16, 64, False, 100))
# kernel vs plain version in fp32 (the output before its bf16 rounding,
# the log-sum-exp and the gradients written in fp32), each tensor's
# largest gap over its largest magnitude.  Both sum the same exact
# products in fp32 in other orders, over up to 4096 terms: each lies
# within 3.5e-6 of fp64 on the H100
ATTN_TOL = 1e-5
# ... and against fp64 on a slice (exact_attention): the kernel's gap at
# most this many times the plain version's (its fp32 sums are no less
# exact than the walk's), or 1e-6
ATTN_FP64_RATIO = 2.0
# one training step of stablelm-1.6b at the benchmark's 2 x 4096
ATTN_TRAIN = dict(batch=2, seq=4096, steps=3)


def exact_attention(q, k, v, do, pos, causal) -> dict:
    """The attention and its gradients in fp64 by autograd, on batch row
    0 and the first KV head's group of query heads: {"o", "dq", "dk",
    "dv"}, the sizes of those slices."""
    G = q.shape[2] // k.shape[2]
    leaves = [t[:1, :, :n].double().requires_grad_()
              for t, n in ((q, G), (k, 1), (v, 1))]
    qd, kd, vd = leaves
    s = torch.einsum("bsgd,btd->bgst", qd, kd[:, :, 0]) / math.sqrt(
        q.shape[-1])
    s = s.masked_fill(pos[None, :] >= k.shape[1], -torch.inf)
    if causal:
        s = s.masked_fill(pos[None, :] > pos[:, None], -torch.inf)
    o = torch.einsum("bgst,btd->bsgd", torch.softmax(s, -1), vd[:, :, 0])
    o.backward(do[:1, :, :G].double())
    return {"o": o.detach(), "dq": qd.grad, "dk": kd.grad, "dv": vd.grad}


def attention_check(name, B, S, H, KV, hd, causal, start, gen,
                    timed: bool) -> dict:
    """The kernels against the plain version on the card in fp32 (held
    at ATTN_TOL), both against fp64 on a slice (``exact_attention``,
    held at ATTN_FP64_RATIO), and the kernels against the walk in bf16
    (reported);
    with ``timed`` the forward and
    backward times of the kernels, the walk and SDPA (``library_ms``,
    the yardstick the port never calls) beside the least time."""
    import torch.nn.functional as F
    from repro_torch.kernels import attention as A
    from repro_torch.models.layers import flash_attention
    bf16 = torch.bfloat16
    q, do = (rand((B, S, H, hd), bf16, gen) for _ in range(2))
    k, v = (rand((B, S, KV, hd), bf16, gen) for _ in range(2))
    pos = torch.arange(start, start + S, device="cuda")
    args = (q, k, v, pos, pos, causal)
    o, o32, lse = A._launch_forward(*args)
    dq, dk, dv = A._launch_backward(*args, o32, lse, do,
                                    grad_dtype=torch.float32)
    torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v, do)]
    po, po32, plse = A.fused_attention_plain(*f[:3], pos, pos, causal)
    del po
    grads = A.fused_attention_plain_backward(*f[:3], pos, pos, causal,
                                             po32, plse, f[3])
    row = {"name": name, "shape": [B, S, H, KV, hd], "causal": causal,
           "first_position": start, "errors": {}, "vs_fp64": {}}
    ex = exact_attention(q, k, v, do, pos, causal)
    G = H // KV

    def gap(got, want):
        return float((got - want).abs().max() / want.abs().max())
    for i, (what, got, want) in enumerate((
            ("o", o32, po32), ("lse", lse[..., :S], plse),
            ("dq", dq, grads[0]),
            ("dk", dk, grads[1]), ("dv", dv, grads[2]))):
        row["errors"][what] = err = gap(got, want)
        if not err <= ATTN_TOL:
            raise AssertionError(f"attention {name}: {what} is {err} of "
                                 f"scale from the plain version")
        if what != "lse":
            part = (slice(0, 1), slice(None), slice(0, G if what in (
                "o", "dq") else 1))
            row["vs_fp64"][what] = e = {
                "kernel": gap(got[part].double(), ex[what]),
                "plain": gap(want[part].double(), ex[what])}
            if not e["kernel"] <= max(ATTN_FP64_RATIO * e["plain"], 1e-6):
                raise AssertionError(f"attention {name}: {what}'s gap to "
                                     f"fp64 {e}")
    del grads, po32, plse, f, ex
    free_device()
    # against the walk in bf16, through autograd both; the walk given
    # kv_len=T masks the keys at positions >= T, as the kernel does
    leaves_ = [t.clone().requires_grad_() for t in (q, k, v)]
    walk = flash_attention(*leaves_, q_positions=pos, kv_positions=pos,
                           causal=causal, kv_len=S)
    walk.backward(do)
    kl = [t.clone().requires_grad_() for t in (q, k, v)]
    fused = A.fused_attention(*kl, q_positions=pos, kv_positions=pos,
                              causal=causal)
    fused.backward(do)
    row["vs_walk_bf16"] = {
        what: float((a.detach().float() - b.detach().float()).abs().max()
                    / b.detach().float().abs().max())
        for what, a, b in (("o", fused, walk),
                           *((f"d{n}", x.grad, w.grad) for n, x, w in
                             zip("qkv", kl, leaves_)))}
    del walk, fused, leaves_, kl
    free_device()
    print(f"  {name}: plain vs kernel {row['errors']}; each vs fp64 "
          f"{row['vs_fp64']}; walk vs kernel (bf16) {row['vs_walk_bf16']}")
    if not timed:
        return row
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * hd * pairs
    io = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)   # q, o; k, v
    G = H // KV
    row["forward"] = {
        "ms": time_ms(lambda: A._launch_forward(*args)),
        "device_ms": device_ms(lambda: A._launch_forward(*args), reps=5)}
    row["backward"] = {
        "ms": time_ms(lambda: A._launch_backward(*args, o32, lse, do)),
        "device_ms": device_ms(
            lambda: A._launch_backward(*args, o32, lse, do), reps=5)}
    # the backward's function: the 4 products, q, k, v, o, dO and lse
    # read, dq, dk, dv written
    for part, fl, nb in (("forward", flops, io),
                         ("backward", 2 * flops,
                          2 * io + B * S * H * hd * 2 + B * H * S * 4)):
        bound, by = bound_ms(nb, fl, bf16)
        row[part].update(bound_ms=bound, bound_by=by,
                         bound_share=bound / row[part]["device_ms"])

    def walk_fwd():
        with torch.no_grad():
            flash_attention(q, k, v, q_positions=pos, kv_positions=pos,
                            causal=causal)

    def walk_both():
        ls = [t.detach().requires_grad_() for t in (q, k, v)]
        flash_attention(*ls, q_positions=pos, kv_positions=pos,
                        causal=causal).backward(do)

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           enable_gqa=G > 1)

    def sdpa_both():
        ls = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        F.scaled_dot_product_attention(
            *ls, is_causal=causal, enable_gqa=G > 1).backward(
                do.transpose(1, 2))

    row["forward"].update(plain_ms=time_ms(walk_fwd, reps=3),
                          library_ms=time_ms(sdpa_fwd))
    row["forward_backward"] = {
        "ms": row["forward"]["ms"] + row["backward"]["ms"],
        "plain_ms": time_ms(walk_both, reps=3),
        "library_ms": time_ms(sdpa_both)}
    free_device()
    print(f"  {name}: forward {row['forward']}; backward "
          f"{row['backward']}; forward and backward "
          f"{row['forward_backward']}")
    return row


def attention_train_step(smi: str, out: pathlib.Path | None) -> dict:
    """stablelm-1.6b at full width, 2 x 4096, fp32 masters, bf16, full
    remat: ATTN_TRAIN's steps of jit_train_step, each loss finite; in
    the last, the fused attention's wrapper runs its forward 2 x layers
    times (the forward and the recompute) and its backward once a layer,
    and no call stays on the walk (the registry's attn.kernel and
    attn.walk).  Then one step under the profiler: device time by
    kernel, busy and idle."""
    from repro_torch.kernels.attention import _ranges, fused_attention
    from repro_torch.obs.registry import get_registry
    from repro_torch.training.train_step import jit_train_step
    free_device()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, params, state = train_full_setup()
    step = jit_train_step(model, full_optimizer(), remat=True)
    B, S = ATTN_TRAIN["batch"], ATTN_TRAIN["seq"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    reg = get_registry()
    seconds, losses = [], []
    for _ in range(ATTN_TRAIN["steps"]):
        before = (fused_attention.launches,
                  fused_attention.backward_launches,
                  reg.get("attn.kernel"), reg.get("attn.walk"),
                  _ranges.computed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        seconds.append(time.perf_counter() - t0)
    counts = {"forward": fused_attention.launches - before[0],
              "backward": fused_attention.backward_launches - before[1],
              "attn.kernel": reg.get("attn.kernel") - before[2],
              "attn.walk": reg.get("attn.walk") - before[3]}
    want = {"forward": 2 * cfg.layers, "backward": cfg.layers,
            "attn.kernel": 2 * cfg.layers, "attn.walk": 0}
    tables = _ranges.computed - before[4]
    if counts != want or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a train step ran {counts}, not {want}; "
                             f"losses {losses}")
    peak = torch.cuda.max_memory_allocated()
    prof = profile_run(lambda: step(params, state, batch), smi, out,
                       "profile_train4k", host_ops=False)
    report = {"device": smi, "counts": counts, "tile_tables": tables,
              "losses": losses,
              "step_seconds": seconds, "tokens_per_s": B * S / seconds[-1],
              "peak_memory_bytes": peak,
              "profiled_step": {k: prof[k] for k in (
                  "wall_ms", "device_busy_ms", "device_busy_share",
                  "device_idle_share", "device_kernel_launches")}}
    print(f"  train step 2 x 4096: {report}")
    del params, state, step
    free_device()
    return report


def attention_serving_route(device: str = "cuda") -> dict:
    """Serving keeps the walk: llama3-8b's smoke config at head size 64
    in bf16 (a call the kernel would take but for its cache) generates on
    the card with ``attn.walk`` counting and ``attn.kernel`` not."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_to
    from repro_torch.obs.registry import get_registry
    from repro_torch.serving import Engine, ServeConfig
    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                              head_dim=64, compute_dtype="bfloat16")
    model = build_model(cfg)
    params = tree_to(model.init_params(
        torch.Generator().manual_seed(SEED), "cpu"), device)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (4, 24)).astype(np.int32)
    reg = get_registry()
    before = {k: reg.get(k) for k in ("attn.kernel", "attn.walk")}
    Engine(model, params, ServeConfig(max_new_tokens=8, cache_len=64)
           ).generate(prompts)
    moved = {k: reg.get(k) - v for k, v in before.items()}
    if moved["attn.kernel"] != 0 or moved["attn.walk"] <= 0:
        raise AssertionError(f"serving routed attention {moved}")
    print(f"  serving with a cache: {moved}")
    return moved


def attention_encoder_route(device: str = "cuda") -> dict:
    """The encoder-decoder's encoder has no cache, so serving runs it on
    the kernel: seamless-m4t-medium's smoke config at head size 64 in
    bf16 generates on the card with one ``attn.kernel`` an encoder layer
    (non-causal) and its decoder's calls on the walk.  (The kernel's
    non-causal numbers are ATTN_SHAPES' "non-causal" case.)"""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_to
    from repro_torch.obs.registry import get_registry
    from repro_torch.serving import Engine, ServeConfig
    cfg = dataclasses.replace(get_config("seamless-m4t-medium", smoke=True),
                              head_dim=64, compute_dtype="bfloat16")
    model = build_model(cfg)
    params = tree_to(model.init_params(
        torch.Generator().manual_seed(SEED), "cpu"), device)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (4, 12)).astype(np.int32)
    reg = get_registry()
    before = {k: reg.get(k) for k in ("attn.kernel", "attn.walk")}
    tokens = Engine(model, params, ServeConfig(max_new_tokens=4,
                                               cache_len=32)).generate(
        prompts, extra_batch=frontend_inputs(cfg, 4, device))
    moved = {k: reg.get(k) - v for k, v in before.items()}
    if moved["attn.kernel"] != cfg.encoder_layers or moved["attn.walk"] <= 0:
        raise AssertionError(f"the encoder-decoder routed attention "
                             f"{moved}, not {cfg.encoder_layers} encoder "
                             f"layers on the kernel")
    print(f"  the encoder-decoder's serving: {moved}; tokens "
          f"{tokens.tolist()}")
    return moved


def attention_phase(smi: str, out: pathlib.Path | None,
                    timed: bool = True) -> dict:
    """Phase 23: every ATTN_SHAPES case (``attention_check``), serving's
    route (``attention_serving_route``, ``attention_encoder_route``), then
    the training step
    (``attention_train_step``) when ``timed``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = [attention_check(*shape, gen, timed) for shape in ATTN_SHAPES]
    report = {"device": smi, "shapes": rows}
    report["serving"] = attention_serving_route()
    report["encoder"] = attention_encoder_route()
    if timed:
        report["train_step"] = attention_train_step(smi, out)
    if out is not None:
        (out / "attention.json").write_text(json.dumps(report, indent=1))
    return report


# phase 24: the latent attention kernel at dsv2lite.chat8k's shapes: its
# decode step (128 slots of an 8192 cache, positions from the cell's
# prompt and output distributions) and 512-wide chunks in the step
# graphs' form (per-row positions over a 4096 or 6144 bucket, the chunk's
# last 100 positions left for later chunks), on slot 3 of a full cache
MLA_DECODE = (128, 8192)
MLA_CHUNKS = ((512, 4096), (512, 6144))
MLA_HEADS = 16
# chat8k's traffic (portbench/traffic/chat8k.json): lognormal lengths
MLA_PROMPT = (2048, 0.8, 256, 6144)      # median, sigma, least, most
MLA_OUTPUT = (384, 0.8, 32, 2048)
# kernel vs plain version (the same rounding points, sums in another
# order: a flipped rounding of P or of o), vs the products (P rounded
# after the normalisation) and vs the function in fp32 (the output's one
# bf16 rounding, and P's), as the largest error over the output's scale
MLA_TOL = {"plain": 1e-2, "products": 2e-2, "fp32": 1e-2}


def mla_positions(rng, B: int, T: int) -> np.ndarray:
    """Each slot's decode position: a prompt length and a share of an
    output length drawn from chat8k's distributions, at most T - 1."""
    def draw(median, sigma, lo, hi):
        return np.clip(np.round(median * np.exp(sigma * rng.standard_normal(
            B))), lo, hi)
    prompt = draw(*MLA_PROMPT)
    out = draw(*MLA_OUTPUT)
    return np.minimum(prompt + np.floor(rng.random(B) * out), T - 1)


def mla_sdpa(q, ckv, qpos):
    """The same attention as one library call, the yardstick the port
    never calls: ``F.scaled_dot_product_attention`` with q (B, H, S,
    576), the cache broadcast to every head as keys and its first 512
    columns as values, and a boolean mask of each query's visible keys
    (made once, outside the call).  Returns the call as a function of
    nothing, whose output is (B, S, H, 512)."""
    import torch.nn.functional as F
    from repro_torch.kernels import mla_attention as MK
    B, S, H, D = q.shape
    T = ckv.shape[1]
    qt = q.transpose(1, 2)
    k = ckv[:, None].expand(B, H, T, D)
    v = ckv[:, None, :, :MK.VALUE_DIM].expand(B, H, T, MK.VALUE_DIM)
    mask = (torch.arange(T, device=q.device) <= qpos[..., None])[:, None]
    return lambda: F.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask, scale=1.0).transpose(1, 2)


def mla_case(name: str, q, ckv, qpos, smi: str) -> dict:
    """The kernel against its plain version and the products on one
    input, and each of the three against the function in fp32 (the
    products with nothing rounded but the inputs), its eager call against
    its graph's replay (also after new positions are copied into the
    graph's input), and device times beside its least time (``work``'s
    bytes or operations) and the plain version's, the products' and
    SDPA's times (``mla_sdpa``, the library's one call)."""
    from repro_torch.kernels import mla_attention as MK
    from repro_torch.models import mla
    B, S, H, _ = q.shape
    T = ckv.shape[1]
    R = MK.VALUE_DIM
    got = MK.mla_attention(q, ckv, qpos)
    torch.cuda.synchronize()
    plain = MK.mla_attention_plain(q, ckv, qpos)
    prods = mla.latent_products(q.float(), ckv, qpos, R)
    exact = mla.latent_products(q.float(), ckv.float(), qpos, R)
    scale = float(exact.abs().max())
    err = lambda x, y: float((x.float() - y.float()).abs().max()) / scale
    errs = {"plain": err(got, plain), "products": err(got, prods),
            "products_vs_plain": err(prods, plain),
            "fp32": err(got, exact), "products_vs_fp32": err(prods, exact)}
    for k, tol in MLA_TOL.items():
        if not errs[k] <= tol:
            raise AssertionError(f"mla {name}: kernel vs {k} {errs[k]:.3g} "
                                 f"of scale, beyond {tol}")
    del plain, prods
    sdpa = mla_sdpa(q, ckv, qpos)
    try:
        errs["sdpa_vs_fp32"] = err(sdpa(), exact)
    except RuntimeError as e:             # no backend takes the call
        sdpa, errs["sdpa_vs_fp32"] = None, f"{type(e).__name__}: {e}"[:300]
    del exact
    # a graph of the call replays the eager call bit for bit
    pos_g = qpos.clone()
    MK.mla_attention(q, ckv, pos_g)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_g = MK.mla_attention(q, ckv, pos_g)
    graph.replay()
    same = [bool(torch.equal(out_g, got))]
    moved = torch.clamp(qpos - 57, min=0)
    pos_g.copy_(moved)
    graph.replay()
    same.append(bool(torch.equal(out_g, MK.mla_attention(q, ckv, moved))))
    torch.cuda.synchronize()
    if not all(same):
        raise AssertionError(f"mla {name}: a graph's replay differs from "
                             f"the eager call: {same}")
    w = MK.work(B, S, H, T, qpos)
    bound, bound_by = bound_ms(w["bytes"], w["flops"], torch.bfloat16)
    kern = lambda: MK.mla_attention(q, ckv, qpos)
    old = lambda: mla.latent_products(q.float(), ckv, qpos, R)
    dev, dev_old = device_ms(kern), device_ms(old)
    ev, ev_old = time_ms(kern), time_ms(old)
    lib = {"library_ms": None, "library_device_ms": None,
           "library_kernels": None}
    if sdpa is not None:
        lib = {"library_ms": time_ms(sdpa),
               "library_device_ms": device_ms(sdpa),
               "library_kernels": {k[:90]: n for k, n in
                                   device_kernels(sdpa).items()}}
    plain_ms = time_ms(lambda: MK.mla_attention_plain(q, ckv, qpos), reps=3)
    row = {"name": name, "shape": [B, S, H, T], "device": smi,
           "visible_keys": int((torch.clamp(qpos, max=T - 1) + 1)
                               .amax(1).sum()),
           "errors": errs, "graph_bitwise": same,
           "device_ms": dev, "ms": ev, "products_device_ms": dev_old,
           "products_ms": ev_old, **lib, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": bound_by, "bound_share": bound / dev,
           "achieved_bytes_per_s": w["bytes"] / (dev / 1e3),
           "speedup_vs_products": dev_old / dev,
           "speedup_vs_library": (lib["library_device_ms"] / dev
                                  if sdpa is not None else None)}
    print(f"  mla {name}: device {dev:.4f} ms (event {ev:.4f}), bound "
          f"{bound:.4f} ms {bound_by} ({100 * bound / dev:.1f}%), products "
          f"{dev_old:.4f} ms ({dev_old / dev:.2f}x), SDPA "
          f"{lib['library_device_ms']} ms device ({lib['library_kernels']}),"
          f" plain {plain_ms:.2f} ms; errors {errs}; graph bitwise {same}",
          flush=True)
    return row


# the model's passes on the card (``mla_model_route``): DeepSeek-V2-Lite
# at full width over MLA_ROUTE_SLOTS slots of chat8k's 8192-key cache
# (the cell has 128; fewer keep the products' comparison pass small)
MLA_ROUTE_SLOTS = 8


def mla_model_route(smi: str, device: str = "cuda") -> dict:
    """DeepSeek-V2-Lite at its published widths (bf16 layers; the MLPs
    on cuBLAS, ``fused_mlp`` off, so that no plan is solved) over a
    latent cache of MLA_ROUTE_SLOTS x 8192 filled with random rows: one
    decode pass at per-row positions drawn as chat8k's, one 512-wide
    chunk in the step graphs' form (per-row positions over the 6144-key
    bucket) and the same chunk at one write position (the eager form).
    Each pass runs ``attn.mla`` once a layer and the kernel takes every
    call: ``attn.mla_kernel`` == ``attn.mla`` == ``mla_attention``'s
    launches == layers.  The decode pass again with the route sent to
    the products (``mla.latent_products``) on the same cache: its logits
    beside the kernel's (reported; both bf16 through 27 layers)."""
    from repro_torch.configs.deepseek_v2_lite import CONFIG
    from repro_torch.kernels import mla_attention as MK
    from repro_torch.models import build_model, mla
    from repro_torch.obs.registry import get_registry
    cfg = dataclasses.replace(CONFIG, fused_mlp=False)
    model = build_model(cfg)
    reg = get_registry()
    with torch.inference_mode():
        params = model.init_params(
            torch.Generator(device=device).manual_seed(SEED), device)
        B, T = MLA_ROUTE_SLOTS, MLA_DECODE[1]
        gen = torch.Generator(device=device).manual_seed(SEED + 1)
        cache = model.init_cache(B, T, device=device)
        cache["layers"]["ckv"].normal_(generator=gen)
        rng = np.random.default_rng(SEED)
        pos = torch.tensor(mla_positions(rng, B, T), dtype=torch.int64,
                           device=device)
        W, ctx = MLA_CHUNKS[-1]
        start = ctx - W - 100
        chunk = torch.randint(0, cfg.vocab, (1, W), generator=gen,
                              device=device)
        row = {"layers": {"ckv": cache["layers"]["ckv"][:, 3:4]}}
        bucket = {"layers": {"ckv": row["layers"]["ckv"][:, :, :ctx]}}
        passes = {
            "decode": (cache, torch.randint(0, cfg.vocab, (B, 1),
                                            generator=gen, device=device),
                       pos),
            f"chunk{W}@{ctx} per-row": (bucket, chunk,
                                        torch.tensor([start], device=device)),
            f"chunk{W}@{start} one write position": (row, chunk, start)}
        counts, logits = {}, {}
        for name, (c, tokens, index) in passes.items():
            before = (MK.mla_attention.launches, reg.get("attn.mla"),
                      reg.get("attn.mla_kernel"))
            logits[name], _ = model.decode_step(params, c, tokens, index)
            torch.cuda.synchronize()
            counts[name] = {
                "mla_attention.launches": MK.mla_attention.launches
                - before[0], "attn.mla": reg.get("attn.mla") - before[1],
                "attn.mla_kernel": reg.get("attn.mla_kernel") - before[2]}
            if set(counts[name].values()) != {cfg.layers}:
                raise AssertionError(f"mla route, {name}: {counts[name]}, "
                                     f"not {cfg.layers} of each")
            if name == "decode":
                # the same pass on the products, before the chunks write
                # into the cache: it rewrites the pass's own rows alone
                versus = mla_decode_versus(model, params, cache, tokens, pos,
                                           logits[name])
        chunks = list(logits)[1:]
        a, b = (logits[k][0, -1].float() for k in chunks)
        same_chunk = {"equal": bool(torch.equal(a, b)),
                      "max_abs_diff": float((a - b).abs().max()),
                      "scale": float(b.abs().max())}
    report = {"device": smi, "slots": B, "cache": T,
              "positions": pos.tolist(), "counts": counts,
              "chunk_forms": same_chunk, "decode_kernel_vs_products": versus}
    print(f"  the model's passes: {report}", flush=True)
    del params, cache, row, bucket, logits
    free_device()
    return report


def mla_decode_versus(model, params, cache, tokens, pos, kernel_logits):
    """The decode pass again with the route sent to the products
    (``mla.latent_products``), from the cache the kernel's pass left:
    the two passes' logits, each row's best token, and how far the
    kernel's best lies below the products' best in the products' logits
    (the cell's ``gap``, between the two card paths)."""
    from repro_torch.kernels import mla_attention as MK
    from repro_torch.models import mla
    decode_k = kernel_logits[:, 0].float().clone()
    orig = mla.kernel_route
    mla.kernel_route = lambda cfg, ckv: False
    try:
        before = MK.mla_attention.launches
        decode_p, _ = model.decode_step(params, cache, tokens, pos)
        torch.cuda.synchronize()
        launches = MK.mla_attention.launches - before
    finally:
        mla.kernel_route = orig
    decode_p = decode_p[:, 0].float()
    best_p, best_k = decode_p.argmax(-1), decode_k.argmax(-1)
    gap = (decode_p.gather(-1, best_p[:, None])
           - decode_p.gather(-1, best_k[:, None]))[:, 0]
    return {"max_abs_diff": float((decode_k - decode_p).abs().max()),
            "scale": float(decode_p.abs().max()),
            "argmax_agree": int((best_p == best_k).sum()),
            "rows": int(decode_p.shape[0]),
            "kernel_gap_in_products_logits": float(gap.max()),
            "products_launches": launches}


def mla_phase(smi: str, out: pathlib.Path | None) -> dict:
    """Phase 24: the latent attention kernel (``kernels.mla_attention``)
    at chat8k's decode shape and two 512-wide chunks (``mla_case``), with
    nvcc's report of its registers and spills, then the model's passes
    through it (``mla_model_route``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import mla_attention as MK
    report = _build.build()
    ptxas = [ln.strip() for ln in report.ptxas.get("mla_attention.cu",
                                                   "").splitlines()
             if re.search(r"registers|spill|Performance|error", ln)]
    print("  mla_attention.cu ptxas:\n    " + "\n    ".join(ptxas))
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, T = MLA_DECODE
    H, D = MLA_HEADS, MK.KEY_DIM
    cache = torch.randn((B, T, D), generator=gen, device="cuda").to(
        torch.bfloat16)

    def queries(B, S):
        return (0.05 * torch.randn((B, S, H, D), generator=gen,
                                   device="cuda")).to(torch.bfloat16)
    rows = []
    qpos = torch.tensor(mla_positions(rng, B, T), dtype=torch.int64,
                        device="cuda")[:, None].contiguous()
    rows.append(mla_case("decode", queries(B, 1), cache, qpos, smi))
    for W, ctx in MLA_CHUNKS:
        start = ctx - W - 100
        pos = torch.arange(start, start + W, device="cuda")[None]
        rows.append(mla_case(f"chunk{W}@{ctx}", queries(1, W),
                             cache[3:4, :ctx], pos, smi))
    del cache
    free_device()
    result = {"device": smi, "ptxas": ptxas, "rows": rows,
              "model": mla_model_route(smi)}
    if out is not None:
        (out / "mla_attention.json").write_text(json.dumps(result,
                                                           indent=1))
    return result


def mla_kernel_entry(mla: dict) -> dict:
    """Phase 24's line in the ``kernels`` report, beside the fused
    attention's: the model's launches a pass, and the decode shape's
    errors, times and bound."""
    dec = next(r for r in mla["rows"] if r["name"] == "decode")
    return {
        "name": "mla_attention (mla_attn, mla_combine)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mla_attention.cu",
        "replaces": None,
        "launches": {k: v["mla_attention.launches"]
                     for k, v in mla["model"]["counts"].items()},
        "attn.mla_kernel": {k: v["attn.mla_kernel"]
                            for k, v in mla["model"]["counts"].items()},
        "errors": dec["errors"], "graph_bitwise": dec["graph_bitwise"],
        **{k: dec[k] for k in ("device_ms", "ms", "bound_ms", "bound_by",
                               "bound_share", "products_device_ms",
                               "library_ms", "library_device_ms",
                               "plain_ms")},
        "chunks": {r["name"]: {k: r[k] for k in (
            "device_ms", "bound_ms", "bound_by", "products_device_ms",
            "library_device_ms")} for r in mla["rows"]
            if r["name"] != "decode"},
        "shape": dec["shape"], "dtype": "bfloat16",
        "path": f"deepseek-v2-lite serving: a decode pass over "
                f"{mla['model']['slots']} slots of {mla['model']['cache']}, "
                f"512-wide chunks per-row and at one write position"}


def time_generate(reps: int, smi: str) -> None:
    """Phase 5's static generate alone: llama3-8b at its published
    widths, bf16, fused MLP, FULL's batch, prompt and new tokens, weights
    from the seed; one generate first (its plans solved), then ``reps``
    timed ones with equal tokens, each printed as tokens/s.  It calls
    only entry points the port has had since its first slices, so a copy
    of this script at the root of an older checkout times that
    checkout's port: run the two alternately in one session to compare
    two commits."""
    from repro_torch.kernels import _build
    from repro_torch.serving import Engine, ServeConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    _build.load()
    cfg, model, params = make_full(FULL["arch"], fused_mlp=True)
    B, S, new = FULL["batch"], FULL["prompt_len"], FULL["new_tokens"]
    prompts = full_prompts(cfg)
    eng = Engine(model, params, ServeConfig(max_new_tokens=new,
                                            cache_len=S + new + 8))
    first = eng.generate(prompts)
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = eng.generate(prompts)
        runs.append(time.perf_counter() - t0)
        if not np.array_equal(tokens, first):
            raise AssertionError("a timed generate gave other tokens")
    tps = [B * new / t for t in runs]
    print(smi)
    print(json.dumps({"time_generate": {
        "root": str(ROOT), "tokens_per_s": tps,
        "median_tokens_per_s": statistics.median(tps)}}))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json (per-shape rows)")
    ap.add_argument("--time-generate", action="store_true",
                    help="only time phase 5's static generate "
                         f"{PHASE5_TIMED_RUNS} times (time_generate)")
    ap.add_argument("--attention", action="store_true",
                    help="only phase 23: the fused attention kernel")
    ap.add_argument("--mla", action="store_true",
                    help="only phase 24: the latent attention kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on "
                 "the card")
    # phase 20's resume check runs under deterministic algorithms, which
    # need cuBLAS's fixed workspace; set before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if args.time_generate:
        time_generate(PHASE5_TIMED_RUNS, subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0])
        return
    out = pathlib.Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    if args.attention:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(f"  {smi}; torch {torch.__version__}")
        with phase("23 the fused attention kernel"):
            attention_phase(smi, out)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if args.mla:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(f"  {smi}; torch {torch.__version__}")
        with phase("24 the latent attention kernel"):
            mla = mla_phase(smi, out)
        print(json.dumps({"kernels": [mla_kernel_entry(mla)]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    from repro_torch.kernels import _build
    t_start = time.perf_counter()
    # fresh plan stores for phases 3 and 12, removed when the script ends
    stores = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_plans_"))
    atexit.register(shutil.rmtree, stores, True)

    with phase("1 device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"  {smi}")
        print(f"  torch {torch.__version__} cuda {torch.version.cuda}, "
              f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")

    with phase("2 build kernels"):
        report = _build.build()
        print(f"  nvcc: {report.seconds:.2f} s for "
              f"{len(report.ptxas)} sources, in parallel")
        for src, log in report.ptxas.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {src}: {line.strip()}")
        _build.load()
        # the bf16 GEMM kernels and the scans run on the tensor cores:
        # their SASS has HGMMA, or TF32 HMMA
        mma = mma_counts(report.path)
        print(f"  tensor-core instructions per kernel (cuobjdump -sass; "
              f"HGMMA in goma_*, TF32 HMMA in the scans): "
              f"{mma if mma is not None else 'no cuobjdump'}")
        # B1 at three slice widths, B2; B3 and B4's prologue and scan in
        # two dtypes, B4's at the (N) and (P, N) it is built for
        families = {"goma_matmul_wgmma": 3, "goma_fused_wgmma": 1,
                    "wkv6_kernel": 2, "ssd_cb_kernel": 4,
                    "ssd_scan_kernel": 8}
        if mma is not None and (
                {f: sum(k.startswith(f + "<") or k == f for k in mma)
                 for f in families} != families
                or not all(mma.values())):
            raise AssertionError(f"a tensor-core kernel without its MMA "
                                 f"instructions: {mma}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b1_rows, b2_rows, combine_rows = [], [], []
    with phase("3 kernels vs plain versions"):
        for dtype in (torch.float32, torch.bfloat16):
            for shape in ODD_SHAPES:
                b1_rows.append(check_b1(shape, dtype, gen, timed=False))
        # every served MLP's gate/up and down products, at decode and in
        # the prefill, under the plans the model takes
        for rows, ff, d in SERVED_MLPS.values():
            for M in rows:
                for N, K in ((ff, d), (d, ff)):
                    b1_rows.append(check_b1((M, N, K), torch.bfloat16, gen,
                                            timed=True))
        # hand-made plans: nk == 1, nk > 1, and nm > 1 with nk > 1 (the
        # reference's grid-path plans, with FF = 128 so that the fp32
        # strips of bm = 128 fit a CTA)
        from repro_torch.core.hopper_mapping import FusedTilePlan
        for dtype in (torch.float32, torch.bfloat16):
            for bm, bk in ((128, 128), (128, 64), (64, 32)):
                plan = FusedTilePlan(
                    M=128, FF=128, K=128, N2=128,
                    padded=(128, 128, 128, 128), fused=True, bm=bm, bk=bk,
                    objective=0.0, unfused_objective=0.0, solve_time_s=0.0)
                b2_rows.append(check_b2(128, 128, 128, dtype, gen,
                                        plan=plan, timed=False))
        # the smoke chain at decode and prefill (phase 4), at the
        # scheduler's slots and chunk widths (phase 10), and at the rows of
        # the scale-out paths (phase 14)
        for M in sorted({FULL["batch"], FULL["batch"] * FULL["prompt_len"],
                         SCHED_SMOKE["slots"], *SCHED_SMOKE["chunk_widths"],
                         *SPEC_SMOKE_ROWS}):
            b2_rows.append(check_b2(M, 128, 64, torch.float32, gen,
                                    timed=True))
        # ... and, untimed, at every row count phase 16's model drafter
        # can run it at and at phase 17's smoke prefills
        held_b2 = {r["shape"][0] for r in b2_rows}
        b2_rows += [check_b2(M, 128, 64, torch.float32, gen, timed=False)
                    for M in sorted({*range(1, CAPTURE_FLEET_ROWS + 1),
                                     *CATALOG_SMOKE_ROWS} - held_b2)]
        # ... and at phase 18's local d_ff
        b2_rows += [check_b2(M, ff, 64, torch.float32, gen, timed=False)
                    for M, ff in TP_SMOKE_CHAINS]
        # phase 21b's loss without grad: B1 and goma_combine at a (2, 2)
        # rank's MLP, fp32, timed (cold weights)
        M, ff, d = SHARDED_MLP
        b1_rows += [check_b1((M, N, K), torch.float32, gen, timed=True)
                    for N, K in ((ff, d), (d, ff))]
        combine_rows.append(check_combine((M, ff), torch.float32, gen,
                                          timed=True))
        # the composition's combine: an odd fp32 shape, and every served
        # MLP's strip at decode and in the prefill
        combine_rows.append(check_combine((129, 257), torch.float32, gen,
                                          timed=False))
        for rows, ff, _ in SERVED_MLPS.values():
            for M in rows:
                combine_rows.append(check_combine((M, ff), torch.bfloat16,
                                                  gen, timed=True))
        tiling = check_tiling_independence(gen)
        for r in b1_rows + b2_rows + combine_rows + tiling:
            print("  " + json.dumps(r))
        c7 = check_row_independence(gen, stores / "c7")
        print(f"  C7, row 0 at M = {C7_ROWS} vs M = 1, bitwise equal: "
              f"{ {k: r['bitwise_equal'] for k, r in c7.items()} }")
        for name, r in c7.items():
            print(f"    {name}: {json.dumps(r)}")
        # the scans: an odd small shape (a chunk of 8, the last 32-token
        # sub-chunk padded), the full-width prefill shapes at chunk 128,
        # timed, and there at the mild and strong decays too
        wkv_rows = [check_wkv6((2, 40, 3, 64), 8, dtype, gen, timed=False)
                    for dtype in (torch.float32, torch.bfloat16)]
        ssd_rows = [check_ssd((2, 40, 3, 64, 16), 8, torch.float32, gen,
                              timed=False)]
        wkv_full = check_wkv6(FULL_WKV, 128, torch.float32, gen)
        ssd_full = check_ssd(FULL_SSD, 128, torch.float32, gen)
        wkv_rows += [wkv_full] + [
            check_wkv6(FULL_WKV, 128, torch.float32, gen, decay=d,
                       timed=False) for d in ("mild", "strong")]
        ssd_rows += [ssd_full] + [
            check_ssd(FULL_SSD, 128, torch.float32, gen, decay=d,
                      timed=False) for d in ("mild", "strong")]
        # ... at a rank's heads at TP 2 (phase 19d), timed; and, untimed,
        # at phase 19a's smoke configs' rank shapes
        wkv_rows.append(check_wkv6(TP_WKV, 128, torch.float32, gen))
        ssd_rows.append(check_ssd(TP_SSD, 128, torch.float32, gen))
        smoke_wkv, smoke_ssd = tp_smoke_scans()
        wkv_rows += [check_wkv6(sh, 8, torch.float32, gen, timed=False)
                     for sh in sorted(set(smoke_wkv))]
        ssd_rows += [check_ssd(sh, 8, torch.float32, gen, timed=False)
                     for sh in sorted(set(smoke_ssd))]
    checked = ({checked_key("goma_matmul", r) for r in b1_rows}
               | {checked_key("goma_fused_matmul", r) for r in b2_rows}
               | {checked_key("goma_combine", r) for r in combine_rows}
               | {checked_key("wkv6_scan", r) for r in wkv_rows}
               | {checked_key("ssd_scan", r) for r in ssd_rows})

    # every path runs with the launch counts set to 0 just before it; at
    # full width each records the shapes it launched every kernel at
    runs, shapes = {}, {}
    with phase("4 serve llama3-8b smoke on the card (B2)"):
        runs["serve llama3-8b smoke"] = serve_smoke(
            "llama3-8b", FULL["prompt_len"], ("goma_fused_matmul",),
            fused_mlp=True)
    with phase("5 serve llama3-8b at full width (B1)"):
        full = serve_full(FULL["arch"], FULL["prompt_len"], smi, out,
                          "profile_serve", checked, check_paths=False,
                          timed_runs=PHASE5_TIMED_RUNS, profile_decode=True,
                          fused_mlp=True)
        runs["serve llama3-8b full width"] = full["launches"]
        shapes["serve llama3-8b full width"] = full["shapes"]
    free_device()
    with phase("6 serve rwkv6-7b smoke on the card (B3)"):
        runs["serve rwkv6-7b smoke"] = serve_smoke(
            "rwkv6-7b", RECURRENT["smoke_prompt_len"], ("wkv6_scan",),
            use_pallas_scan=True)
    with phase("7 serve zamba2-2.7b smoke on the card (B4, B2)"):
        runs["serve zamba2-2.7b smoke"] = serve_smoke(
            "zamba2-2.7b", RECURRENT["smoke_prompt_len"],
            ("ssd_scan", "goma_fused_matmul"), use_pallas_scan=True,
            fused_mlp=True)
    with phase("8 serve rwkv6-7b at full width (B3)"):
        rwkv = serve_full("rwkv6-7b", RECURRENT["prompt_len"], smi, out,
                          "profile_serve_rwkv", checked, check_paths=True,
                          use_pallas_scan=True)
        runs["serve rwkv6-7b full width"] = rwkv["launches"]
        shapes["serve rwkv6-7b full width"] = rwkv["shapes"]
    free_device()
    with phase("9 serve zamba2-2.7b at full width (B4, B1)"):
        zamba = serve_full("zamba2-2.7b", RECURRENT["prompt_len"], smi, out,
                           "profile_serve_zamba2", checked, check_paths=True,
                           use_pallas_scan=True, fused_mlp=True)
        runs["serve zamba2-2.7b full width"] = zamba["launches"]
        shapes["serve zamba2-2.7b full width"] = zamba["shapes"]
    free_device()
    with phase("10 continuous scheduler on llama3-8b smoke on the card "
               "(B2)"):
        smoke = sched_smoke(checked)
        runs["scheduler llama3-8b smoke"] = smoke["launches"]
        shapes["scheduler llama3-8b smoke"] = smoke["shapes"]
    with phase("11 continuous scheduler on llama3-8b at full width (B1, "
               "goma_combine)"):
        sched = sched_full(smi, out, checked)
        runs["scheduler llama3-8b full width"] = sched["launches"]
        shapes["scheduler llama3-8b full width"] = sched["shapes"]
    free_device()
    with phase("12 the plan store: phase 10 and phase 11 served from it "
               "(B2; B1, goma_combine)"):
        smoke_store = sched_smoke_store(checked, smoke, stores / "smoke")
        runs["scheduler llama3-8b smoke, plan store"] = \
            smoke_store["launches"]
        shapes["scheduler llama3-8b smoke, plan store"] = \
            smoke_store["shapes"]
        store_full = sched_store_full(checked, sched, stores / "full")
        runs["scheduler llama3-8b full width, plan store"] = \
            store_full["launches"]
        shapes["scheduler llama3-8b full width, plan store"] = \
            store_full["shapes"]
    free_device()
    with phase("13 the MoE family: deepseek-moe-16b and granite smoke, "
               "deepseek-moe-16b at full width (no GOMA kernel)"):
        runs.update(moe_smoke())
        moe = moe_full(smi, out)
        runs["serve deepseek-moe-16b full width"] = moe["launches"]["static"]
        runs["scheduler deepseek-moe-16b full width"] = \
            moe["launches"]["scheduler"]
    free_device()
    with phase("14 scale-out: speculative decoding, the prefix cache and the "
               "replica router on llama3-8b (B2; B1, goma_combine)"):
        spec_smoke = scaleout_smoke(checked, stores / "scaleout_smoke")
        runs["scale-out llama3-8b smoke"] = spec_smoke["launches"]
        shapes["scale-out llama3-8b smoke"] = spec_smoke["shapes"]
        spec_full = scaleout_full(checked, stores / "scaleout_full")
        runs["router llama3-8b full width, spec and prefix cache"] = \
            spec_full["launches"]
        shapes["router llama3-8b full width, spec and prefix cache"] = \
            spec_full["shapes"]
    free_device()
    with phase("15 fidelity replay and calibration on the card (B1)"):
        fid = fidelity_phase(checked, gen, stores / "fidelity")
        runs["fidelity llama3-8b and zamba2-2.7b manifests"] = \
            fid["launches"]
        shapes["fidelity llama3-8b and zamba2-2.7b manifests"] = \
            fid["shapes"]
    free_device()
    with phase("16 capture-prewarmed serving: phase 11's deployment and a "
               "model-drafter fleet (B1, goma_combine; B2)"):
        cap_full = capture_sched_full(checked, sched, stores / "capture")
        runs["scheduler llama3-8b full width, capture prewarm"] = \
            cap_full["launches"]
        shapes["scheduler llama3-8b full width, capture prewarm"] = \
            cap_full["shapes"]
        cap_fleet = capture_fleet_smoke(checked, stores / "capture_fleet")
        runs["router llama3-8b smoke, model drafter, capture prewarm"] = \
            cap_fleet["launches"]
        shapes["router llama3-8b smoke, model drafter, capture prewarm"] = \
            cap_fleet["shapes"]
    free_device()
    with phase("17 the rest of the catalog: gemma2-27b (windows, softcaps), "
               "llava-next-34b and seamless-m4t-medium, smoke and full width "
               "(B2; B1, goma_combine)"):
        t0 = time.perf_counter()
        cat_smoke = catalog_smoke(checked)
        runs.update(cat_smoke["launches"])
        shapes.update(cat_smoke["shapes"])
        print(f"  smoke configs: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        gemma = gemma2_full(checked, stores / "gemma2", smi, out)
        runs["serve gemma2-27b full width"] = gemma["launches"]["static"]
        shapes["serve gemma2-27b full width"] = gemma["shapes"]["static"]
        runs["scheduler gemma2-27b full width"] = \
            gemma["launches"]["scheduler"]
        shapes["scheduler gemma2-27b full width"] = \
            gemma["shapes"]["scheduler"]
        print(f"  gemma2-27b at full width: {time.perf_counter() - t0:.1f} s")
        free_device()
        t0 = time.perf_counter()
        llava = llava_full(checked, smi, out)
        runs["serve llava-next-34b full width"] = llava["launches"]
        shapes["serve llava-next-34b full width"] = llava["shapes"]
        print(f"  llava-next-34b at full width: "
              f"{time.perf_counter() - t0:.1f} s")
        free_device()
        t0 = time.perf_counter()
        seamless = seamless_full(checked, smi, out)
        runs["serve seamless-m4t-medium full width"] = seamless["launches"]
        print(f"  seamless-m4t-medium at full width: "
              f"{time.perf_counter() - t0:.1f} s")
    free_device()
    with phase("18 tensor-parallel serving (B1 at the per-rank shapes): "
               "llama3-8b and deepseek-moe-16b smoke and llama3-8b at full "
               "width over 2 and 4 ranks (gloo on one card)"):
        tp = tp_serve(checked, stores / "tp")
        runs.update(tp["launches"])
        shapes.update(tp["shapes"])
    free_device()
    with phase("19 the rest of tensor-parallel serving: the recurrent, "
               "hybrid, encdec and vlm smoke configs, the scheduler and the "
               "router, phase 11's deployment at 4 layers at TP 2 (B1, "
               "goma_combine) and "
               "rwkv6-7b and zamba2-2.7b at full width at TP 2 (B3, B4 at a "
               "rank's heads; B1)"):
        tp_more = tp_rest(checked, stores / "tp_rest",
                          {"rwkv6-7b": rwkv, "zamba2-2.7b": zamba})
        runs.update(tp_more["launches"])
        shapes.update(tp_more["shapes"])
    free_device()
    with phase("20 training: every smoke config card == CPU and its loss "
               "through the kernels without grad (B2, B3, B4), stablelm-1.6b "
               "at full width (B1, goma_combine in the loss without grad), "
               "exact resume, data-parallel ranks"):
        train = training_phase(checked, gen, smi, out, stores / "ckpt")
        runs.update(train["launches"])
        shapes.update(train["shapes"])
    free_device()
    with phase("21 sharded training: FSDP and TP on (data, model) meshes of "
               "gloo ranks on the card, the smoke configs and stablelm-1.6b "
               "at full width (B2, B3, B4; B1, goma_combine in the loss "
               "without grad), reshard-on-load"):
        sharded = sharded_training(
            checked, smi, stores / "sharded",
            train["report"]["data_parallel"]["one_rank_losses"])
        runs.update(sharded["launches"])
        shapes.update(sharded["shapes"])
    free_device()
    with phase("22 the Hopper roofline against measured steps: phase 5's "
               "llama3-8b decode step and phase 20b's stablelm-1.6b train "
               "step, analyzed on meta tensors"):
        t0 = time.perf_counter()
        roof = roofline_phase(full["serve"]["decode_step"],
                              train["report"]["full"], smi, out)
        print(f"  phase 22: {time.perf_counter() - t0:.1f} s")
    free_device()
    with phase("23 the fused attention kernel: against its plain version "
               "and the walk, timed, and in stablelm-1.6b's 2 x 4096 "
               "training step"):
        attn = attention_phase(smi, out)
    free_device()
    with phase("24 the latent attention kernel: against its plain version "
               "and the products at dsv2lite.chat8k's decode and chunk "
               "shapes, graph replays bit for bit, timed"):
        mla = mla_phase(smi, out)

    b1 = next(r for r in b1_rows if r["shape"] == [4, 14336, 4096])
    b2 = next(r for r in b2_rows if r["shape"] == [4, 128, 64])
    comb = next(r for r in combine_rows if r["shape"] == [4, 14336])
    kernels = []
    for name, fn, row, path, src, replaces in (
            ("goma_matmul (B1)", "goma_matmul", b1,
             "serve llama3-8b full width", "goma_gemm.cu",
             "src/repro/kernels/goma_gemm.py:97"),
            ("goma_fused_matmul (B2)", "goma_fused_matmul", b2,
             "serve llama3-8b smoke", "goma_fused.cu",
             "src/repro/kernels/goma_fused.py:131"),
            ("goma_combine (B2's combine, between B1 links)",
             "goma_combine", comb, "serve llama3-8b full width",
             "goma_fused.cu", "src/repro/kernels/ops.py:102,156"),
            ("wkv6_scan (B3)", "wkv6_scan", wkv_full,
             "serve rwkv6-7b full width", "wkv6.cu",
             "src/repro/kernels/wkv6.py:78"),
            ("ssd_scan (B4)", "ssd_scan", ssd_full,
             "serve zamba2-2.7b full width", "mamba2_ssd.cu",
             "src/repro/kernels/mamba2_ssd.py:76")):
        extra = {k: row[k] for k in (
            ("slice_n", "ctas", "stages", "device_ms", "library_device_ms",
             "bound_share", "vs_library", "device_bound_share",
             "device_vs_library") if fn == "goma_matmul" else
            ("ctas", "smem_bytes", "ctas_per_sm", "device_ms",
             "cuda_core_bound_ms", "bound_share", "device_bound_share")
            if fn in ("wkv6_scan", "ssd_scan") else
            ("device_ms", "device_bound_share") if fn == "goma_combine"
            else ())}
        kernels.append({
            **extra,
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": runs[path][fn],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "dtype": row["dtype"], "path": path,
            "launches_by_path": {k: v[fn] for k, v in runs.items()
                                 if v[fn]},
            "shapes_by_path": {k: v[fn] for k, v in shapes.items()
                               if v[fn]}})
    t4k = next(r for r in attn["shapes"] if r["name"] == "train4k")
    kernels.append({
        "name": "fused_attention (attn_fwd, attn_dq, attn_dkdv)",
        "route": "cuda", "source": "src/repro_torch/kernels/csrc/attention.cu",
        "replaces": None, "launches": attn["train_step"]["counts"],
        "errors": t4k["errors"], "vs_fp64": t4k["vs_fp64"],
        **{k: t4k[k] for k in ("forward", "backward", "forward_backward")},
        "shape": t4k["shape"], "dtype": "bfloat16",
        "path": "stablelm-1.6b training, 2 x 4096"})
    kernels.append(mla_kernel_entry(mla))
    if out is not None:
        (out / "chip_smoke.json").write_text(json.dumps(
            {"device": smi, "mma": mma, "b1": b1_rows,
             "b1_tiling_independence": tiling, "b2": b2_rows,
             "combine": combine_rows, "wkv6": wkv_rows, "ssd": ssd_rows,
             "serve_full": full["serve"], "serve_rwkv": rwkv["serve"],
             "serve_zamba2": zamba["serve"], "scheduler": sched["serve"],
             "c7_row_independence": c7,
             "plan_store": {"smoke": smoke_store["store"],
                            "full_width": store_full["serve"]},
             "moe": moe["serve"],
             "scale_out": {"smoke": {k: spec_smoke[k] for k in (
                               "fleet_prewarm", "prefix_hits")},
                           "full_width": spec_full["serve"]},
             "fidelity": fid["fidelity"],
             "capture": {"full_width": cap_full["serve"],
                         "smoke_fleet": cap_fleet["serve"]},
             "catalog": {"gemma2-27b": gemma["serve"],
                         "llava-next-34b": llava["serve"],
                         "seamless-m4t-medium": seamless["serve"]},
             "tensor_parallel": tp["serve"],
             "tensor_parallel_rest": tp_more["serve"],
             "training": train["report"],
             "sharded_training": sharded["report"],
             "roofline": roof,
             "attention": attn,
             "mla_attention": mla,
             "launches": runs,
             "shapes": shapes,
             "kernels": kernels,
             "seconds": time.perf_counter() - t_start}, indent=1))
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
