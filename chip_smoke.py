"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, serves the
``llama3-8b`` smoke config through the fused kernel (B2) and the full
``llama3-8b`` width through the GEMM kernel (B1), and checks the launch
counts.  Imports nothing of JAX and nothing of the reference package.

Output: one line per phase with its time; then the card's name and power
limit, a ``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.  With ``--out DIR`` the per-shape
kernel numbers also go to ``DIR/chip_smoke.json``, and one more
full-width ``generate`` runs under ``torch.profiler``: device time by
kernel and the device's busy and idle shares go to
``DIR/profile_serve.{json,txt}``.  Any failed phase
raises and ends the script with a non-zero code; without a CUDA card it
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs its plain version: the reference's kernel tolerances
# (tests/test_kernels.py), as rtol = atol; fp32 sums differ only in order,
# bf16 outputs may differ by one rounding of the output
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
FUSED_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# tests/test_kernels.py's MATRIX_SHAPES that need padding on some axis
ODD_SHAPES = [(300, 200, 100), (129, 257, 65), (100, 50, 1)]
FULL = dict(arch="llama3-8b", batch=4, prompt_len=16, new_tokens=8)
SEED = 0


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


def rand(shape, dtype, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


# --------------------------------------------------------------- phase 3
def check_b1(shape, dtype, gen, *, timed: bool) -> dict:
    """B1 against its plain version on padded operands under the H100
    plan; with ``timed``, also kernel, plain and torch.matmul times."""
    from repro_torch.core.hopper_mapping import plan_gemm_tiling
    from repro_torch.kernels.goma_gemm import goma_matmul, goma_matmul_plain
    M, N, K = shape
    plan = plan_gemm_tiling(M, N, K, dtype_bytes=dtype.itemsize)
    pm, pn, pk = plan.padded
    a = torch.zeros((pm, pk), dtype=dtype, device="cuda")
    a[:M, :K] = rand((M, K), dtype, gen)
    b = torch.zeros((pk, pn), dtype=dtype, device="cuda")
    b[:K, :N] = rand((K, N), dtype, gen, K ** -0.5)
    got = goma_matmul(a, b, plan)
    want = goma_matmul_plain(a, b, plan)
    torch.cuda.synchronize()
    row = {"shape": [M, N, K], "padded": [pm, pn, pk],
           "block": list(plan.block), "grid_order": "".join(plan.grid_order),
           "dtype": str(dtype).removeprefix("torch."),
           "max_abs_err": close(got, want, TOL[dtype])}
    if timed:
        # the work the product needs: the unpadded operands and flops
        nbytes = (M * K + K * N + M * N) * dtype.itemsize
        bound, by = bound_ms(nbytes, 2 * M * N * K, dtype)
        row.update(
            ms=time_ms(lambda: goma_matmul(a, b, plan)),
            plain_ms=time_ms(lambda: goma_matmul_plain(a, b, plan)),
            library_ms=time_ms(lambda: torch.matmul(a, b)),
            bound_ms=bound, bound_by=by)
    return row


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
           "dtype": str(dtype).removeprefix("torch."),
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
    row = {"shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
           "max_abs_err": close(got, want, TOL[dtype])}
    if timed:
        n = g.numel()
        bound, by = bound_ms(3 * n * dtype.itemsize, COMBINE_OPS * n, dtype)
        row.update(
            ms=time_ms(lambda: goma_combine(g, u)),
            plain_ms=time_ms(lambda: goma_combine_plain(g, u, "silu_mul")),
            library_ms=None, bound_ms=bound, bound_by=by)
    return row


# ------------------------------------------------------------ phases 4-5
def reset_launches() -> None:
    from repro_torch.kernels import goma_combine, goma_fused_matmul
    from repro_torch.kernels import goma_matmul
    for fn in (goma_matmul, goma_fused_matmul, goma_combine):
        fn.launches = 0


def serve_smoke() -> dict:
    """llama3-8b smoke, fused MLP, fp32: one set of weights made on the
    CPU; greedy tokens on the card (kernels) equal those on the CPU (plain
    versions)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import goma_fused_matmul
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_to
    from repro_torch.serving import Engine, ServeConfig
    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                              fused_mlp=True)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(SEED), "cpu")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (FULL["batch"], FULL["prompt_len"])).astype(np.int32)
    scfg = ServeConfig(max_new_tokens=FULL["new_tokens"], cache_len=32)
    cpu_tokens = Engine(model, params, scfg).generate(prompts)
    card = Engine(model, tree_to(params, "cuda"), scfg)
    reset_launches()
    card_tokens = card.generate(prompts)
    launches = goma_fused_matmul.launches
    if launches <= 0:
        raise AssertionError("the smoke run never launched B2")
    if not np.array_equal(card_tokens, cpu_tokens):
        raise AssertionError(f"card tokens {card_tokens.tolist()} != CPU "
                             f"tokens {cpu_tokens.tolist()}")
    print(f"  smoke tokens (card == cpu): {card_tokens.tolist()}")
    print(f"  B2 launches: {launches}")
    return {"goma_fused_matmul": launches}


def serve_full(smi: str, out: pathlib.Path | None) -> dict:
    """llama3-8b at its published widths, 32 layers, bf16, fused MLP on,
    random weights made on the card: every MLP goes through B1, with
    goma_combine between the links.  With ``out``, one more generate runs
    under the profiler."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import goma_combine, goma_matmul
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, ServeConfig
    cfg = dataclasses.replace(get_config(FULL["arch"]), fused_mlp=True)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    finite = []
    lm_logits = model._lm_logits

    def checked_logits(p, x):
        out = lm_logits(p, x)
        finite.append(torch.isfinite(out).all())
        return out

    model._lm_logits = checked_logits
    B, S, new = FULL["batch"], FULL["prompt_len"], FULL["new_tokens"]
    eng = Engine(model, params, ServeConfig(max_new_tokens=new,
                                            cache_len=S + new + 8))
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    reset_launches()
    tokens = eng.generate(prompts)
    launches = goma_matmul.launches
    combines = goma_combine.launches
    passes = len(finite)
    if tokens.shape != (B, new) or not ((tokens >= 0)
                                        & (tokens < cfg.vocab)).all():
        raise AssertionError(f"bad tokens {tokens.tolist()}")
    if not all(bool(f) for f in finite):
        raise AssertionError("non-finite logits at full width")
    want = 3 * cfg.layers * passes
    if launches != want:
        raise AssertionError(f"B1 launches {launches} != 3 x {cfg.layers} "
                             f"layers x {passes} forward passes = {want}")
    if combines != cfg.layers * passes:
        raise AssertionError(f"goma_combine launches {combines} != "
                             f"{cfg.layers} layers x {passes} passes")
    # a second run, timed, once every plan is cached
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = eng.generate(prompts)
    dt = time.perf_counter() - t0
    if not np.array_equal(again, tokens):
        raise AssertionError("a second greedy run gave other tokens")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  tokens: {tokens.tolist()}")
    print(f"  forward passes {passes}, B1 launches {launches} "
          f"(= 3 x {cfg.layers} x {passes}), goma_combine launches "
          f"{combines}")
    print(f"  generate: {B * new / dt} tokens/s "
          f"({dt} s for {B}x{new} tokens), peak memory {peak} GiB")
    if out is not None:
        profile_generate(eng, prompts, smi, out)
    return {"goma_matmul": launches, "goma_combine": combines,
            "serve": {"tokens_per_s": B * new / dt, "seconds": dt,
                      "forward_passes": passes,
                      "peak_memory_gib": peak}}


def profile_generate(eng, prompts, smi: str, out: pathlib.Path) -> None:
    """One more generate under torch.profiler: device time by kernel,
    the device's busy and idle shares of the wall time, and the GOMA
    kernels' share, to out/profile_serve.{json,txt}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts)
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
    goma = sum(r["device_ms"] for r in rows if "goma_" in r["name"])
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    summary = {"device": smi, "wall_ms": wall_ms, "device_busy_ms": busy,
               "device_busy_share": busy / wall_ms,
               "device_idle_share": 1 - busy / wall_ms,
               "goma_kernels_ms": goma, "goma_share_of_busy": goma / busy,
               "top": rows[:20]}
    (out / "profile_serve.json").write_text(json.dumps(summary, indent=1))
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=25)
    (out / "profile_serve.txt").write_text(f"{smi}\n{table}\n")
    print(f"  profiled generate: wall {wall_ms} ms, device busy {busy} ms "
          f"(share {busy / wall_ms}), GOMA kernels {goma} ms")
    for r in rows[:8]:
        print(f"    {r['device_ms']:10.3f} ms {r['calls']:6d}  "
              f"{r['name'][:80]}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json (per-shape rows)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on "
                 "the card")
    out = pathlib.Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    from repro_torch.kernels import _build
    t_start = time.perf_counter()

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

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b1_rows, b2_rows, combine_rows = [], [], []
    with phase("3 kernels vs plain versions"):
        for dtype in (torch.float32, torch.bfloat16):
            for shape in ODD_SHAPES:
                b1_rows.append(check_b1(shape, dtype, gen, timed=False))
        for M in (4, 64):
            for N, K in ((14336, 4096), (4096, 14336)):
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
        for M in (4, 64):   # the smoke chain at decode and prefill
            b2_rows.append(check_b2(M, 128, 64, torch.float32, gen,
                                    timed=True))
        # the composition's combine: an odd fp32 shape, and the full-width
        # decode and prefill MLP strips
        combine_rows.append(check_combine((129, 257), torch.float32, gen,
                                          timed=False))
        for M in (4, 64):
            combine_rows.append(check_combine((M, 14336), torch.bfloat16,
                                              gen, timed=True))
        for r in b1_rows + b2_rows + combine_rows:
            print("  " + json.dumps(r))

    with phase("4 serve llama3-8b smoke on the card (B2)"):
        smoke = serve_smoke()
    with phase("5 serve llama3-8b at full width (B1)"):
        full = serve_full(smi, out)

    b1 = next(r for r in b1_rows if r["shape"] == [4, 14336, 4096])
    b2 = next(r for r in b2_rows if r["shape"] == [4, 128, 64])
    comb = next(r for r in combine_rows if r["shape"] == [4, 14336])
    kernels = []
    for name, row, launches, src, replaces, path in (
            ("goma_matmul (B1)", b1, full["goma_matmul"],
             "src/repro_torch/kernels/csrc/goma_gemm.cu",
             "src/repro/kernels/goma_gemm.py:97",
             "serve llama3-8b full width"),
            ("goma_fused_matmul (B2)", b2, smoke["goma_fused_matmul"],
             "src/repro_torch/kernels/csrc/goma_fused.cu",
             "src/repro/kernels/goma_fused.py:131",
             "serve llama3-8b smoke"),
            ("goma_combine (B2's combine, between B1 links)", comb,
             full["goma_combine"],
             "src/repro_torch/kernels/csrc/goma_fused.cu",
             "src/repro/kernels/goma_fused.py:66",
             "serve llama3-8b full width")):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "dtype": row["dtype"], "path": path})
    if out is not None:
        (out / "chip_smoke.json").write_text(json.dumps(
            {"device": smi, "b1": b1_rows, "b2": b2_rows,
             "combine": combine_rows,
             "serve_full": full["serve"], "kernels": kernels,
             "seconds": time.perf_counter() - t_start}, indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
