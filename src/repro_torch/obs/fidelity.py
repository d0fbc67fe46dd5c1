"""Plan-fidelity recorder: predicted energy vs measured kernel time (the
counterpart of the reference's ``obs/fidelity.py``).

GOMA's objective is *analytically* exact, but whether stored plans
behave as predicted at runtime is an empirical question.  This module
closes that loop: it replays every shape of a
``ModelMappingManifest`` through the port's GEMM path
(``kernels.ops.gemm``, B1 on the card), times each dispatch
(warmup-discarded medians), and records one row per plan:

    {plan_key, predicted_energy, predicted_bytes_per_level,
     measured_time_s, measured_rel_rank_error}

The *prediction* is taken from the GOMA instance each shape actually
dispatches on the H100 (``core.hopper_mapping.gemm_problem`` + the
kernel's z-walk restriction), not the manifest's original accelerator —
the point is model-vs-silicon for the kernels that run, so predicted and
measured must describe the same execution.  Predicted energy is the
absolute breakdown total (pJ over the padded problem); predicted bytes
per level are the closed-form access counts (``core.energy``) scaled by
the dtype width.  With ``spec=TPUV5E_LIKE, pad=MXU`` the prediction is
the reference's, field for field.

The model predicts *energy*, the measurement is *time* — the two are
different physical quantities, so the fidelity claim is ordinal:
within a GEMM family, plans the model ranks as more expensive should
measure slower.  ``FidelityReport`` therefore gates on the Spearman
rank correlation between predicted energy and measured time, per
family (``gemm_type``) and overall; ``measured_rel_rank_error`` is
each row's normalized rank displacement within its family.

Rows are recorded beside the plan DB (``<root>/fidelity/<name>.jsonl``)
when a store root is given, in the reference's schema: a row file
written by either package reads in the other.

This module imports torch and the kernels and is deliberately NOT
re-exported by ``repro_torch.obs.__init__``; import
``repro_torch.obs.fidelity`` explicitly.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time

import numpy as np

LEVELS = ("dram", "sram", "rf")


# --------------------------------------------------------------- ranking
def _ranks(xs) -> np.ndarray:
    """Average-tie ranks (the standard Spearman convention)."""
    xs = np.asarray(xs, np.float64)
    order = np.argsort(xs, kind="mergesort")
    ranks = np.empty(xs.size, np.float64)
    ranks[order] = np.arange(xs.size, dtype=np.float64)
    vals, inv, counts = np.unique(xs, return_inverse=True,
                                  return_counts=True)
    sums = np.zeros(vals.size, np.float64)
    np.add.at(sums, inv, ranks)
    return (sums / counts)[inv]


def spearman(x, y) -> float:
    """Spearman rank correlation without scipy.

    Degenerate inputs: fewer than 2 points, or both sides constant,
    count as perfect agreement (1.0); one side constant while the other
    varies is undefined ordinally and scored 0.0 (conservative for a
    gate)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if x.size < 2:
        return 1.0
    rx, ry = _ranks(x), _ranks(y)
    sx, sy = float(rx.std()), float(ry.std())
    if sx == 0.0 and sy == 0.0:
        return 1.0
    if sx == 0.0 or sy == 0.0:
        return 0.0
    return float(np.corrcoef(rx, ry)[0, 1])


# ----------------------------------------------------------------- rows
@dataclasses.dataclass
class FidelityRow:
    """One plan's predicted-vs-measured record."""

    plan_key: str                    # TPU plan-store digest (dispatched)
    manifest_digest: str             # the manifest entry's own digest
    gemm_type: str
    dims: tuple[int, int, int]
    weight: int
    predicted_energy: float          # absolute pJ (padded problem)
    predicted_bytes_per_level: dict[str, float]
    measured_time_s: float           # warmup-discarded median
    measured_rel_rank_error: float = float("nan")   # filled per family

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["dims"] = list(self.dims)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "FidelityRow":
        d = dict(d)
        d["dims"] = tuple(d["dims"])
        return cls(**d)


@dataclasses.dataclass
class FidelityReport:
    """Replay outcome: rows plus per-family rank-correlation gates.

    ``families`` maps family name -> Spearman(predicted energy,
    measured time); families with fewer than ``min_family`` rows are
    reported but not gated (too few points for a meaningful ordering).
    ``"all"`` aggregates every row and is always gated."""

    rows: list[FidelityRow]
    families: dict[str, float]
    gated_families: dict[str, float]
    gate_threshold: float
    min_family: int = 3

    @property
    def overall(self) -> float:
        return self.families.get("all", float("nan"))

    def passes(self) -> bool:
        # epsilon guard: one adjacent swap over 5 rows is exactly
        # rho = 0.9, which np.corrcoef returns as 0.8999999...
        return all(rho >= self.gate_threshold - 1e-9
                   for rho in self.gated_families.values())

    def summary(self) -> dict:
        return {"rows": len(self.rows),
                "gate_threshold": self.gate_threshold,
                "passes": self.passes(),
                "families": {k: round(v, 4)
                             for k, v in sorted(self.families.items())},
                "gated_families": sorted(self.gated_families)}

    def to_json(self) -> dict:
        return {"summary": self.summary(),
                "rows": [r.to_json() for r in self.rows]}


def _finalize_report(rows: list[FidelityRow], *, gate: float,
                     min_family: int) -> FidelityReport:
    """Per-family Spearman + per-row rank displacement."""
    groups: dict[str, list[FidelityRow]] = {"all": list(rows)}
    for r in rows:
        groups.setdefault(r.gemm_type, []).append(r)
    families: dict[str, float] = {}
    gated: dict[str, float] = {}
    for fam, rs in groups.items():
        pred = [r.predicted_energy for r in rs]
        meas = [r.measured_time_s for r in rs]
        rho = spearman(pred, meas)
        families[fam] = rho
        if fam == "all" or len(rs) >= min_family:
            gated[fam] = rho
        if fam != "all" and len(rs) > 1:
            rp, rm = _ranks(pred), _ranks(meas)
            for r, dp in zip(rs, np.abs(rp - rm) / (len(rs) - 1)):
                r.measured_rel_rank_error = float(dp)
    # single-row families: displacement is trivially zero
    for r in rows:
        if np.isnan(r.measured_rel_rank_error):
            r.measured_rel_rank_error = 0.0
    return FidelityReport(rows=rows, families=families,
                          gated_families=gated, gate_threshold=gate,
                          min_family=min_family)


# --------------------------------------------------------------- replay
def _predict(M: int, N: int, K: int, dtype_bytes: int, *, spec=None,
             pad: int | None = None):
    """The dispatched plan plus its analytical prediction.

    Mirrors ``hopper_mapping.plan_gemm_tiling``'s solve (including the
    kernel's z-walk restriction) so the predicted mapping is the one B1
    executes; reads through the installed plan store when one is
    present, and the digest is the store's key of that solve.  ``spec``
    and ``pad`` default to the H100's (``H100_LIKE``, ``HOPPER_PAD``)."""
    from ..core.energy import analytical_energy
    from ..core.hopper_mapping import (H100_LIKE, HOPPER_PAD, _solve,
                                       gemm_problem, plan_from_mapping)
    from ..planner.store import plan_key

    gemm, hw, padded = gemm_problem(
        M, N, K, dtype_bytes=dtype_bytes,
        spec=H100_LIKE if spec is None else spec,
        pad=HOPPER_PAD if pad is None else pad)
    res = _solve(gemm, hw, None)
    walk = None
    m = res.mapping
    if m is None:
        raise ValueError(f"no feasible {hw.name} mapping for {gemm}")
    if m.alpha01 != "z" and m.L1[2] < padded[2]:
        walk = ("z",)
        res = _solve(gemm, hw, walk)
        m = res.mapping
    bd = analytical_energy(gemm, m, hw)
    counts = bd.counts.as_dict()
    bytes_per_level = {
        lvl: (counts[f"{lvl}_read"] + counts[f"{lvl}_write"]) * dtype_bytes
        for lvl in LEVELS}
    plan = plan_from_mapping(M, N, K, padded, m,
                             objective=res.certificate.objective,
                             solve_time_s=res.certificate.solve_time_s)
    digest = plan_key(gemm, hw, objective="energy",
                      allowed_walk01=walk).digest
    return plan, float(bd.total), bytes_per_level, digest


def _time_gemm(a, b, plan, *, repeats: int, warmup: int,
               estimator: str = "median") -> float:
    """Warmup-discarded timing of one dispatched plan, in seconds.

    On the card each call is timed by CUDA events recorded on the stream
    around it, the end event synchronized before the next call (the
    counterpart of the reference's ``block_until_ready``): the device
    time from the call's first launch to its last kernel's end, padding
    copies included, the host's Python before the first launch not.  On
    the CPU, ``time.perf_counter`` around the plain version.

    ``estimator="median"`` is the default (robust to stray slow
    repeats); ``"min"`` is the classic microbenchmark estimator —
    prefer it when the kernels are so small (tens of µs) that dispatch
    noise dominates the median and adjacent ranks jitter."""
    import torch

    from ..kernels.ops import gemm
    if estimator not in ("median", "min"):
        raise ValueError(f"unknown estimator {estimator!r}")
    cuda = a.device.type == "cuda"
    for _ in range(max(1, warmup)):
        gemm(a, b, plan=plan)
    if cuda:
        torch.cuda.synchronize(a.device)
    times = []
    for _ in range(max(1, repeats)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            gemm(a, b, plan=plan)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            gemm(a, b, plan=plan)
            times.append(time.perf_counter() - t0)
    times.sort()
    if estimator == "min":
        return times[0]
    n = len(times)
    return times[n // 2] if n % 2 else 0.5 * (times[n // 2 - 1]
                                              + times[n // 2])


def replay_manifest(manifest, *, dtype="float32", repeats: int = 5,
                    warmup: int = 2, device="cuda", seed: int = 0,
                    max_entries: int | None = None,
                    gate: float = 0.9, min_family: int = 3,
                    estimator: str = "median",
                    progress=None) -> FidelityReport:
    """Replay a manifest's plans through the port's GEMM kernel.

    ``dtype``: "float32" or "bfloat16".  Operands are drawn from a
    seeded numpy generator (as the reference draws them) and moved to
    ``device``: the card by default (B1), "cpu" for the plain version.
    ``max_entries`` caps the replay in manifest order.  ``progress`` is
    an optional ``callable(i, n, row)`` hook (CLI/bench reporting).

    Measurement is deduped by *dispatched plan key*: distinct manifest
    dims that pad to the same problem dispatch identical kernels, so
    they share one measurement and tie on both the predicted and
    measured side — ranking identical executions apart by timer noise
    would only corrupt the correlation the gate is about."""
    import torch

    torch_dtype = {"float32": torch.float32,
                   "bfloat16": torch.bfloat16}[str(dtype)]
    db = torch_dtype.itemsize
    rng = np.random.default_rng(seed)
    predicted: dict[tuple[int, int, int], tuple] = {}
    seen: dict[str, FidelityRow] = {}    # dispatched plan key -> row
    rows: list[FidelityRow] = []
    entries = [e for e in manifest.entries if e.feasible]
    if max_entries is not None:
        entries = entries[:max_entries]
    for i, entry in enumerate(entries):
        M, N, K = entry.dims
        if (M, N, K) not in predicted:
            predicted[(M, N, K)] = _predict(M, N, K, db)
        plan, energy, bpl, digest = predicted[(M, N, K)]
        prior = seen.get(digest)
        if prior is not None:
            # identical dispatched execution: reuse the measurement,
            # keep the row (family grouping is per gemm_type)
            row = dataclasses.replace(prior, manifest_digest=entry.digest,
                                      gemm_type=entry.gemm_type,
                                      dims=(M, N, K), weight=entry.weight)
        else:
            a = torch.from_numpy(rng.standard_normal((M, K))).to(
                device=device, dtype=torch_dtype)
            b = torch.from_numpy(rng.standard_normal((K, N))).to(
                device=device, dtype=torch_dtype)
            t = _time_gemm(a, b, plan, repeats=repeats, warmup=warmup,
                           estimator=estimator)
            row = FidelityRow(
                plan_key=digest, manifest_digest=entry.digest,
                gemm_type=entry.gemm_type, dims=(M, N, K),
                weight=entry.weight, predicted_energy=energy,
                predicted_bytes_per_level=bpl, measured_time_s=t)
            seen[digest] = row
        rows.append(row)
        if progress is not None:
            progress(i + 1, len(entries), row)
    return _finalize_report(rows, gate=gate, min_family=min_family)


# -------------------------------------------------------------- storage
def record_rows(report: FidelityReport, root, name: str) -> pathlib.Path:
    """Write the report's rows as JSONL beside the plan DB:
    ``<root>/fidelity/<name>.jsonl`` (summary as a leading comment-free
    header row with ``"kind": "summary"``)."""
    out_dir = pathlib.Path(root) / "fidelity"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.jsonl"
    with open(path, "w") as fh:
        fh.write(json.dumps({"kind": "summary", **report.summary()},
                            sort_keys=True) + "\n")
        for row in report.rows:
            fh.write(json.dumps({"kind": "row", **row.to_json()},
                                sort_keys=True) + "\n")
    return path


def load_rows(path) -> tuple[dict, list[FidelityRow]]:
    """Round-trip of ``record_rows``: (summary, rows)."""
    summary: dict = {}
    rows: list[FidelityRow] = []
    with open(path) as fh:
        for line in fh:
            obj = json.loads(line)
            kind = obj.pop("kind", "row")
            if kind == "summary":
                summary = obj
            else:
                rows.append(FidelityRow.from_json(obj))
    return summary, rows
