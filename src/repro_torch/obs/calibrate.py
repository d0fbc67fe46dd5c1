"""ERT/bandwidth calibration from recorded plan-fidelity rows.

The latency model in ``core.edp`` prices a mapping as the roofline max
of a compute term and per-level traffic terms; its bandwidth table
(``core.hardware.BANDWIDTHS``) ships with nominal values.  This module
closes the empirical loop: given the ``FidelityRow`` records that
``obs.fidelity.replay_manifest`` leaves beside the plan DB (predicted
bytes per level + measured kernel time), it fits per-level time
coefficients by least squares and turns them into a calibrated
``Bandwidth`` entry.

Model (additive surrogate of the roofline — a sum upper-bounds a max and
stays linear in the unknowns, so ordinary least squares applies):

    t_ns  ~=  ns_per_macc * V  +  sum_lvl ns_per_byte[lvl] * bytes[lvl]

Coefficients are clamped to be non-negative (a negative rate is
unphysical) by drop-and-refit: fit, drop the most negative column,
refit, until all survivors are non-negative.

The *gate* is a held-out prediction-error regression test: rows are
split deterministically (every ``holdout_every``-th row held out), the
calibrated model must not predict held-out times worse than the
compute-only baseline ``t ~= beta * V`` (the single-coefficient
least-squares fit, i.e. what the pre-calibration compute-bound delay
model amounts to).  ``plan calibrate`` and ``bench_pareto`` exit
non-zero when the gate fails.

Numpy-only on purpose — no jax import, so the CI gate runs wherever the
planner does.  Calibrations persist beside the plan DB under
``<root>/calibration/<name>.json``, keyed by spec name so
``bandwidth_for(hw, overrides=load_calibration(...))`` picks them up.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Sequence

import numpy as np

from .fidelity import LEVELS, FidelityRow

_FEATURES = ("macc",) + LEVELS


def row_features(row: FidelityRow) -> np.ndarray:
    """[V, bytes_dram, bytes_sram, bytes_rf] for one fidelity row."""
    M, N, K = row.dims
    bpl = row.predicted_bytes_per_level
    return np.array([float(M) * N * K] + [float(bpl[lvl]) for lvl in LEVELS],
                    np.float64)


@dataclasses.dataclass(frozen=True)
class CalibrationModel:
    """Fitted per-level time rates (all non-negative).

    ``ns_per_byte[lvl] == 0`` means the fit attributed no time to that
    level (it was never the bottleneck in the data) — the derived
    bandwidth is infinite there."""

    ns_per_macc: float
    ns_per_byte: dict[str, float]          # keyed by LEVELS

    def predict_ns(self, row: FidelityRow) -> float:
        f = row_features(row)
        coef = np.array([self.ns_per_macc]
                        + [self.ns_per_byte[lvl] for lvl in LEVELS])
        return float(f @ coef)

    def bandwidth(self, cycle_ns: float, *, dtype_bytes: int = 2):
        """Calibrated ``core.hardware.Bandwidth`` (words/cycle).

        A fitted rate of ``ns_per_byte`` ns/byte is
        ``cycle_ns / (ns_per_byte * dtype_bytes)`` words per cycle.
        Note the rf entry is *aggregate* words/cycle here (the fidelity
        bytes are whole-array totals), whereas the roofline's rf term is
        per-PE — install via ``bandwidth_for(hw, overrides=...)`` with
        that in mind."""
        from ..core.hardware import Bandwidth

        def words_per_cycle(npb: float) -> float:
            return (cycle_ns / (npb * dtype_bytes)) if npb > 0.0 \
                else float("inf")

        return Bandwidth(dram=words_per_cycle(self.ns_per_byte["dram"]),
                         sram=words_per_cycle(self.ns_per_byte["sram"]),
                         rf=words_per_cycle(self.ns_per_byte["rf"]))

    def to_json(self) -> dict:
        return {"ns_per_macc": self.ns_per_macc,
                "ns_per_byte": dict(self.ns_per_byte)}

    @classmethod
    def from_json(cls, d: dict) -> "CalibrationModel":
        return cls(ns_per_macc=float(d["ns_per_macc"]),
                   ns_per_byte={lvl: float(d["ns_per_byte"][lvl])
                                for lvl in LEVELS})


@dataclasses.dataclass
class CalibrationReport:
    """Fit outcome plus the held-out regression gate."""

    model: CalibrationModel
    baseline_ns_per_macc: float       # compute-only single-coefficient fit
    train_err: float                  # mean |rel err| on the train split
    holdout_err: float                # mean |rel err|, calibrated, held out
    baseline_holdout_err: float       # mean |rel err|, baseline, held out
    n_train: int
    n_holdout: int

    @property
    def improvement(self) -> float:
        """Relative held-out error reduction vs the compute-only model
        (positive = calibration helps)."""
        if self.baseline_holdout_err == 0.0:
            return 0.0
        return 1.0 - self.holdout_err / self.baseline_holdout_err

    def passes(self) -> bool:
        return self.holdout_err <= self.baseline_holdout_err * (1 + 1e-9)

    def summary(self) -> dict:
        return {"passes": self.passes(),
                "improvement": round(self.improvement, 4),
                "train_err": round(self.train_err, 6),
                "holdout_err": round(self.holdout_err, 6),
                "baseline_holdout_err": round(self.baseline_holdout_err, 6),
                "n_train": self.n_train, "n_holdout": self.n_holdout,
                "model": self.model.to_json()}


def _nonneg_lstsq(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Least squares with non-negative coefficients by drop-and-refit:
    fit all active columns, zero out the most negative one, repeat."""
    n_feat = X.shape[1]
    active = list(range(n_feat))
    coef = np.zeros(n_feat)
    while active:
        sub, *_ = np.linalg.lstsq(X[:, active], y, rcond=None)
        if (sub >= 0.0).all():
            coef[:] = 0.0
            coef[active] = sub
            return coef
        active.pop(int(np.argmin(sub)))
    return coef


def _rel_err(pred: np.ndarray, y: np.ndarray) -> float:
    mask = y > 0.0
    if not mask.any():
        return 0.0
    return float(np.mean(np.abs(pred[mask] - y[mask]) / y[mask]))


def fit_rows(rows: Sequence[FidelityRow], *,
             holdout_every: int = 3) -> CalibrationReport:
    """Fit a ``CalibrationModel`` with a deterministic held-out split.

    Every ``holdout_every``-th row (indices 2, 5, 8, ... for the default
    3) is held out of the fit and used only for the regression gate; the
    split is positional, so re-running on the same JSONL reproduces the
    same report bit-for-bit."""
    rows = [r for r in rows if r.measured_time_s > 0.0]
    if len(rows) < 2 * max(2, holdout_every):
        raise ValueError(f"need at least {2 * max(2, holdout_every)} "
                         f"usable rows to calibrate, got {len(rows)}")
    X = np.stack([row_features(r) for r in rows])
    y = np.array([r.measured_time_s * 1e9 for r in rows])   # ns
    idx = np.arange(len(rows))
    hold = (idx % holdout_every) == (holdout_every - 1)
    Xt, yt, Xh, yh = X[~hold], y[~hold], X[hold], y[hold]

    coef = _nonneg_lstsq(Xt, yt)
    model = CalibrationModel(
        ns_per_macc=float(coef[0]),
        ns_per_byte={lvl: float(coef[1 + i])
                     for i, lvl in enumerate(LEVELS)})

    # compute-only baseline: t ~= beta * V, beta the 1-D least squares
    v = Xt[:, 0]
    beta = float(max(0.0, (yt @ v) / (v @ v))) if (v @ v) > 0.0 else 0.0

    return CalibrationReport(
        model=model, baseline_ns_per_macc=beta,
        train_err=_rel_err(Xt @ coef, yt),
        holdout_err=_rel_err(Xh @ coef, yh),
        baseline_holdout_err=_rel_err(Xh[:, 0] * beta, yh),
        n_train=int((~hold).sum()), n_holdout=int(hold.sum()))


def fit_jsonl(path, *, holdout_every: int = 3) -> CalibrationReport:
    """Fit from a ``record_rows`` JSONL artifact."""
    from .fidelity import load_rows
    _, rows = load_rows(path)
    return fit_rows(rows, holdout_every=holdout_every)


# -------------------------------------------------------------- storage
def save_calibration(root, name: str, spec_name: str,
                     report: CalibrationReport) -> pathlib.Path:
    """Persist beside the plan DB: ``<root>/calibration/<name>.json``,
    a spec-name-keyed map so one file can hold several accelerators'
    calibrations (later saves merge)."""
    out_dir = pathlib.Path(root) / "calibration"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.json"
    blob: dict = {}
    if path.exists():
        with open(path) as fh:
            blob = json.load(fh)
    blob[spec_name] = report.summary()
    with open(path, "w") as fh:
        json.dump(blob, fh, indent=1, sort_keys=True)
    return path


def load_calibration(path) -> dict[str, CalibrationModel]:
    """Spec-name -> fitted model map (round-trip of save_calibration)."""
    with open(path) as fh:
        blob = json.load(fh)
    return {spec: CalibrationModel.from_json(d["model"])
            for spec, d in blob.items()}


def calibrated_overrides(path, *, cycle_ns_by_spec: dict[str, float],
                         dtype_bytes: int = 2):
    """``bandwidth_for`` overrides dict from a saved calibration file:
    spec name -> calibrated ``Bandwidth`` (specs without a recorded
    cycle time are skipped)."""
    models = load_calibration(path)
    return {spec: m.bandwidth(cycle_ns_by_spec[spec],
                              dtype_bytes=dtype_bytes)
            for spec, m in models.items() if spec in cycle_ns_by_spec}
