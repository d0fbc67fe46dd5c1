"""The port's plan-fidelity replay and ERT calibration (obs/fidelity.py,
obs/calibrate.py) against the reference's, on the CPU.

The ranking and report code is the reference's own; ``_predict`` plans
for the H100 and, at the TPU's spec and padding, reproduces the
reference's prediction field for field; the replay runs the plain version
of B1 here, so no test gates on timing ranks (ROADMAP C8).  Row files
written by either package read in the other, and the calibration tests
of tests/test_pareto.py run against the port's copy."""
import dataclasses

import numpy as np
import pytest

from repro.obs import fidelity as ref_fid
from repro.core import tpu_mapping as ref_tm
from repro_torch.core import hopper_mapping as hm
from repro_torch.core.hardware import TEMPLATES, TPUV5E_LIKE
from repro_torch.obs import fidelity as fid
from repro_torch.planner import PlanStore, cli
from repro_torch.planner.manifest import ManifestEntry, ModelMappingManifest

EYE = TEMPLATES["eyeriss-like"]
SHAPES = [(128, 256, 256), (256, 512, 512), (512, 1024, 1024)]


@pytest.fixture(autouse=True)
def _no_store_left_behind():
    yield
    hm.set_plan_store(None)
    ref_tm.set_plan_store(None)


# ------------------------------------------------------------- ranking

def test_spearman_ranks_and_report_equal_the_reference():
    rng = np.random.default_rng(0)
    for n in (1, 2, 5, 17):
        x = rng.integers(0, 6, n).astype(float)      # ties on purpose
        y = rng.standard_normal(n)
        assert fid.spearman(x, y) == ref_fid.spearman(x, y)
        assert np.array_equal(fid._ranks(x), ref_fid._ranks(x))
    assert fid.spearman([1, 1, 1], [1, 2, 3]) == 0.0
    assert fid.spearman([2, 2], [7, 7]) == 1.0

    def rows(mod):
        r = np.random.default_rng(1)
        return [mod.FidelityRow(
            plan_key=f"k{i}", manifest_digest=f"m{i}",
            gemm_type=("mlp", "attn", "lm")[i % 3], dims=(8 * i + 8, 16, 32),
            weight=1, predicted_energy=float(r.integers(1, 9)),
            predicted_bytes_per_level={"dram": 1.0, "sram": 2.0, "rf": 3.0},
            measured_time_s=float(r.random())) for i in range(10)]

    a = fid._finalize_report(rows(fid), gate=0.9, min_family=3)
    b = ref_fid._finalize_report(rows(ref_fid), gate=0.9, min_family=3)
    assert a.summary() == b.summary()
    assert [r.to_json() for r in a.rows] == [r.to_json() for r in b.rows]


# ---------------------------------------------------------- prediction

@pytest.mark.parametrize("dtype_bytes", [4, 2])
def test_predict_at_the_tpu_spec_equals_the_reference(dtype_bytes):
    """At TPUV5E_LIKE and the MXU's padding the port's prediction is the
    reference's: the plan, energy, bytes per level and digest."""
    for M, N, K in SHAPES + [(8, 14336, 4096), (100, 300, 50)]:
        plan, energy, bpl, digest = fid._predict(
            M, N, K, dtype_bytes, spec=TPUV5E_LIKE, pad=hm.MXU)
        rplan, renergy, rbpl, rdigest = ref_fid._predict(M, N, K,
                                                         dtype_bytes)
        assert (plan.M, plan.N, plan.K, plan.padded, plan.block,
                plan.grid_order, plan.walk) == (
            rplan.M, rplan.N, rplan.K, rplan.padded, rplan.block,
            rplan.grid_order, rplan.walk)
        assert plan.objective == rplan.objective
        assert (energy, bpl, digest) == (renergy, rbpl, rdigest)


def test_predict_at_the_h100_is_the_dispatched_plan(tmp_path):
    """At the H100 (the default) the predicted plan is the one
    ``plan_gemm_tiling`` gives B1, and the digest is the key under which
    the installed store holds that plan."""
    store = PlanStore(tmp_path)
    hm.set_plan_store(store)
    for M, N, K in SHAPES + [(8, 14336, 4096), (128, 4096, 14336)]:
        for db in (4, 2):
            plan, energy, bpl, digest = fid._predict(M, N, K, db)
            assert plan == hm.plan_gemm_tiling(M, N, K, dtype_bytes=db)
            assert digest in {e.digest for e in store.entries()}
            entry = next(e for e in store.entries() if e.digest == digest)
            assert entry.gemm_dims == plan.padded
            assert energy > 0 and set(bpl) == set(fid.LEVELS)


# -------------------------------------------------------------- replay

def _manifest(model="t"):
    entries = [ManifestEntry(
        gemm_type="mlp", dims=d, weight=1, digest=f"e{i}", objective=0.0,
        feasible=True, solve_time_s=0.0, cached=False)
        for i, d in enumerate(SHAPES)]
    # an infeasible entry is skipped, a duplicate-dims entry reuses the
    # measurement under its own family
    entries.append(ManifestEntry(
        gemm_type="skip", dims=(8, 8, 8), weight=1, digest="bad",
        objective=0.0, feasible=False, solve_time_s=0.0, cached=False))
    entries.append(ManifestEntry(
        gemm_type="attn", dims=SHAPES[0], weight=3, digest="dup",
        objective=0.0, feasible=True, solve_time_s=0.0, cached=False))
    return ModelMappingManifest(
        model=model, hw_name="h100-like", objective="energy",
        prefill_seqs=(), decode_batches=(), cache_len=0, entries=entries)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_replay_records_rows_as_the_reference(tmp_path, dtype):
    """TestFidelity's replay on the plain version: 4 rows (3 + the
    duplicate, no infeasible one), the duplicate's measurement reused
    under its own family, the families and gated families of the
    reference, rows that round-trip; no gate on the timing ranks."""
    rep = fid.replay_manifest(_manifest(), dtype=dtype, repeats=2,
                              warmup=1, device="cpu", gate=0.9)
    assert len(rep.rows) == 4
    assert rep.rows[-1].measured_time_s == rep.rows[0].measured_time_s
    assert rep.rows[-1].plan_key == rep.rows[0].plan_key
    assert rep.rows[-1].gemm_type == "attn" and rep.rows[-1].weight == 3
    assert {r.gemm_type for r in rep.rows} == {"mlp", "attn"}
    assert all(np.isfinite(r.measured_rel_rank_error) for r in rep.rows)
    assert all(r.measured_time_s > 0 for r in rep.rows)
    assert "attn" in rep.families
    assert set(rep.gated_families) == {"all", "mlp"}
    db = 4 if dtype == "float32" else 2
    for r in rep.rows:
        _, energy, bpl, digest = fid._predict(*r.dims, db)
        assert (r.plan_key, r.predicted_energy,
                r.predicted_bytes_per_level) == (digest, energy, bpl)
    path = fid.record_rows(rep, tmp_path, "t")
    assert path == tmp_path / "fidelity" / "t.jsonl"
    summary, rows = fid.load_rows(path)
    assert summary["rows"] == 4 and summary["passes"] == rep.passes()
    assert [r.to_json() for r in rows] == [r.to_json() for r in rep.rows]


def test_replay_measures_each_dispatched_key_once(monkeypatch):
    """Distinct dims that pad to one H100 problem share one measurement:
    the timer runs once per dispatched plan key."""
    calls = []
    monkeypatch.setattr(fid, "_time_gemm",
                        lambda a, b, plan, **kw: calls.append(plan) or 1e-3)
    entries = [ManifestEntry(
        gemm_type="x", dims=(m, 64, 64), weight=1, digest=f"e{m}",
        objective=0.0, feasible=True, solve_time_s=0.0, cached=False)
        for m in (1, 8, 33, 64, 65)]
    man = dataclasses.replace(_manifest(), entries=entries)
    rep = fid.replay_manifest(man, device="cpu")
    assert len(rep.rows) == 5
    assert len(calls) == len({r.plan_key for r in rep.rows}) == 2


def test_row_files_read_in_either_package(tmp_path):
    rep = fid.replay_manifest(_manifest(), repeats=1, warmup=1,
                              device="cpu")
    path = fid.record_rows(rep, tmp_path / "port", "t")
    summary, rows = ref_fid.load_rows(path)
    assert summary == fid.load_rows(path)[0]
    assert [r.to_json() for r in rows] == [r.to_json() for r in rep.rows]
    ref_rows = [ref_fid.FidelityRow(**{**r.to_json(), "dims": tuple(r.dims)})
                for r in rows]
    ref_rep = ref_fid._finalize_report(ref_rows, gate=0.9, min_family=3)
    path = ref_fid.record_rows(ref_rep, tmp_path / "ref", "t")
    summary, rows = fid.load_rows(path)
    assert summary == ref_fid.load_rows(path)[0]
    assert [r.to_json() for r in rows] == [r.to_json()
                                           for r in ref_rep.rows]


# -------------------------------------------------------------------- CLI

def test_fidelity_cli_exit_code_is_the_gate(tmp_path, capsys):
    """``plan fidelity`` exits 1 exactly when its report fails the gate:
    an impossible gate (rho >= 2) fails, a trivial one (-1) passes; the
    rows land beside the store and ``plan stats`` reads them."""
    import json
    man = _manifest().save(tmp_path / "m.json")
    db = str(tmp_path / "db")
    for gate, want in (("2.0", 1), ("-1.0", 0)):
        out = tmp_path / f"rep{gate}.json"
        rc = cli.main(["fidelity", "--manifest", str(man), "--device",
                       "cpu", "--repeats", "1", "--warmup", "1", "--gate",
                       gate, "--store", db, "--out", str(out)])
        assert rc == want
        assert json.loads(out.read_text())["summary"]["passes"] is \
            (want == 0)
    assert cli.main(["stats", "--store", db]) == 0
    assert "[fidelity] t.jsonl: rows=4 passes=True" in \
        capsys.readouterr().out


def test_fidelity_cli_without_a_card_exits(tmp_path, monkeypatch):
    """Without --device cpu the replay runs on the card; with none it
    stops with an error that names --device cpu."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    man = _manifest().save(tmp_path / "m.json")
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["fidelity", "--manifest", str(man)])


# --------------------------------------------------------- calibration
# twins of tests/test_pareto.py's calibration gate, on the port's copy

def _synthetic_rows(n=18, ns_per_macc=0.002, ns_per_dram_byte=0.05):
    rows = []
    for i in range(n):
        M, N, K = 8 * (i + 1), 16, 32
        bpl = {"dram": 100.0 * (i + 1) ** 2, "sram": 10.0 * (i + 1),
               "rf": 5.0}
        t_ns = ns_per_macc * M * N * K + ns_per_dram_byte * bpl["dram"]
        rows.append(fid.FidelityRow(
            plan_key=f"k{i}", manifest_digest=f"m{i}", gemm_type="s",
            dims=(M, N, K), weight=1, predicted_energy=1.0,
            predicted_bytes_per_level=bpl, measured_time_s=t_ns * 1e-9))
    return rows


def test_calibration_beats_compute_only_baseline():
    from repro_torch.obs.calibrate import fit_rows
    rep = fit_rows(_synthetic_rows())
    assert rep.passes()
    assert rep.improvement > 0.5
    assert rep.model.ns_per_macc == pytest.approx(0.002, rel=1e-3)
    assert rep.model.ns_per_byte["dram"] == pytest.approx(0.05, rel=1e-3)
    assert rep.model.ns_per_byte["rf"] >= 0.0


def test_calibration_compute_only_data_does_not_regress():
    from repro_torch.obs.calibrate import fit_rows
    rep = fit_rows(_synthetic_rows(ns_per_dram_byte=0.0))
    assert rep.passes()
    assert rep.holdout_err <= rep.baseline_holdout_err + 1e-12


def test_calibration_bandwidth_and_persistence(tmp_path):
    from repro_torch.core.edp import evaluate
    from repro_torch.core.geometry import Gemm, Mapping
    from repro_torch.core.hardware import bandwidth_for
    from repro_torch.obs.calibrate import (calibrated_overrides, fit_rows,
                                           load_calibration,
                                           save_calibration)
    rep = fit_rows(_synthetic_rows())
    bw = rep.model.bandwidth(EYE.cycle_ns, dtype_bytes=2)
    assert bw.dram == pytest.approx(
        EYE.cycle_ns / (rep.model.ns_per_byte["dram"] * 2), rel=1e-9)
    assert bw.rf == float("inf")
    path = save_calibration(tmp_path, "cal", EYE.name, rep)
    models = load_calibration(path)
    assert models[EYE.name] == rep.model
    ov = calibrated_overrides(path,
                              cycle_ns_by_spec={EYE.name: EYE.cycle_ns})
    assert bandwidth_for(EYE, overrides=ov) == bw
    gemm = Gemm(64, 64, 64)
    m = Mapping((32, 32, 32), (16, 16, 1), (1, 1, 1), "z", "z")
    rep_cal = evaluate(gemm, m, EYE, bw=ov[EYE.name])
    assert rep_cal.delay_ns != evaluate(gemm, m, EYE).delay_ns


def test_calibration_needs_enough_rows():
    from repro_torch.obs.calibrate import fit_rows
    with pytest.raises(ValueError, match="rows"):
        fit_rows(_synthetic_rows(n=3))


def test_calibration_deterministic():
    from repro.obs.calibrate import fit_rows as ref_fit_rows
    from repro_torch.obs.calibrate import fit_rows
    a, b = fit_rows(_synthetic_rows()), fit_rows(_synthetic_rows())
    assert a.model == b.model and a.holdout_err == b.holdout_err
    ref = ref_fit_rows([ref_fid.FidelityRow(**dataclasses.asdict(r))
                        for r in _synthetic_rows()])
    assert a.summary() == ref.summary()
