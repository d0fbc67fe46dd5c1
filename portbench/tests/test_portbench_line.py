"""A whole run of each cell at smoke size on the CPU, the harness's look
for a card skipped: the shape of the last line, the metrics each kind of
run reports, and the command's refusals."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench.harness import result, serve, spec, train
from portbench.tests.tiny import tiny_cell

SEED = 2**31 + 17
CPU = {"platform": "cpu", "kind": "cpu", "count": 1}
# read only from a device trace, which a CPU run has not
DEVICE_ONLY = {"device_idle.serve", "device_idle.train",
               "gemm_roofline.decode", "gemm_roofline.prefill"}



@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the smoke runs are timed windows, and test
    workers that each spread over every core slow one another by far
    more than the work they share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def run_tiny(workload, trace, tmp_path, seed=SEED):
    cell = tiny_cell(workload)
    drv = serve if cell.traffic["kind"] == "serve" else train
    out = drv.run(cell, seed=seed, seconds=3.0, trace=trace, device="cpu",
                  t_start=time.perf_counter(), store_dir=tmp_path / "plans")
    return cell, out, result.line(cell, out, trace, CPU)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", ["yi34b.chat", "stablelm.train4k"])
def test_a_smoke_run_is_correct_and_its_line_has_the_contracts_shape(
        workload, trace, tmp_path):
    cell, out, line = run_tiny(workload, trace, tmp_path)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    assert set(line["metrics"]) == want - DEVICE_ONLY
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    json.dumps(line)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        e2e, layer = spec.cell_metrics(bench, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
        for m in layer:
            assert m["moves"] in names
        for m in e2e + layer:
            assert (spec.HERE / "metrics" / f"{m['name']}.py").exists()
        assert (spec.HERE / "limits" / f"{w['name']}.json").exists()


def command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "yi34b.chat",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=120, env=env)


def test_the_command_refuses_without_a_card_and_without_the_port(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = command(spec.ROOT, env)
    assert got.returncode != 0 and got.stdout == ""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(spec.ROOT / "BENCHMARK.json", alone)
    shutil.copytree(spec.HERE, alone / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    got = command(alone, env)
    assert got.returncode != 0 and got.stdout == ""
