"""Finding a cell's files by the names ``BENCHMARK.json`` gives.

A cell (a ``workloads`` entry) names a configuration and a traffic mix;
each lives in a file of its own under ``portbench/``, and so do the
limits of the cell's correctness comparison and the reader of every
metric.  Nothing here lists a cell, a configuration or a metric: a later
change adds files and entries and edits none.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parents[1]      # portbench/
ROOT = HERE.parent                                       # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]       # the metrics a --trace 0 run reports
    per_layer: list[dict]        # the metrics a --trace 1 run reports


def load_json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reports(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", (workload,))


def cell_metrics(bench: dict, workload: str) -> tuple[list, list]:
    """The end-to-end metrics a cell reports (those that list it, or
    name no cells), and its per-layer metrics: those that list it, or,
    without a list, every one whose ``moves`` metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def load_cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e, layer = cell_metrics(bench, workload)
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(root / cfg["file"]),
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{workload}.json"),
        end_to_end=e2e, per_layer=layer)


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
