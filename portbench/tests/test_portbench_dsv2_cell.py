"""A whole run of the dsv2lite cell at smoke size on the CPU, through its
own driver (``harness/serve_mla.py``): the shape of the last line, the
metrics each kind of run reports, the capture prewarm, and a run with the
timed path broken underneath coming out not correct, once for each
fault the cell can have."""
import json
import time

import pytest
import torch

from portbench.harness import result, serve_mla
from portbench.tests.tiny_mla import tiny_cell

SEED = 2**31 + 29
CPU = {"platform": "cpu", "kind": "cpu", "count": 1}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the smoke runs are timed windows, and test
    workers that each spread over every core slow one another by far
    more than the work they share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_tiny(trace, tmp_path, seed=SEED, seconds=3.0):
    cell = tiny_cell()
    out = serve_mla.run(cell, seed=seed, seconds=seconds, trace=trace,
                        device="cpu", t_start=time.perf_counter(),
                        store_dir=tmp_path / "plans")
    return cell, out, result.line(cell, out, trace, CPU)


@pytest.mark.parametrize("trace", [False, True])
def test_a_smoke_run_is_correct_and_its_line_has_the_contracts_shape(
        trace, tmp_path):
    from repro_torch.obs.registry import get_registry
    get_registry().reset()
    cell, out, line = run_tiny(trace, tmp_path)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    assert set(line["metrics"]) == want
    assert want >= ({"mfu.serve_dsv2lite", "moe.max_load"} if trace
                    else {"tokens_per_s", "setup_s"})
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    if trace:
        assert line["metrics"]["moe.max_load"]["value"] >= 1.0
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    json.dumps(line)
    # the capture prewarm traced the model; every layer ran latent
    # attention and the experts without a drop
    reg = get_registry()
    assert reg.get("sched.prewarm_failures") == 0
    assert reg.get("attn.mla") > 0 and reg.get("attn.walk") == 0
    calls = reg.get("moe.dropless.calls")
    assert calls > 0 and reg.get("moe.rows_routed") >= 3 * calls


def stale_latent_row(monkeypatch):
    """Each decode step writes its latents one position late, so the
    latent-cache row at the step's own position stays stale."""
    from repro_torch.models import layers
    write = layers.write_rows
    monkeypatch.setattr(layers, "write_rows", lambda cache, new, index:
                        write(cache, new, index + 1))


def dropped_routed_row(monkeypatch):
    """One routed row of every token dropped: its first choice's expert
    output weighs nothing."""
    from repro_torch.models import moe
    combine = moe.combine_choices

    def drop(ys, order, top_w):
        return combine(ys, order, torch.cat(
            [torch.zeros_like(top_w[:, :1]), top_w[:, 1:]], 1))
    monkeypatch.setattr(moe, "combine_choices", drop)


def renormalised_top_k(monkeypatch):
    """The top-k weights renormalised to sum to one, as the published
    model does not."""
    arch = serve_mla.arch_config
    monkeypatch.setattr(serve_mla, "arch_config",
                        lambda cfg: arch(cfg).replace(norm_topk_prob=True))


@pytest.mark.parametrize("fault", [stale_latent_row, dropped_routed_row,
                                   renormalised_top_k])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch, tmp_path):
    """A window long enough that the check judges its 32 requests even on
    a loaded CPU."""
    fault(monkeypatch)
    _, _, line = run_tiny(False, tmp_path, seed=2**32 + 5, seconds=8.0)
    assert line["compared"]["requests"] == 32
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
