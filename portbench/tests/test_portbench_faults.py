"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have (one chip: no exchange between
chips to leave out)."""
import time

import pytest
import torch

from portbench.harness import result, serve, train
from portbench.tests.tiny import tiny_cell

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

def run_tiny(workload, tmp_path):
    cell = tiny_cell(workload)
    drv = serve if cell.traffic["kind"] == "serve" else train
    out = drv.run(cell, seed=2**32 + 5, seconds=3.0, trace=False,
                  device="cpu", t_start=time.perf_counter(),
                  store_dir=tmp_path / "plans")
    return result.line(cell, out, False, CPU)


def altered_tokens(monkeypatch):
    """Each sampled token altered where the scheduler produces it."""
    from repro_torch.serving.sched.scheduler import ContinuousScheduler
    sample = ContinuousScheduler._sample_rows

    def altered(self, logits, keys):
        toks, finite = sample(self, logits, keys)
        return (toks + 1) % logits.shape[-1], finite
    monkeypatch.setattr(ContinuousScheduler, "_sample_rows", altered)


def unchanged_cache(monkeypatch):
    """A decode step that leaves its state, the KV cache, unchanged."""
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "write_rows", lambda cache, new, index:
                        None)


def unchanged_params(monkeypatch):
    """A train step that returns its state unchanged."""
    from repro_torch.training import optimizer as opt
    monkeypatch.setattr(opt, "apply_updates",
                        lambda params, grads, state, cfg, **kw:
                        (params, state, {}))


def half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from repro_torch.models.model import Model
    loss = Model.loss

    def half(self, params, batch, **kw):
        return loss(self, params, {k: v[:v.shape[0] // 2]
                                   for k, v in batch.items()}, **kw)
    monkeypatch.setattr(Model, "loss", half)


@pytest.mark.parametrize("workload,fault", [
    ("yi34b.chat", altered_tokens), ("yi34b.chat", unchanged_cache),
    ("stablelm.train4k", unchanged_params),
    ("stablelm.train4k", half_batch)])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch,
                                            tmp_path):
    fault(monkeypatch)
    line = run_tiny(workload, tmp_path)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
