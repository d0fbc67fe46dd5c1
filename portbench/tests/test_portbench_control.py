"""The control comes out not correct: the reference in fp8 (the step
below the configurations' bf16), put in the program's place, read at a
size the CPU holds, against each cell's limits.  The same readings at
the cells' own sizes, on the card, are in PERF.md."""
import pytest
import torch

from portbench.harness import serve, spec
from portbench.harness import traffic as T
from portbench.harness import train as TR
from portbench.harness import weights as W
from portbench.reference import dense as R
from portbench.tests.tiny import tiny_config


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_fp8_control_fails_the_serving_gap(seed):
    cell = spec.load_cell("yi34b.chat")
    cfg = tiny_config("yi-34b")
    cfg.update(num_hidden_layers=4, hidden_size=128, head_dim=32,
               intermediate_size=512, vocab_size=1024)
    params = W.make(cfg, seed, "cpu", masters=False)
    tokens = torch.randint(0, 1024, (320,),
                           generator=torch.Generator().manual_seed(seed))
    rows = torch.arange(64, 320)
    ref, ctl = R.served_logits(params, R.Spec.of(cfg), [tokens], [rows],
                               control=True)
    assert max(serve.gaps(ref, [ctl[0].argmax(-1)])) > cell.limits["gap"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_fp8_control_fails_a_training_number(seed):
    cell = spec.load_cell("stablelm.train4k")
    cfg = tiny_config("stablelm-1.6b")
    job = dict(cell.traffic, batch=2, seq=64)
    p0 = W.make(cfg, seed, "cpu", masters=True)
    batches = [{k: torch.as_tensor(v) for k, v in T.train_rows(
        seed, i, 2, 64, cfg["vocab_size"]).items()} for i in range(3)]
    spec_ = R.Spec.of(cfg)
    ref = R.train(p0, batches, spec_, job)
    nums = TR.compare(R.train(p0, batches, spec_, job, fp8=True), ref)
    assert any(v > cell.limits[k] for k, v in nums.items()), nums
