"""Window percentiles, rates and the readers of the end-to-end metrics,
against hand counts."""
import numpy as np
import pytest

from portbench.harness import spec, stats
from portbench.harness.run_record import Run


@pytest.mark.parametrize("q", [0, 50, 90, 95, 100])
def test_percentile_is_numpys_linear(q):
    xs = np.random.default_rng(1).exponential(size=37).tolist()
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    assert stats.percentile([], q) is None


def serve_run():
    # window [10, 20]; request 1 sent at 9, tokens at 9.5, 10.5, 12;
    # request 2 sent at 11, tokens at 13, 14, 21 (the last outside)
    return Run(cfg={}, traffic={}, window=(10.0, 20.0),
               setup_s=10.0, sends={1: 9.0, 2: 11.0},
               prompt_len={1: 4, 2: 8},
               tokens=[(9.5, 1), (10.5, 1), (12.0, 1), (13.0, 2),
                       (14.0, 2), (21.0, 2)])


def test_serving_readers_count_the_window_by_hand():
    run = serve_run()
    assert spec.reader("tokens_per_s")(run) == pytest.approx(4 / 10)
    # only request 2's first token falls in the window: 13 - 11
    assert spec.reader("ttft_p95_s")(run) == pytest.approx(2.0)
    # gaps whose second token is in the window: 1.0, 1.5, 1.0
    assert spec.reader("itl_p95_ms")(run) == pytest.approx(
        1e3 * np.percentile([1.0, 1.5, 1.0], 95))
    assert spec.reader("setup_s")(run) == 10.0


def test_train_readers_count_whole_steps_in_the_window():
    run = Run(cfg={}, traffic={}, window=(0.0, 10.0),
              setup_s=1.0, steps=[(3.0, 100), (6.5, 100), (10.5, 100)])
    assert spec.reader("train_tokens_per_s")(run) == pytest.approx(
        200 / 6.5)


def test_readers_with_nothing_to_read_return_none():
    run = Run(cfg={}, traffic={"sched": {"slots": 4}},
              window=(0.0, 1.0), setup_s=1.0)
    for name in ("sched.occupancy", "step.prefill_tick_ms", "mfu.serve",
                 "device_idle.serve", "gemm_roofline.decode",
                 "gemm_roofline.prefill", "train_tokens_per_s",
                 "mfu.train"):
        assert spec.reader(name)(run) is None
