"""Model flops of the training steps completed in the window (forward
and backward, causal attention, no recomputation) over the time to the
last of them at the card's bf16 peak, in percent."""
from portbench.harness import work


def read(run):
    done = [t for t, _ in run.steps if run.in_window(t)]
    if not done:
        return None
    job = run.traffic
    flops = len(done) * work.train_step_flops(run.cfg, job["batch"],
                                              job["seq"])
    return 100.0 * flops / ((done[-1] - run.window[0])
                            * work.PEAK_FLOPS["bfloat16"])
