"""95th percentile of time to first token over every request whose
first token reached the host inside the window, each timed from the
moment its client sent it."""
from portbench.harness.stats import percentile


def read(run):
    first = {}
    for t, rid in run.tokens:
        first.setdefault(rid, t)
    return percentile([t - run.sends[rid] for rid, t in first.items()
                       if run.in_window(t)], 95)
