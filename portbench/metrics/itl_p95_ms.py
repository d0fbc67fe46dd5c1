"""95th percentile of every gap between two consecutive tokens of one
request whose second token reached the host inside the window, across
all requests, in milliseconds."""
from portbench.harness.stats import percentile


def read(run):
    last, gaps = {}, []
    for t, rid in run.tokens:
        if rid in last and run.in_window(t):
            gaps.append(t - last[rid])
        last[rid] = t
    p = percentile(gaps, 95)
    return None if p is None else 1e3 * p
