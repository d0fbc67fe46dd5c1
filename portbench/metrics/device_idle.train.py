"""Share of the traced stretch of training (one step) in which no kernel ran on the
card, in percent."""


def read(run):
    p = run.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
