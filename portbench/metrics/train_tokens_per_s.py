"""Tokens of the whole training steps completed in the window, over the
time from the window's start to the end of the last of them."""


def read(run):
    done = [(t, n) for t, n in run.steps if run.in_window(t)]
    if not done:
        return None
    return sum(n for _, n in done) / (done[-1][0] - run.window[0])
