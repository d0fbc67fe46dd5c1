"""Output tokens that reached the host inside the window, over the
window's seconds."""


def read(run):
    n = sum(1 for t, _ in run.tokens if run.in_window(t))
    return n / run.seconds
