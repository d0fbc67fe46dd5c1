"""Seconds the scheduler's constructor took, which prewarms every plan
of the deployment through the plan store (host clock)."""


def read(run):
    return run.prewarm_s
