"""Mean number of kernels, copies and sets launched inside each
``sched.tick`` of the traced stretch."""
from portbench.harness import attrib


def read(run):
    got = attrib.launches_by(run.profile, run.profile_spans, "sched.tick")
    return sum(got) / len(got) if got else None
