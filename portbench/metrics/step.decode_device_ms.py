"""Mean over the traced stretch's ticks of the device busy time (the
union of the kernels' intervals) of the kernels launched inside
``sched.decode_batch``, in milliseconds."""
from portbench.harness import attrib


def read(run):
    got = attrib.device_ms_by(run.profile, run.profile_spans,
                              "sched.decode_batch", "sched.tick")
    return sum(got) / len(got) if got else None
