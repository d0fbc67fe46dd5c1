"""Mean over the traced stretch's ticks that ran a prefill chunk of the
device busy time (the union of the kernels' intervals) of the kernels
launched inside ``sched.prefill_chunk``, in milliseconds."""
from portbench.harness import attrib


def read(run):
    got = attrib.device_ms_by(run.profile, run.profile_spans,
                              "sched.prefill_chunk", "sched.tick")
    return sum(got) / len(got) if got else None
