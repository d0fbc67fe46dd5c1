"""Device busy time (the union of the kernels' intervals) of the kernels
launched inside ``train.optimizer`` in the profiled training step, in
milliseconds."""
from portbench.harness import attrib


def read(run):
    got = attrib.device_ms_by(run.profile, run.profile_spans,
                              "train.optimizer", "train.step")
    return sum(got) / len(got) if got else None
