"""B1 (``goma_matmul``) and ``goma_combine`` in the decode ticks of the
traced stretch: their least time over their device time, in percent."""
from portbench.harness.kernels import roofline_share


def read(run):
    return roofline_share(run, "sched.decode_batch")
