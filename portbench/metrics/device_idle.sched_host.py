"""Share of the traced stretch of serving in which the card sat idle at
any other time than the model step's (``device_idle.step_host``): the
scheduler's bookkeeping, admission, emit, and between ticks, in
percent."""
from portbench.harness import attrib

STEP = ("sched.prefill_chunk", "sched.decode_batch")


def read(run):
    got = attrib.idle_share(run.profile, run.profile_spans, STEP)
    return None if got is None else got[1]
