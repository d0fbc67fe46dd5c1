"""Share of the traced stretch of serving in which the card sat idle
while the innermost open port span was ``sched.prefill_chunk`` or
``sched.decode_batch``, or a span within one: the model step's own
host time, in percent."""
from portbench.harness import attrib

STEP = ("sched.prefill_chunk", "sched.decode_batch")


def read(run):
    got = attrib.idle_share(run.profile, run.profile_spans, STEP)
    return None if got is None else got[0]
