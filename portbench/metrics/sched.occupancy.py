"""Mean over the window's scheduler ticks of the decode rows active over
the slots, in percent (the ``active`` the port's ``sched.tick`` span
records)."""


def read(run):
    if not run.spans:
        return None
    ticks = [s for s in run.spans if s.name == "sched.tick"]
    if not ticks:
        return None
    slots = run.traffic["sched"]["slots"]
    return 100.0 * sum(s.attrs["active"] for s in ticks) / (
        len(ticks) * slots)
