"""Mean duration of the window's ``sched.tick`` spans that ran at least
one prefill chunk, in milliseconds."""


def read(run):
    if not run.spans:
        return None
    d = [s.duration for s in run.spans if s.name == "sched.tick"
         and s.attrs.get("chunks", 0) > 0]
    return 1e3 * sum(d) / len(d) if d else None
