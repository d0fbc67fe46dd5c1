"""Mean time from a request's ``sched.queued`` event (at ``submit``) to the
start of its ``sched.request`` span (admission), over the requests
admitted in the window whose submission the window saw, in
milliseconds (the port's spans, on the host's clock)."""


def read(run):
    if not run.spans:
        return None
    queued = {s.attrs["req_id"]: s.t0 for s in run.spans
              if s.name == "sched.queued"}
    waits = [s.t0 - queued[s.attrs["req_id"]] for s in run.spans
             if s.name == "sched.request" and s.attrs["req_id"] in queued]
    return 1e3 * sum(waits) / len(waits) if waits else None
