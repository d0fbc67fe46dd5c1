"""The window's model flops of a DeepSeek-V2 serving cell over the
window's seconds at the card's bf16 peak, in percent: every real prompt
token of the prefill chunks run in the window (the port's
``sched.prefill_chunk`` spans) at its position, every token decoded in
the window at its context, and the head once for every token the window
delivered (``harness/work_mla.py``)."""
from portbench.harness import work_mla as work


def read(run):
    if not run.spans:
        return None
    cfg = run.cfg
    flops = sum(work.chunk_flops(cfg, s.attrs["start"], s.attrs["real"])
                for s in run.spans if s.name == "sched.prefill_chunk")
    index = {}
    for t, rid in run.tokens:
        i = index[rid] = index.get(rid, -1) + 1
        if not run.in_window(t):
            continue
        if i == 0:
            flops += 2.0 * work.head_params(cfg)
        else:
            flops += work.token_flops(cfg, run.prompt_len[rid] + i,
                                      head=True)
    return 100.0 * flops / (run.seconds * work.PEAK_FLOPS["bfloat16"])
