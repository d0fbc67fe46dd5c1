"""Attribution on a hand-built stretch with known answers: the port's
spans converted onto the device trace's clock, each kernel put down to
the span that launched it, each idle gap to the span that was open, and
every reader built on them."""
import pytest

from portbench.harness import attrib, devtrace, spec
from portbench.harness.run_record import Run
from repro_torch.obs.tracing import CLOCK, Span

BASE = 1_790_857_026_000_000_000       # the trace's baseTimeNanoseconds
T0 = 5_000.0                           # the span clock at the trace's 0


class Spans:
    """Spans on a span clock that sits T0 s behind the trace's zero, with
    times given in trace milliseconds."""

    def __init__(self):
        self.spans = []
        for t in (0.0, 1.0):             # two anchors one second apart
            self.event(CLOCK, t * 1e3, epoch_ns=BASE + int(t * 1e9))

    def add(self, name, t0_ms, t1_ms, parent=None, **attrs):
        sp = Span(sid=len(self.spans), name=name, t0=T0 + t0_ms / 1e3,
                  t1=T0 + t1_ms / 1e3,
                  parent=None if parent is None else parent.sid,
                  attrs=attrs)
        self.spans.append(sp)
        return sp

    def event(self, name, t_ms, parent=None, **attrs):
        return self.add(name, t_ms, t_ms, parent, **attrs)


def profile(kernels, window_s, launch=True):
    """A device trace: kernels as (name, start ms, duration ms, launch
    ms)."""
    prof = devtrace.Profile([(n, s * 1e3, d * 1e3) for n, s, d, _ in
                             kernels], [], window_s)
    if launch:
        prof.launch_us = [None if t is None else t * 1e3
                          for _, _, _, t in kernels]
        prof.base_ns = BASE
    return prof


def serve_stretch():
    """Two ticks: the first admits, prefills a chunk (one B1 launch in a
    ``kernel.gemm`` span), decodes and emits; the second decodes and
    emits.  A request span outlives the first tick."""
    s = Spans()
    s.event("sched.queued", 0.0, req_id=7)
    t1 = s.add("sched.tick", 0, 50, tick=0)
    s.add("sched.admit", 0, 2, t1)
    s.add("sched.request", 1, 90, t1, req_id=7)
    chunk = s.add("sched.prefill_chunk", 2, 10, t1, width=512)
    s.add("kernel.gemm", 3, 4, chunk, m=512, n=8, k=8)
    d1 = s.add("sched.decode_batch", 10, 30, t1, rows=4)
    s.add("sched.sample", 20, 30, d1)
    s.add("sched.emit", 30, 40, t1)
    t2 = s.add("sched.tick", 60, 100, tick=1)
    s.add("sched.admit", 60, 61, t2)
    d2 = s.add("sched.decode_batch", 61, 80, t2, rows=4)
    s.add("sched.sample", 70, 80, d2)
    s.add("sched.emit", 80, 95, t2)
    kernels = [("goma_matmul_bf16", 5, 10, 3.5),       # prefill, tick 0
               ("elementwise", 15, 3, 6),              # prefill
               ("attn", 18, 10, 12),                   # decode, tick 0
               ("Memcpy DtoH", 28, 1, 25),             # decode (sample)
               ("attn", 62, 8, 61.5),                  # decode, tick 1
               ("Memcpy DtoH", 75, 1, 75)]             # decode (sample)
    return s.spans, profile(kernels, 0.1)


def train_stretch():
    """One step: forward, a backward whose rematerialized layer opened a
    span (on autograd's thread), and the optimizer, whose two kernels
    overlap."""
    s = Spans()
    step = s.add("train.step", 0, 100)
    s.add("train.forward", 0, 30, step)
    back = s.add("train.backward", 30, 70, step)
    s.add("kernel.gemm", 40, 45, back, m=8, n=8, k=8)
    s.add("train.optimizer", 70, 95, step)
    kernels = [("fwd", 10, 25, 5), ("bwd", 35, 25, 31),
               ("remat", 60, 15, 42), ("adam", 75, 15, 72),
               ("adam", 85, 10, 80)]
    return s.spans, profile(kernels, 0.1)


def run_of(spans, prof):
    run = Run(cfg={}, traffic={}, window=(0.0, 1.0), setup_s=0.0)
    run.profile, run.profile_spans = prof, spans
    return run


def test_the_timeline_keeps_the_stack_spans_on_the_traces_clock():
    spans, prof = serve_stretch()
    tl = attrib.timeline(prof, spans)
    names = [s.name for s in tl.spans]
    assert "sched.request" not in names        # it outlives its tick
    assert CLOCK not in names and "sched.queued" not in names
    tick = names.index("sched.tick")
    assert tl.t0[tick] == pytest.approx(0.0, abs=1e-3)
    assert tl.t1[tick] == pytest.approx(50e3, abs=1e-3)
    at = lambda ms: tl.spans[tl.innermost(ms * 1e3)].name
    assert at(3.5) == "kernel.gemm"
    assert at(5) == "sched.prefill_chunk"
    assert at(25) == "sched.sample"
    assert at(45) == "sched.tick"
    assert tl.innermost(55e3) is None


def test_kernels_go_to_the_span_that_launched_them():
    spans, prof = serve_stretch()
    tl = attrib.timeline(prof, spans)
    got = [tl.spans[i].name for i in attrib.owners(prof, tl)]
    assert got == ["kernel.gemm", "sched.prefill_chunk",
                   "sched.decode_batch", "sched.sample",
                   "sched.decode_batch", "sched.sample"]
    check = attrib.gemm_clock_check(prof, spans)
    assert check == {"kernels": 1, "inside": 1, "launch_order": True,
                     "margin_us": pytest.approx(500.0, abs=1e-3)}
    assert attrib.covered_busy(prof, spans, ("sched.tick",)) == 1.0


def test_idle_goes_to_the_span_open_at_each_gaps_middle():
    spans, prof = serve_stretch()
    tl = attrib.timeline(prof, spans)
    gaps = attrib.idle_gaps(prof, tl)
    want = [(0.0, 5e3), (29e3, 62e3), (70e3, 75e3), (76e3, 100e3)]
    assert gaps == [pytest.approx(g, abs=1e-3) for g in want]
    account = dict(attrib.idle_account(prof, spans))
    assert account == pytest.approx({"sched.prefill_chunk": 0.005,
                                     "sched.tick": 0.033,
                                     "sched.sample": 0.005,
                                     "sched.emit": 0.024})
    step, sched = attrib.idle_share(prof, spans, ("sched.prefill_chunk",
                                                  "sched.decode_batch"))
    assert step == pytest.approx(10.0) and sched == pytest.approx(57.0)
    # the two shares add up to the stretch's idle share
    idle = spec.reader("device_idle.serve")(run_of(spans, prof))
    assert step + sched == pytest.approx(idle)


def test_a_gap_outside_every_span_is_labelled_so():
    s = Spans()
    s.add("sched.tick", 0, 10)
    s.add("sched.tick", 20, 30)
    prof = profile([("a", 1, 2, 0.5), ("b", 25, 2, 21)], 0.03)
    assert dict(attrib.idle_account(prof, s.spans))[attrib.OUTSIDE] == \
        pytest.approx(0.022)


@pytest.mark.parametrize("name, want", [
    ("step.decode_device_ms", 10.0),          # (11 + 9) / 2 ticks
    ("step.prefill_device_ms", 13.0),         # the one tick with a chunk
    ("step.launches_per_tick", 3.0),          # (4 + 2) / 2
    ("device_idle.step_host", 10.0),
    ("device_idle.sched_host", 57.0),
])
def test_the_serving_readers(name, want):
    assert spec.reader(name)(run_of(*serve_stretch())) == \
        pytest.approx(want)


@pytest.mark.parametrize("name, want", [
    ("train.forward_ms", 25.0),
    ("train.backward_ms", 40.0),              # with the remat's kernel
    ("train.optimizer_ms", 20.0),             # overlapping kernels once
])
def test_the_training_readers(name, want):
    assert spec.reader(name)(run_of(*train_stretch())) == \
        pytest.approx(want)


def test_the_training_phases_cover_the_steps_busy_time():
    spans, prof = train_stretch()
    phases = sum(spec.reader(f"train.{p}_ms")(run_of(spans, prof))
                 for p in ("forward", "backward", "optimizer"))
    assert phases == pytest.approx(prof.busy_s * 1e3)


@pytest.mark.parametrize("name", [
    "step.decode_device_ms", "step.prefill_device_ms",
    "step.launches_per_tick", "device_idle.step_host",
    "device_idle.sched_host", "train.forward_ms"])
def test_without_launch_times_or_anchors_a_reader_reads_nothing(name):
    spans, prof = serve_stretch()
    # a trace reader that keeps no launch calls
    assert spec.reader(name)(run_of(spans, profile([], 0.1, False))) \
        is None
    # a program whose tracer does not anchor
    bare = [s for s in spans if s.name != CLOCK]
    assert spec.reader(name)(run_of(bare, prof)) is None
    assert spec.reader(name)(run_of(None, None)) is None


def test_a_launch_without_a_call_is_put_down_to_no_span():
    s = Spans()
    s.add("sched.tick", 0, 10)
    prof = profile([("a", 1, 2, None), ("b", 4, 2, 3)], 0.01)
    tl = attrib.timeline(prof, s.spans)
    assert attrib.owners(prof, tl) == [None, 0]
    assert attrib.launches_by(prof, s.spans, "sched.tick") == [1]


def test_the_queue_wait_reader():
    s = Spans()
    t = s.add("sched.tick", 10, 20)
    s.event("sched.queued", 1.0, req_id=1)
    s.event("sched.queued", 4.0, req_id=2)
    s.add("sched.request", 12, 40, t, req_id=1)
    s.add("sched.request", 13, 40, t, req_id=2)
    s.add("sched.request", 14, 40, t, req_id=0)    # queued before
    run = Run(cfg={}, traffic={}, window=(0.0, 1.0), setup_s=0.0)
    run.spans = s.spans
    assert spec.reader("sched.queue_wait_ms")(run) == pytest.approx(10.0)
    run.spans = [x for x in s.spans if x.name != "sched.queued"]
    assert spec.reader("sched.queue_wait_ms")(run) is None
