"""The port's span tracer: clock anchors and their JSONL round trip, the
conversion onto a ``torch.profiler`` trace's clock (held against a CPU
profile), the scheduler's and the training step's phase spans on tiny
CPU runs, and the off path."""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.obs import tracing
from repro_torch.obs.registry import get_registry
from repro_torch.obs.tracing import (CLOCK, NULL_SPAN, Tracer, anchors,
                                     get_tracer, set_tracer, span,
                                     to_trace_us, trace_event)
from repro_torch.serving import Engine, ServeConfig
from repro_torch.serving.router import NgramDrafter
from repro_torch.serving.sched import (ContinuousScheduler, Request,
                                       SchedConfig)
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import jit_train_step


@pytest.fixture(autouse=True)
def _no_tracer():
    """Every test starts and ends with no tracer installed."""
    set_tracer(None)
    get_registry().reset()
    yield
    set_tracer(None)
    get_registry().reset()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 0.5
        return self.t


# ------------------------------------------------------------ anchors
def test_a_default_tracer_anchors_when_made_and_when_uninstalled():
    tr = Tracer()
    assert [s.name for s in tr.spans] == [CLOCK]
    a = tr.spans[0]
    assert a.t0 == a.t1 and a.parent is None
    assert isinstance(a.attrs["epoch_ns"], int)
    assert 0 <= a.attrs["err_ns"] < 1e6
    # the anchor pairs the two clocks: its epoch reading lies within a
    # millisecond of one taken now, moved back by the span clock's step
    now_c, now_e = time.perf_counter(), time.time_ns()
    assert abs((now_e - a.attrs["epoch_ns"]) / 1e9
               - (now_c - a.t0)) < 1e-3
    set_tracer(tr)
    with span("work"):
        pass
    set_tracer(None)
    assert [s.name for s in tr.spans] == [CLOCK, "work", CLOCK]
    assert len(anchors(tr.spans)) == 2
    # re-installing the same tracer is not an uninstall
    set_tracer(tr)
    set_tracer(tr)
    assert len(anchors(tr.spans)) == 2
    tr.clear()
    assert [s.name for s in tr.spans] == [CLOCK]


def test_anchors_survive_a_jsonl_round_trip(tmp_path):
    tr = Tracer()
    set_tracer(tr)
    with span("outer", k=1):
        with span("inner"):
            pass
    set_tracer(None)
    path = tmp_path / "spans.jsonl"
    tr.to_jsonl(path)
    back = Tracer.from_jsonl(path)
    assert [s.to_json() for s in back] == [s.to_json() for s in tr.spans]
    assert anchors(back) == anchors(tr.spans)
    for s in tr.spans:
        assert to_trace_us(s.t0, anchors(back), 7) == \
            to_trace_us(s.t0, anchors(tr.spans), 7)
    first = json.loads(path.read_text().splitlines()[0])
    assert first["name"] == CLOCK and "epoch_ns" in first["attrs"]


def test_an_injected_clock_has_no_anchors_and_the_conversion_raises():
    tr = Tracer(clock=FakeClock())
    set_tracer(tr)
    with span("work"):
        pass
    set_tracer(None)
    assert [s.name for s in tr.spans] == ["work"]
    assert anchors(tr.spans) == []
    with pytest.raises(ValueError, match="injected"):
        tr.anchor()
    with pytest.raises(ValueError, match="anchor"):
        to_trace_us(tr.spans[0].t0, anchors(tr.spans))


def test_the_conversion_interpolates_between_the_nearest_anchors():
    # clock 10 s <-> epoch 1000 s; clock 12 s <-> epoch 1002.000004 s:
    # the epoch runs 2 ppm fast against the span clock
    pairs = [(10.0, 1_000 * 10**9), (12.0, 1_002 * 10**9 + 4_000),
             (20.0, 1_010 * 10**9 + 4_000)]
    base = 999 * 10**9
    assert to_trace_us(10.0, pairs, base) == pytest.approx(1e6)
    assert to_trace_us(11.0, pairs, base) == pytest.approx(2e6 + 2)
    assert to_trace_us(12.0, pairs, base) == pytest.approx(3e6 + 4)
    assert to_trace_us(16.0, pairs, base) == pytest.approx(7e6 + 4)
    # outside the anchors: the nearest segment's slope
    assert to_trace_us(9.0, pairs, base) == pytest.approx(-2)
    assert to_trace_us(21.0, pairs, base) == pytest.approx(12e6 + 4)
    # one anchor: its offset alone
    assert to_trace_us(15.5, pairs[:1], base) == pytest.approx(6.5e6)
    # anchors too close together for a slope: the left one's offset
    close = [(10.0, 1_000 * 10**9), (10.0001, 1_000 * 10**9 + 900_000)]
    assert to_trace_us(10.5, close, base) == pytest.approx(1.5e6)


def test_a_span_around_a_matmul_contains_the_profilers_matmul(tmp_path):
    """The converted span holds the trace's ``aten::mm``, which lies 2 ms
    inside both of its ends, so the two clocks agree to 2 ms or better;
    the offsets themselves are printed."""
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(96, 96)
    tr = Tracer()
    set_tracer(tr)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("probe"):
            time.sleep(0.002)
            torch.mm(a, a)
            time.sleep(0.002)
    set_tracer(None)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        trace = json.load(fh)
    base = int(trace["baseTimeNanoseconds"])
    mm = [e for e in trace["traceEvents"]
          if e.get("name") == "aten::mm" and e.get("ph") == "X"]
    assert len(mm) == 1
    mm0 = float(mm[0]["ts"])
    mm1 = mm0 + float(mm[0]["dur"])
    probe = tr.by_name("probe")[0]
    pairs = anchors(tr.spans)
    s0, s1 = (to_trace_us(t, pairs, base) for t in (probe.t0, probe.t1))
    print(f"aten::mm {mm0 - s0:.1f} us after the span's start, "
          f"{s1 - mm1:.1f} us before its end")
    assert s0 < mm0 < mm1 < s1


def test_a_span_opened_on_another_thread_parents_under_the_open_one():
    tr = Tracer()
    set_tracer(tr)
    with span("train.backward") as outer:
        th = threading.Thread(target=_open_close, args=("remat",))
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
    set_tracer(None)
    remat = tr.by_name("remat")
    assert len(remat) == 1 and remat[0].parent == outer.sid
    assert remat[0].t1 is not None
    # the stack is empty again: a new span is a root
    set_tracer(tr)
    with span("after") as sp:
        pass
    set_tracer(None)
    assert sp.parent is None


def _open_close(name: str) -> None:
    with span(name):
        pass


def test_threads_that_share_a_tracer_lose_no_span():
    """Threads open and close spans at once on one tracer, with the
    interpreter switching threads as often as it can: every span is
    recorded once, closed, with a parent that was open around it, and
    the stack ends empty."""
    tr = Tracer()
    threads, per = 24, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        set_tracer(tr)
        pool = [threading.Thread(target=lambda: [_open_close("w")
                                                 for _ in range(per)])
                for _ in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
        set_tracer(None)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in pool)
    work = tr.by_name("w")
    assert len(work) == threads * per
    assert sorted(s.sid for s in tr.spans) == list(range(len(tr.spans)))
    by_sid = {s.sid: s for s in tr.spans}
    for s in work:
        assert s.t1 is not None
        if s.parent is not None:
            assert by_sid[s.parent].t0 <= s.t0
    assert tr._stack == []


def test_an_out_of_order_end_leaves_no_stale_parent():
    tr = Tracer(clock=FakeClock())
    a = tr.start("a")
    b = tr.start("b")
    tr.end(a)           # a thread that closed its span first
    tr.end(b)
    c = tr.start("c")
    assert c.parent is None


# ---------------------------------------------------- serving spans
@pytest.fixture(scope="module")
def engine():
    cfg = get_config("llama3-8b", smoke=True)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    return cfg, Engine(model, params, ServeConfig(max_new_tokens=6,
                                                  cache_len=96))


def _requests(vocab: int, n: int) -> list[Request]:
    return [Request(req_id=10 + i, tokens=np.random.default_rng(i)
                    .integers(0, vocab, (12 + i,)).astype(np.int32),
                    max_new_tokens=5) for i in range(n)]


def _under(tr: Tracer, child: str, parent: str) -> bool:
    by_sid = {s.sid: s for s in tr.spans}
    kids = tr.by_name(child)
    return bool(kids) and all(by_sid[s.parent].name == parent
                              for s in kids)


def test_the_scheduler_spans_nest_by_phase_and_share_request_ids(engine):
    cfg, eng = engine
    sched = ContinuousScheduler(eng, SchedConfig(slots=3,
                                                 chunk_widths=(4, 16)))
    tr = Tracer()
    set_tracer(tr)
    results = sched.run(_requests(cfg.vocab, 4))
    set_tracer(None)
    assert len(results) == 4
    for child in ("sched.admit", "sched.prefill_chunk",
                  "sched.decode_batch", "sched.emit"):
        assert _under(tr, child, "sched.tick"), child
    assert _under(tr, "sched.sample", "sched.decode_batch")
    assert _under(tr, "sched.request", "sched.tick")
    assert _under(tr, "sched.first_token", "sched.request")
    ticks = tr.by_name("sched.tick")
    assert len(tr.by_name("sched.admit")) == len(ticks)
    assert len(tr.by_name("sched.sample")) == \
        len(tr.by_name("sched.decode_batch")) == \
        len(tr.by_name("sched.emit"))
    # in a tick: admission, then the chunks, then the decode and its emit
    by_sid = {s.sid: s for s in tr.spans}
    for tick in ticks:
        kids = [s.name for s in tr.spans if s.parent == tick.sid
                and s.name != "sched.request"]
        order = ["sched.admit", "sched.prefill_chunk",
                 "sched.decode_batch", "sched.emit"]
        assert kids[0] == "sched.admit"
        assert [order.index(k) for k in kids] == \
            sorted(order.index(k) for k in kids)
    queued = {s.attrs["req_id"]: s for s in tr.by_name("sched.queued")}
    admitted = {s.attrs["req_id"]: s for s in tr.by_name("sched.request")}
    assert set(queued) == set(admitted) == {10, 11, 12, 13}
    for rid, req in admitted.items():
        assert queued[rid].t0 <= req.t0 and req.t1 is not None
        assert by_sid[req.parent].name == "sched.tick"
    # the one event a tracer records outside the ticks
    assert all(s.parent is None for s in queued.values())


def test_a_speculative_tick_has_its_verify_batch_and_emit(engine):
    cfg, eng = engine
    sched = ContinuousScheduler(
        eng, SchedConfig(slots=3, chunk_widths=(8, 16), spec_width=4),
        drafter=NgramDrafter())
    tr = Tracer()
    set_tracer(tr)
    sched.run(_requests(cfg.vocab, 3))
    set_tracer(None)
    assert _under(tr, "sched.verify_batch", "sched.tick")
    assert _under(tr, "sched.emit", "sched.tick")
    assert len(tr.by_name("sched.emit")) == \
        len(tr.by_name("sched.verify_batch")) > 0
    assert not tr.by_name("sched.decode_batch")


# --------------------------------------------------- training spans
@pytest.fixture(scope="module")
def tiny_train():
    cfg = get_config("llama3-8b", smoke=True)
    model = build_model(cfg)
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (4, 16)))
             for k in ("tokens", "labels")}
    return model, ocfg, batch


def _fresh(model):
    params = model.init_params(torch.Generator().manual_seed(0), "cpu",
                               masters=True)
    return params, opt.init_state(params)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_the_train_step_holds_forward_backward_and_optimizer(
        tiny_train, microbatches):
    model, ocfg, batch = tiny_train
    step = jit_train_step(model, ocfg, microbatches=microbatches,
                          remat=True)
    params, state = _fresh(model)
    tr = Tracer()
    set_tracer(tr)
    _, _, m = step(params, state, batch)
    set_tracer(None)
    assert torch.isfinite(m["loss"])
    (top,) = tr.by_name("train.step")
    kids = [s.name for s in tr.spans if s.parent == top.sid]
    assert kids == ["train.forward", "train.backward"] * microbatches + \
        ["train.optimizer"]
    for s in tr.spans:
        if s.name.startswith("train.") and s is not top:
            assert top.t0 <= s.t0 <= s.t1 <= top.t1
    # whatever opens inside the backward (a rematerialized layer's
    # spans) parents under it
    back = {s.sid for s in tr.by_name("train.backward")}
    by_sid = {s.sid: s for s in tr.spans}
    for s in tr.spans:
        if s.parent in back:
            assert by_sid[s.parent].t0 <= s.t0 <= s.t1 <= \
                by_sid[s.parent].t1


# ------------------------------------------------------- off path
def test_with_no_tracer_installed_nothing_is_recorded(engine, tiny_train):
    assert get_tracer() is None
    assert span("anything", k=1) is NULL_SPAN
    assert trace_event("anything") is None
    bystander = Tracer()
    cfg, eng = engine
    ContinuousScheduler(eng, SchedConfig(slots=3, chunk_widths=(4, 16))
                        ).run(_requests(cfg.vocab, 2))
    model, ocfg, batch = tiny_train
    params, state = _fresh(model)
    jit_train_step(model, ocfg, remat=True)(params, state, batch)
    assert [s.name for s in bystander.spans] == [CLOCK]
    assert tracing._TRACER is None
