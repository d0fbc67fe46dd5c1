"""The yardstick's arithmetic against hand counts: a GEMM's work, the
model flops, the roofline share of matched kernels, the device trace's
busy time and gaps."""
import json

import pytest

from portbench.harness import devtrace, kernels, spec, work
from portbench.harness.run_record import Run

CFG = {"num_hidden_layers": 2, "hidden_size": 8, "num_attention_heads": 2,
       "num_key_value_heads": 1, "head_dim": 4, "intermediate_size": 16,
       "vocab_size": 10, "run": {"compute_dtype": "bfloat16"}}


def test_gemm_and_combine_work():
    assert work.gemm_work(2, 3, 4, "bfloat16") == (48.0, 2.0 * (8 + 12 + 6))
    assert work.combine_work(2, 5, "float32") == (40.0, 4.0 * 30)
    # memory-bound: 1 GB at 3.35 TB/s beats 1 GFLOP at 989 TFLOP/s
    assert work.least_time(1e9, 1e9, "bfloat16") == pytest.approx(
        1e9 / 3.35e12)
    assert work.least_time(1e15, 1.0, "bfloat16") == pytest.approx(
        1e15 / 989e12)


def test_model_flops_by_hand():
    # a layer multiplies 8*(2*8 + 2*4) + 3*8*16 = 576 weights
    assert work.layer_matmul_params(CFG) == 576
    assert work.head_params(CFG) == 80
    # one token at context 3: 2*576*2 + 4*3*2*4*2 = 2304 + 192
    assert work.token_flops(CFG, 3, head=False) == 2304 + 192
    assert work.token_flops(CFG, 3, head=True) == 2304 + 192 + 160
    # positions 2, 3 of a prefill see 3 and 4 keys
    assert work.chunk_flops(CFG, 2, 2) == 2 * 2304 + 4 * 7 * 8 * 2
    # a step of 1 x 2: 3 * (chunk(0, 2) + head of 2 tokens)
    assert work.train_step_flops(CFG, 1, 2) == 3 * (
        work.chunk_flops(CFG, 0, 2) + 2 * 160)


def test_busy_time_merges_overlaps_and_finds_gaps():
    ks = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 30.0, 5.0)]
    p = devtrace.Profile(ks, [("aten::mm", 18.0, 4.0)], window_s=50e-6)
    assert p.busy_s == pytest.approx(20e-6)
    assert p.gaps == [(15.0, 30.0)]
    assert p.idle_gaps() == [["host: between operators", 15e-6]]
    p2 = devtrace.Profile(ks, [("aten::mm", 18.0, 10.0)], window_s=50e-6)
    assert p2.idle_gaps() == [["aten::mm", 15e-6]]
    assert p.device_ops()[0] == ["a", 10e-6]


def test_chrome_trace_reading(tmp_path):
    ev = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 5, "dur": 2},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1,
           "dur": 3},
          {"ph": "X", "cat": "kernel", "name": "k0", "ts": 1, "dur": 1},
          {"ph": "i", "cat": "kernel", "name": "mark", "ts": 0}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    p = devtrace.read_chrome(str(path), 1e-5)
    assert [k[0] for k in p.kernels] == ["k0", "k1"]
    assert p.busy_s == pytest.approx(3e-6)


class S:
    def __init__(self, sid, name, parent, **attrs):
        self.sid, self.name, self.parent, self.attrs = sid, name, parent, attrs


def test_roofline_share_matches_kernels_to_spans_in_order():
    spans = [S(0, "sched.tick", None),
             S(1, "sched.prefill_chunk", 0),
             S(2, "kernel.fused_mlp", 1, m=4, ff=16, k=8, n2=8),
             S(3, "kernel.gemm", 2, m=4, n=16, k=8),
             S(4, "kernel.gemm", 2, m=4, n=16, k=8),
             S(5, "kernel.gemm", 2, m=4, n=8, k=16),
             S(6, "sched.decode_batch", 0),
             S(7, "kernel.gemm", 6, m=2, n=8, k=8)]
    ks = [("goma_matmul_wgmma<128>", 0.0, 1.0),
          ("goma_matmul_wgmma<128>", 2.0, 1.0),
          ("goma_combine_kernel", 3.0, 0.5),
          ("goma_matmul_wgmma<64>", 4.0, 2.0),
          ("goma_matmul_wgmma<64>", 9.0, 4.0)]
    run = Run(cfg=CFG, traffic={}, window=(0, 1), setup_s=0,
              profile=devtrace.Profile(ks, [], 1e-5), profile_spans=spans)
    bf = "bfloat16"
    pre = (2 * work.least_time(*work.gemm_work(4, 16, 8, bf), bf)
           + work.least_time(*work.gemm_work(4, 8, 16, bf), bf)
           + work.least_time(*work.combine_work(4, 16, bf), bf))
    dec = work.least_time(*work.gemm_work(2, 8, 8, bf), bf)
    assert kernels.roofline_share(run, "sched.prefill_chunk") == \
        pytest.approx(100 * pre / 4.5e-6)
    assert kernels.roofline_share(run, "sched.decode_batch") == \
        pytest.approx(100 * dec / 4e-6)
    assert spec.reader("gemm_roofline.decode")(run) == pytest.approx(
        100 * dec / 4e-6)
    # a stretch whose counts differ reads nothing
    run.profile = devtrace.Profile(ks[:-1], [], 1e-5)
    assert kernels.roofline_share(run, "sched.decode_batch") is None


def test_mfu_serve_counts_chunks_and_decoded_tokens():
    spans = [S(0, "sched.prefill_chunk", None, start=0, real=3, width=4)]
    run = Run(cfg=CFG, traffic={}, window=(0.0, 2.0),
              setup_s=0, spans=spans, prompt_len={1: 3},
              tokens=[(0.5, 1), (1.0, 1), (3.0, 1)])
    flops = (work.chunk_flops(CFG, 0, 3) + 2 * 80
             + work.token_flops(CFG, 4, head=True))
    assert spec.reader("mfu.serve")(run) == pytest.approx(
        100 * flops / (2.0 * 989e12))
