"""Program capture's differential oracle on the port: capturing the
LlmSpec reference programs (``repro_torch.capture.reference``) reproduces
the hand-enumerated GEMM *and chain* multisets of ``core.workloads``
exactly, on every ``paper_cases()`` spec and on the tiny dense and MoE
scenarios — the twins of tests/test_capture.py's enumeration tests, held
against the enumeration as those tests name it (ROADMAP C1: the
reference's own chain capture fails under jax 0.9.0)."""
import pytest

from repro_torch.capture import (capture_spec_decode, capture_spec_prefill,
                                 capture_spec_scenario, diff_programs,
                                 programs_equal)
from repro_torch.core.workloads import (CENTER_MODELS, EDGE_MODELS, LlmSpec,
                                        decode_program, paper_cases,
                                        prefill_program, scenario_program)

SPECS = {s.name: s for s in EDGE_MODELS + CENTER_MODELS}
TINY = LlmSpec("tiny", layers=2, d_model=64, n_heads=4, kv_heads=2,
               head_dim=16, d_ff=128, vocab=512)
TINY_MOE = LlmSpec("tiny-moe", layers=2, d_model=64, n_heads=4,
                   kv_heads=2, head_dim=16, d_ff=128, vocab=512,
                   n_experts=4, top_k=2, shared_experts=1)


def _distinct_cases():
    return sorted({(spec.name, seq) for _, spec, seq, _ in paper_cases()})


@pytest.mark.parametrize("name,seq", _distinct_cases())
def test_capture_matches_enumeration_prefill(name, seq):
    spec = SPECS[name]
    cap = capture_spec_prefill(spec, seq)
    hand = prefill_program(spec, seq)
    assert programs_equal(cap, hand), diff_programs(cap, hand)
    assert cap.chains, "every paper spec's MLP chain is captured"


@pytest.mark.parametrize("name", sorted(SPECS))
def test_capture_matches_enumeration_decode(name):
    spec = SPECS[name]
    cap = capture_spec_decode(spec, 8, 4096)
    hand = decode_program(spec, 8, 4096)
    assert programs_equal(cap, hand), diff_programs(cap, hand)


@pytest.mark.parametrize("spec", [TINY, TINY_MOE], ids=lambda s: s.name)
def test_capture_matches_enumeration_tiny_scenario(spec):
    kw = dict(prefill_seqs=(64, 128), decode_batches=(4,), cache_len=256)
    cap = capture_spec_scenario(spec, **kw)
    hand = scenario_program(spec, **kw)
    assert programs_equal(cap, hand), diff_programs(cap, hand)
    assert cap.chain_multiset() and cap.source == "capture"
