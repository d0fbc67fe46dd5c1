"""The dsv2lite cell cut to a size the CPU tests can run: its files with
smoke widths (every width a multiple of 4, so that fp32 grouped products
take 16-byte strides), the same driver and readers."""
from __future__ import annotations

import copy

from portbench.harness import spec

TINY = dict(num_hidden_layers=8, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, intermediate_size=128,
            moe_intermediate_size=32, n_routed_experts=16,
            num_experts_per_tok=2, vocab_size=257)


def tiny_config(**kw) -> dict:
    """The configuration at smoke widths in fp32; ``kw`` overrides."""
    cfg = copy.deepcopy(spec.load_json(spec.HERE / "configs"
                                       / "deepseek-v2-lite.json"))
    cfg.update(TINY, **kw)
    cfg["run"]["compute_dtype"] = "float32"
    return cfg


def tiny_cell() -> spec.Cell:
    """The cell at smoke widths in fp32, with short traffic; the check
    samples the cell's 400 served tokens from up to 32 of the window's
    short requests."""
    cell = spec.load_cell("dsv2lite.chat8k")
    tr = copy.deepcopy(cell.traffic)
    tr.update(clients=4, pool=64, cache_len=96, warm_ticks=4,
              trace_ticks=2)
    tr["prompt"].update(median=20, min=4, max=48)
    tr["output"].update(median=4, min=2, max=8)
    tr["sched"].update(slots=4, chunk_widths=[8, 16])
    tr["check"].update(most_requests=32)
    return spec.Cell(name=cell.name, chips=1, config=tiny_config(),
                     traffic=tr, limits=cell.limits,
                     end_to_end=cell.end_to_end, per_layer=cell.per_layer)
