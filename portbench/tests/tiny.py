"""Cells cut to a size the CPU tests can run: the real cells' files
with smoke widths, the same drivers and readers."""
from __future__ import annotations

import copy

from portbench.harness import spec


def tiny_config(name: str, dtype: str = "float32") -> dict:
    cfg = copy.deepcopy(spec.load_json(spec.HERE / "configs"
                                       / f"{name}.json"))
    cfg.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
               num_key_value_heads=2 if name == "yi-34b" else 4,
               head_dim=16, intermediate_size=128, vocab_size=257)
    cfg["run"]["compute_dtype"] = dtype
    return cfg


def tiny_cell(workload: str) -> spec.Cell:
    """The cell ``workload`` at smoke widths in fp32, with short
    traffic."""
    cell = spec.load_cell(workload)
    cfg = tiny_config(cell.config["name"])
    tr = copy.deepcopy(cell.traffic)
    if tr["kind"] == "serve":
        tr.update(clients=4, pool=64, cache_len=96, warm_ticks=4,
                  trace_ticks=2)
        tr["prompt"].update(median=20, min=4, max=48)
        tr["output"].update(median=4, min=2, max=8)
        tr["sched"].update(slots=4, chunk_widths=[8, 16],
                           prewarm_source="capture")
        tr["check"].update(served_tokens=24, most_requests=3)
    else:
        tr.update(batch=2, seq=32)
    return spec.Cell(name=cell.name, chips=1, config=cfg, traffic=tr,
                     limits=cell.limits, end_to_end=cell.end_to_end,
                     per_layer=cell.per_layer)
