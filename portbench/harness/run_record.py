"""What a run hands the metric readers, and the port's configuration
built from a configuration file."""
from __future__ import annotations

import dataclasses
import sys


def log(msg: str) -> None:
    """A line of the run's account on standard error."""
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    """Everything a reader may read.  ``window`` is (start, end) on the
    host's ``time.perf_counter``; ``spans`` the port's tracer spans of
    the window (a traced run), ``profile`` the device trace taken after
    the window, ``profile_spans`` the spans of that stretch and
    ``host_profile`` a further stretch with the host's operators."""

    cfg: dict
    traffic: dict
    window: tuple[float, float]
    setup_s: float
    # serving
    tokens: list = dataclasses.field(default_factory=list)   # (t, req_id)
    sends: dict = dataclasses.field(default_factory=dict)    # req_id -> t
    prompt_len: dict = dataclasses.field(default_factory=dict)
    prewarm_s: float | None = None
    # training: (end time, tokens) of each step started in the window
    steps: list = dataclasses.field(default_factory=list)
    # traced runs
    spans: list | None = None
    profile: object = None
    profile_spans: list | None = None
    host_profile: object = None

    @property
    def seconds(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self, t: float) -> bool:
        return self.window[0] <= t <= self.window[1]


def arch_config(cfg: dict):
    """The port's ``ArchConfig`` of a configuration file."""
    from repro_torch.configs.base import ArchConfig
    run = cfg["run"]
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return ArchConfig(
        name=cfg["name"], family="dense", layers=cfg["num_hidden_layers"],
        d_model=d, n_heads=h, kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or d // h,
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]), norm=run["norm"],
        param_dtype=run["param_dtype"], compute_dtype=run["compute_dtype"],
        tie_embeddings=cfg["tie_word_embeddings"],
        fused_mlp=run["fused_mlp"])
