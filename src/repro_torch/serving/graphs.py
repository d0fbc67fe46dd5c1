"""CUDA graphs of a latent-attention model's serving passes.

Eagerly, a pass of DeepSeek-V2-Lite launches ~95 kernels a layer, and on
the card the host takes longer to launch them than the device takes to
run them: the scheduler's ticks wait on the host.  ``StepGraphs`` records
each shape of pass once as a CUDA graph and replays it, so a pass costs
the host one launch.

A pass is first put in a fixed form, on every device:

- a decode step, tokens (B, 1) at per-row positions over the whole slot
  cache, is the eager call itself;
- a prefill chunk, tokens (1, W) written at one position ``start``, runs
  at the per-row position tensor [start] over the cache's first ``ctx``
  positions, ``start + W`` rounded up to ``context_step`` (and at most
  the cache's length), so that one graph serves every chunk of a width
  whose keys end in one bucket.  Keys past each query's position are
  masked, as a decode step masks them, so the chunk attends to the keys
  the plain call attends to; its softmax runs over the bucket's extra
  masked keys, so its sums may round otherwise in the last place.

The inputs are copied into the graph's own buffers, and the logits it
returns are the graph's own output, overwritten by its next replay.  The
first call of a shape runs the pass eagerly on a side stream (every
kernel loads and every lazy setting is made there), returns that pass's
logits and captures it; each later call replays it.  All graphs share
one memory pool: they run one at a time on one stream, and each keeps
its outputs.

A replay opens no span and counts nothing itself; each replay adds the
registry counts of one eager pass of its shape, so the counters stay
those of the passes run.  The routed-row sums (``moe.ROUTE_LOAD``) are
recorded into the graphs and switched by a flag on the device.  Off the
card (the CPU, the tests) the fixed form runs eagerly.
"""
from __future__ import annotations

import logging

import torch

from ..configs.deepseek_v2_lite import MLAConfig
from ..models import moe as MOE
from ..obs.registry import get_registry

_REG = get_registry()
_LOG = logging.getLogger(__name__)


class _Graph:
    """One captured pass: its graph, input buffers, output and the
    registry counts of one pass."""

    def __init__(self, tokens, index):
        self.tokens = tokens
        self.index = index
        self.graph = self.logits = None
        self.counts: dict[str, int] = {}


class StepGraphs:
    """Replays of ``Model.decode_step`` passes, one graph a (cache, tokens
    shape, keys bucket); see the module docstring."""

    def __init__(self, model, params, *, context_step: int = 2048):
        if not isinstance(model.cfg, MLAConfig):
            raise ValueError(f"{model.cfg.name}: step graphs serve "
                             f"latent-attention models")
        self.model = model
        self.params = params
        self.context_step = context_step
        self.graphs: dict[tuple, _Graph] = {}
        self.pool = None
        self.failed = False

    def run(self, cache: dict, tokens: torch.Tensor,
            index: int | torch.Tensor):
        """``decode_step(params, cache, tokens, index)`` in the fixed form,
        through its graph on the card; returns (logits, cache)."""
        B, S = tokens.shape
        T = next(iter(cache["layers"].values())).shape[2]
        if isinstance(index, torch.Tensor):
            ctx = T
        else:
            step = self.context_step
            ctx = min(T, -(-(int(index) + S) // step) * step)
        view = cache if ctx == T else {
            "layers": {k: v[:, :, :ctx] for k, v in cache["layers"].items()}}
        if tokens.device.type != "cuda" or self.failed:
            idx = (index if isinstance(index, torch.Tensor) else
                   torch.full((B,), int(index), device=tokens.device))
            logits, _ = self.model.decode_step(self.params, view, tokens,
                                               idx)
            return logits, cache
        key = (next(iter(cache["layers"].values())).data_ptr(), B, S, ctx)
        g = self.graphs.get(key)
        fresh = g is None
        if fresh:
            g = _Graph(torch.zeros((B, S), dtype=torch.int64,
                                   device=tokens.device),
                       torch.zeros((B,), dtype=torch.int64,
                                   device=tokens.device))
        g.tokens.copy_(tokens)
        if isinstance(index, torch.Tensor):
            g.index.copy_(index)
        else:
            g.index.fill_(int(index))
        if fresh:
            try:
                logits = self._capture(g, view)
            except Exception as e:          # noqa: BLE001 — eager instead
                self.failed = True
                _REG.inc("serve.graphs.failures")
                _LOG.warning("step graph capture failed (%s: %s); the "
                             "passes run eagerly", type(e).__name__, e)
                return self.run(cache, tokens, index)
            self.graphs[key] = g
            return logits, cache
        for name, n in g.counts.items():
            _REG.inc(name, n)
        g.graph.replay()
        return g.logits, cache

    def _capture(self, g: _Graph, view: dict) -> torch.Tensor:
        """Run the pass eagerly on a side stream, then capture it (which
        runs nothing); returns the eager pass's logits.  The registry
        keeps the eager pass's counts and drops the capture's."""
        dev = g.tokens.device
        before = _REG.counters()
        with MOE.ROUTE_LOAD.recording():
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                logits, _ = self.model.decode_step(self.params, view,
                                                   g.tokens, g.index)
            torch.cuda.current_stream(dev).wait_stream(side)
            after = _REG.counters()
            g.counts = {k: v - before.get(k, 0) for k, v in after.items()
                        if v != before.get(k, 0)}
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool):
                g.logits, _ = self.model.decode_step(self.params, view,
                                                     g.tokens, g.index)
        for k, v in _REG.counters().items():
            if v != after.get(k, 0):
                _REG.inc(k, after.get(k, 0) - v)
        g.graph = graph
        _REG.inc("serve.graphs.captured")
        return logits
