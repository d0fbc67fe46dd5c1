"""The general generator that reads a traffic file.

Serving: a pool of requests cut into consecutive blocks of ``block``
requests.  Each block's prompt and output
lengths are the quantiles of the file's distributions at
(i + 0.5) / block, in an order drawn from the seed, and prompt tokens
are drawn from the seed.  So every seed serves the same set of sizes in
another order, and a block shorter than the stretch of requests a
window sees keeps the window's work from moving with the seed.  Clients of a closed loop take the pool's requests in order.

Training: the rows of step i are a pure function of (seed, i, row): the
structured stream of the port's synthetic data (runs of 8 repeats of a
random token, 15% of positions replaced by noise), so rows all differ
and a loss can fall.
"""
from __future__ import annotations

import math
import statistics

import numpy as np

_NORMAL = statistics.NormalDist()


def quantile(dist: dict, q: float) -> int:
    """The q-quantile (0 < q < 1) of a length distribution, clipped to
    its [min, max]: ``lognormal`` (median, sigma) or ``uniform``."""
    if dist["dist"] == "lognormal":
        x = dist["median"] * math.exp(dist["sigma"] * _NORMAL.inv_cdf(q))
        x = int(round(x))
    elif dist["dist"] == "uniform":
        x = dist["min"] + int(q * (dist["max"] - dist["min"] + 1))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return max(dist["min"], min(dist["max"], x))


def lengths(dist: dict, n: int) -> np.ndarray:
    return np.asarray([quantile(dist, (i + 0.5) / n) for i in range(n)],
                      np.int64)


def request_pool(traffic: dict, vocab: int, seed: int) -> list[tuple]:
    """(prompt tokens, output tokens) of every request of the pool, in
    the order the clients send them."""
    n = traffic["pool"]
    block = traffic["block"]
    rng = np.random.default_rng([seed, 1])
    p_set = lengths(traffic["prompt"], block)
    o_set = lengths(traffic["output"], block)
    prompts = np.concatenate([rng.permutation(p_set)
                              for _ in range(n // block)])
    outputs = np.concatenate([rng.permutation(o_set)
                              for _ in range(n // block)])
    return [(rng.integers(0, vocab, int(p)).astype(np.int32), int(o))
            for p, o in zip(prompts, outputs)]


def train_rows(seed: int, step: int, rows: int, seq: int,
               vocab: int) -> dict[str, np.ndarray]:
    """Step ``step``'s batch: ``tokens`` and next-token ``labels``,
    (rows, seq) int64 each."""
    out = np.empty((rows, seq + 1), np.int64)
    for r in range(rows):
        rng = np.random.default_rng([seed, 2, step, r])
        base = rng.integers(0, vocab, size=seq // 8 + 2)
        stream = np.repeat(base, 8)[:seq + 1]
        noise = rng.integers(0, vocab, size=seq + 1)
        out[r] = np.where(rng.random(seq + 1) < 0.15, noise, stream)
    return {"tokens": out[:, :-1], "labels": out[:, 1:]}
