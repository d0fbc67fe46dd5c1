"""The general generator: seeded draws, their ranges, and the same set
of sizes for every seed."""
from collections import Counter

import numpy as np
import pytest

from portbench.harness import spec
from portbench.harness import traffic as T

SEEDS = (0, 7, 2**31 + 11)


@pytest.mark.parametrize("block", [32, 4096])
def test_pool_lengths_lie_in_range_and_every_seed_draws_the_same_set(block):
    tr = dict(spec.load_json(spec.HERE / "traffic" / "chat.json"),
              block=block)
    pools = [T.request_pool(tr, 1000, s) for s in SEEDS]
    for pool in pools:
        assert len(pool) == tr["pool"]
        p = np.asarray([len(x) for x, _ in pool])
        o = np.asarray([n for _, n in pool])
        assert p.min() >= tr["prompt"]["min"] and \
            p.max() <= tr["prompt"]["max"]
        assert o.min() >= tr["output"]["min"] and \
            o.max() <= tr["output"]["max"]
        assert all(x.dtype == np.int32 and x.max() < 1000 for x, _ in pool)
        # every request fits the cache with its answer
        assert (p + o).max() <= tr["cache_len"]
    lens = [Counter(len(x) for x, _ in pool) for pool in pools]
    assert lens[0] == lens[1] == lens[2]
    assert [len(x) for x, _ in pools[0]] != [len(x) for x, _ in pools[1]]
    outs = [Counter(n for _, n in pool) for pool in pools]
    assert outs[0] == outs[1] == outs[2]


def test_pool_is_a_pure_function_of_the_seed():
    tr = spec.load_json(spec.HERE / "traffic" / "chat.json")
    a, b = T.request_pool(tr, 500, 3), T.request_pool(tr, 500, 3)
    assert all((x == y).all() and m == n for (x, m), (y, n) in zip(a, b))


def test_lognormal_quantiles_center_on_the_median():
    d = {"dist": "lognormal", "median": 512, "sigma": 0.8, "min": 32,
         "max": 2048}
    assert T.quantile(d, 0.5) == 512
    assert T.quantile(d, 1e-9) == 32 and T.quantile(d, 1 - 1e-9) == 2048
    u = {"dist": "uniform", "min": 8, "max": 64}
    xs = T.lengths(u, 57)
    assert sorted(set(xs.tolist())) == list(range(8, 65))


def test_train_rows_are_seeded_distinct_and_shifted():
    a = T.train_rows(5, 0, 2, 64, 100)
    b = T.train_rows(5, 0, 2, 64, 100)
    c = T.train_rows(5, 1, 2, 64, 100)
    assert (a["tokens"] == b["tokens"]).all()
    assert not (a["tokens"] == c["tokens"]).all()
    assert not (a["tokens"][0] == a["tokens"][1]).all()
    assert (a["tokens"][:, 1:] == a["labels"][:, :-1]).all()
    assert a["tokens"].shape == (2, 64) and a["tokens"].max() < 100


def test_each_block_holds_the_same_sizes():
    tr = dict(spec.load_json(spec.HERE / "traffic" / "chat.json"),
              pool=128, block=32)
    for seed in SEEDS:
        pool = T.request_pool(tr, 1000, seed)
        blocks = [Counter(len(x) for x, _ in pool[i:i + 32])
                  for i in range(0, 128, 32)]
        assert all(b == blocks[0] for b in blocks)
        assert sum(blocks[0].values()) == 32
