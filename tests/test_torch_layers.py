"""The port's layer functions (repro_torch.models.layers) against the
reference's repro.models.layers, in fp32 on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

TOL = 1e-5


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(32)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(32)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jx, tx = _pair(x)
    _close(TL.apply_norm(tp, tx, kind), JL.apply_norm(jp, jx, kind))


@pytest.mark.parametrize("pos_rank", [1, 2])
def test_rope(pos_rank):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = np.arange(3, 9, dtype=np.int32)
    if pos_rank == 2:
        pos = np.stack([pos, pos + 5])
    jx, tx = _pair(x)
    want = JL.rope(jx, jnp.asarray(pos), 500000.0)
    _close(TL.rope(tx, torch.from_numpy(pos), 500000.0), want)


def _attn_params(rng, d, H, KV, hd):
    shapes = {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
              "wo": (H * hd, d)}
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in shapes.items()}
    return ({k: {"w": jnp.asarray(v)} for k, v in p.items()},
            {k: {"w": torch.from_numpy(v)} for k, v in p.items()})


DIMS = dict(n_heads=4, kv_heads=2, head_dim=16, rope_theta=500000.0)


def test_attention_prefill_no_cache():
    rng = np.random.default_rng(2)
    jp, tp = _attn_params(rng, 64, 4, 2, 16)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    jx, tx = _pair(x)
    pos = np.arange(7)
    want, _ = JL.attention_apply(jp, jx, q_positions=jnp.asarray(pos),
                                 **DIMS)
    got, cache = TL.attention_apply(tp, tx, q_positions=torch.from_numpy(pos),
                                    **DIMS)
    assert cache is None
    _close(got, want)


def test_attention_prefill_then_scalar_decode():
    """Prefill writes [0, S) of a static cache; two decode steps write at
    scalar positions S and S + 1 and attend over the cache prefix."""
    rng = np.random.default_rng(3)
    B, S, T, d = 2, 6, 12, 64
    jp, tp = _attn_params(rng, d, 4, 2, 16)
    jcache = {"k": jnp.zeros((B, T, 2, 16)), "v": jnp.zeros((B, T, 2, 16))}
    tcache = {"k": torch.zeros((B, T, 2, 16)),
              "v": torch.zeros((B, T, 2, 16))}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    jx, tx = _pair(x)
    want, jcache = JL.attention_apply(
        jp, jx, q_positions=jnp.arange(S), cache=jcache, **DIMS)
    got, tcache = TL.attention_apply(
        tp, tx, q_positions=torch.arange(S), cache=tcache, **DIMS)
    _close(got, want)
    _close(tcache["k"], jcache["k"])
    for step in range(2):
        idx = S + step
        x1 = rng.standard_normal((B, 1, d)).astype(np.float32)
        jx1, tx1 = _pair(x1)
        want, jcache = JL.attention_apply(
            jp, jx1, q_positions=jnp.full((B, 1), idx, jnp.int32),
            cache=jcache, cache_index=jnp.asarray(idx, jnp.int32), **DIMS)
        got, tcache = TL.attention_apply(
            tp, tx1, q_positions=torch.full((B, 1), idx), cache=tcache,
            cache_index=idx, **DIMS)
        _close(got, want)
        _close(tcache["v"], jcache["v"])


@pytest.mark.parametrize("activation", ["silu", "gelu", "sqrelu"])
@pytest.mark.parametrize("use_fused", [False, True], ids=["plain", "fused"])
def test_mlp_apply(activation, use_fused):
    rng = np.random.default_rng(4)
    d, ff = 64, 128
    shapes = {"wg": (d, ff), "wu": (d, ff), "wd": (ff, d)}
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in shapes.items()}
    jp = {k: {"w": jnp.asarray(v)} for k, v in p.items()}
    tp = {k: {"w": torch.from_numpy(v)} for k, v in p.items()}
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    jx, tx = _pair(x)
    # the reference's unfused gelu MLP multiplies the function jax.nn.gelu
    # itself (layers.py:285-287) and raises; its fused path computes it
    want = JL.mlp_apply(jp, jx, activation=activation,
                        use_fused=use_fused or activation == "gelu")
    got = TL.mlp_apply(tp, tx, activation=activation, use_fused=use_fused)
    _close(got, want)


def test_dense_and_embed():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((8, 5)).astype(np.float32)
    e = rng.standard_normal((11, 8)).astype(np.float32)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    toks = np.array([[1, 10, 3]])
    _close(TL.dense({"w": torch.from_numpy(w)}, torch.from_numpy(x)),
           JL.dense({"w": jnp.asarray(w)}, jnp.asarray(x)))
    _close(TL.embed({"e": torch.from_numpy(e)}, torch.from_numpy(toks)),
           JL.embed({"e": jnp.asarray(e)}, jnp.asarray(toks)))
