"""The port's KV-blocked flash attention and its attention layer
(repro_torch.models.layers.flash_attention / attention_apply) against the
reference's (repro.models.layers), in fp32 on the same inputs: causal and
not, sliding windows with the local/global switch, the attention softcap,
per-row valid lengths, GQA, rows with no visible key, one and several key
blocks (the last one padded), cross-attention and a static cache."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

TOL = 1e-5
B, H, HD = 2, 4, 16

# (name, keyword arguments of both functions): kv_len "rows" is a (B,)
# length per row, "empty" one where the first row sees no key at all
KINDS = {
    "causal": dict(causal=True),
    "noncausal": dict(causal=False),
    "window-active": dict(window=5, window_active=True),
    "window-inactive": dict(window=5, window_active=False),
    "window-always": dict(window=5, window_active=None),
    "softcap": dict(softcap=0.5),
    "kvlen-int": dict(kv_len="int"),
    "kvlen-rows": dict(kv_len="rows"),
    "no-valid-key": dict(kv_len="empty"),
}
# (T, S, block): one key, one whole block, three blocks of 512 with the
# last padded, and T 20 at block 8
SIZES = [(1, 1, 512), (512, 7, 512), (1200, 5, 512), (20, 6, 8)]


def _inputs(T, S, kv_heads, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, T, kv_heads, HD)).astype(np.float32)
    v = rng.standard_normal((B, T, kv_heads, HD)).astype(np.float32)
    return q, k, v


def _both(q, k, v, *, q_positions, kv_positions, kv_len=None, **kw):
    """The reference's and the port's outputs on the same numpy inputs."""
    jkv = tkv = None
    if kv_len is not None:
        jkv, tkv = jnp.asarray(kv_len), torch.as_tensor(kv_len)
        if np.ndim(kv_len) == 0:
            tkv = int(kv_len)
    want = JL.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(q_positions),
        kv_positions=jnp.asarray(kv_positions), kv_len=jkv, **kw)
    got = TL.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=torch.as_tensor(q_positions),
        kv_positions=torch.as_tensor(kv_positions), kv_len=tkv, **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("T,S,block", SIZES,
                         ids=[f"T{t}-b{b}" for t, _, b in SIZES])
@pytest.mark.parametrize("kind", list(KINDS))
def test_flash_attention_matches_reference(kind, T, S, block):
    kw = dict(KINDS[kind])
    q, k, v = _inputs(T, S, 2, seed=T + S)
    # the queries are the last S positions of the keys, per row offset
    # by one where kv_len is per row
    qpos = np.arange(T - S, T, dtype=np.int32)
    mode = kw.pop("kv_len", None)
    if mode == "int":
        kw["kv_len"] = np.int32(max(T - 1, 1))
    elif mode in ("rows", "empty"):
        kw["kv_len"] = np.array([0 if mode == "empty" else max(T - 2, 1),
                                 T], np.int32)
        qpos = np.stack([qpos - 1, qpos]).clip(0)
    got, want = _both(q, k, v, q_positions=qpos,
                      kv_positions=np.arange(T, dtype=np.int32),
                      block=block, **kw)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if mode == "empty":
        assert not got[0].any()


@pytest.mark.parametrize("kv_heads", [1, 2, 4], ids=["mqa", "gqa", "mha"])
def test_flash_attention_head_grouping(kv_heads):
    q, k, v = _inputs(40, 9, kv_heads, seed=kv_heads)
    got, want = _both(q, k, v, q_positions=np.arange(31, 40),
                      kv_positions=np.arange(40), window=12, softcap=3.0,
                      block=16)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("active", [True, False])
def test_flash_attention_window_switch_as_tensor(active):
    """The reference's per-layer switch is a traced bool under its
    scan-over-layers; the port takes a bool tensor the same way."""
    q, k, v = _inputs(30, 4, 2, seed=7)
    want = JL.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)),
        q_positions=jnp.arange(26, 30), kv_positions=jnp.arange(30),
        window=6, window_active=jnp.asarray(active), block=8)
    got = TL.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        q_positions=torch.arange(26, 30), kv_positions=torch.arange(30),
        window=6, window_active=torch.tensor(active), block=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_one_block_has_no_carry_ops():
    """At T <= block the walk is one block: no rescale of a carry, so no
    more ops than a single softmax (exp is taken once, on the scores)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(64, 3, 2, seed=1))
    calls = []
    exp = torch.exp

    def counted(t, *a, **kw):
        calls.append(tuple(t.shape))
        return exp(t, *a, **kw)

    torch.exp = counted
    try:
        TL.flash_attention(q, k, v, q_positions=torch.arange(61, 64),
                           kv_positions=torch.arange(64), kv_len=64)
        assert len(calls) == 1
        calls.clear()
        TL.flash_attention(q, k, v, q_positions=torch.arange(61, 64),
                           kv_positions=torch.arange(64), kv_len=64,
                           block=16)
        assert len(calls) == 4 + 3        # each block's p, three carries
    finally:
        torch.exp = exp


def _attn_params(rng, d, H, KV, hd):
    shapes = {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
              "wo": (H * hd, d)}
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in shapes.items()}
    return ({k: {"w": jnp.asarray(v)} for k, v in p.items()},
            {k: {"w": torch.from_numpy(v)} for k, v in p.items()})


DIMS = dict(n_heads=4, kv_heads=2, head_dim=16)


@pytest.mark.parametrize("src_len", [6, 700], ids=["one-block", "blocks"])
def test_attention_apply_cross_attention(src_len):
    """xkv: keys and values from the source, no rope on them, positions
    arange(src_len), non-causal."""
    rng = np.random.default_rng(src_len)
    jp, tp = _attn_params(rng, 64, 4, 2, 16)
    x = rng.standard_normal((B, 5, 64)).astype(np.float32)
    src = rng.standard_normal((B, src_len, 64)).astype(np.float32)
    pos = np.arange(3, 8)
    want, jc = JL.attention_apply(
        jp, jnp.asarray(x), rope_theta=10000.0, q_positions=jnp.asarray(pos),
        causal=False, xkv=jnp.asarray(src), **DIMS)
    got, tc = TL.attention_apply(
        tp, torch.from_numpy(x), rope_theta=10000.0,
        q_positions=torch.from_numpy(pos), causal=False,
        xkv=torch.from_numpy(src), **DIMS)
    assert jc is None and tc is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("rope_theta", [None, 10000.0])
def test_attention_apply_static_cache(rope_theta):
    """static_cache: the cache's keys and values are attended as they
    are, every position visible, and the cache comes back unchanged."""
    rng = np.random.default_rng(11)
    jp, tp = _attn_params(rng, 64, 4, 2, 16)
    x = rng.standard_normal((B, 3, 64)).astype(np.float32)
    kc = rng.standard_normal((B, 9, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((B, 9, 2, 16)).astype(np.float32)
    jcache = {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}
    tcache = {"k": torch.from_numpy(kc.copy()),
              "v": torch.from_numpy(vc.copy())}
    want, jout = JL.attention_apply(
        jp, jnp.asarray(x), rope_theta=rope_theta,
        q_positions=jnp.arange(4, 7), causal=False, cache=jcache,
        cache_index=jnp.asarray(4), static_cache=True, **DIMS)
    got, tout = TL.attention_apply(
        tp, torch.from_numpy(x), rope_theta=rope_theta,
        q_positions=torch.arange(4, 7), causal=False, cache=tcache,
        cache_index=4, static_cache=True, **DIMS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(tout["k"].numpy(), kc)
    np.testing.assert_array_equal(np.asarray(jout["v"]), vc)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "rows"])
def test_attention_apply_window_softcap_decode_past_one_block(per_row):
    """A windowed, softcapped layer over a cache past one key block:
    prefill of 20, then two decode steps, at block 8, scalar and per-row
    positions."""
    rng = np.random.default_rng(12)
    jp, tp = _attn_params(rng, 64, 4, 2, 16)
    T, S = 30, 20
    kw = dict(rope_theta=10000.0, window=6, window_active=True, softcap=4.0,
              block=8, **DIMS)
    jcache = {"k": jnp.zeros((B, T, 2, 16)), "v": jnp.zeros((B, T, 2, 16))}
    tcache = {"k": torch.zeros((B, T, 2, 16)),
              "v": torch.zeros((B, T, 2, 16))}
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    want, jcache = JL.attention_apply(jp, jnp.asarray(x),
                                      q_positions=jnp.arange(S),
                                      cache=jcache, **kw)
    got, tcache = TL.attention_apply(tp, torch.from_numpy(x),
                                     q_positions=torch.arange(S),
                                     cache=tcache, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    for step in range(2):
        idx = np.array([S + step, S + step - 3]) if per_row else S + step
        x1 = rng.standard_normal((B, 1, 64)).astype(np.float32)
        qpos = np.broadcast_to(np.reshape(idx, (-1, 1)), (B, 1)).copy()
        want, jcache = JL.attention_apply(
            jp, jnp.asarray(x1), q_positions=jnp.asarray(qpos),
            cache=jcache, cache_index=jnp.asarray(idx, jnp.int32), **kw)
        got, tcache = TL.attention_apply(
            tp, torch.from_numpy(x1), q_positions=torch.from_numpy(qpos),
            cache=tcache,
            cache_index=torch.from_numpy(idx) if per_row else idx, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(tcache["k"].numpy(),
                                   np.asarray(jcache["k"]), rtol=TOL,
                                   atol=TOL)
