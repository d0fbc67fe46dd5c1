"""The fused attention kernel's pieces that run here
(repro_torch.kernels.attention): the exact three-piece split of its fp32
operands, its plain version (forward and hand-written backward) against
autograd through the walk (``layers.flash_attention``), the tile ranges
its programs walk, that walk itself replayed tile by tile in PyTorch, and
the route ``attention_apply`` takes with its ``attn.kernel`` /
``attn.walk`` counters, and the work the kernel reports to a program
analysis on meta tensors.  The ``cuda``-marked tests hold the kernels
against the plain version on a card and skip without one.

The walk masks keys at positions >= T only when it pads its last key
block; the kernel, as the reference with no ``kv_len``, always does.
The comparisons with the walk therefore pass it ``kv_len=T``.

Tolerances.  In fp32 the plain version and the walk sum the same exact
products (bf16 x bf16, and bf16 x the exact pieces of P and dS) in other
orders, over at most a few hundred keys here: ~1e-6 of a tensor's
largest magnitude, held at ATOL = 1e-5.  Through bf16 tensors each side
rounds its fp32 result to bf16 once, so two elements differ by at most
one bf16 rounding of either, 2**-8 of its magnitude (BF16)."""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import attention as A
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.obs.registry import get_registry

ATOL = 1e-5
BF16 = 2.0 ** -8


def _bf16_valued(gen, *shape):
    """fp32 values that bf16 holds exactly (the kernel's operands)."""
    return torch.randn(*shape, generator=gen).to(torch.bfloat16).float()


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _within_bf16(got, want) -> bool:
    got, want = got.float(), want.float()
    slack = BF16 * (got.abs() + want.abs()) + ATOL * want.abs().max()
    return bool(((got - want).abs() <= slack).all())


# ------------------------------------------------------------ the split
def _exact(x: torch.Tensor) -> bool:
    """hi + mid + lo == x, summed in fp64 and in fp32, the fp32 sum
    bitwise (a -0 sums to +0, the same value)."""
    hi, mid, lo = A.split3(x)
    in_f64 = hi.double() + mid.double() + lo.double()
    in_f32 = (hi.float() + mid.float()) + lo.float()
    bits = in_f32.view(torch.int32) == x.view(torch.int32)
    return bool((in_f64 == x.double()).all() and (bits | (x == 0)).all())


def test_split3_is_exact_over_the_exponent_range():
    """hi + mid + lo == x bitwise for every fp32 exponent from
    2**-SPLIT_EXACT up to 2**126, both signs, random mantissas and the
    extreme ones; zeros and the P of -inf-masked scores too."""
    gen = torch.Generator().manual_seed(0)
    exps = torch.arange(127 - A.SPLIT_EXACT, 254, dtype=torch.int32)
    mant = torch.randint(0, 1 << 23, (exps.numel(), 512), generator=gen,
                         dtype=torch.int32)
    mant[:, 0], mant[:, 1] = 0, (1 << 23) - 1
    bits = (exps[:, None] << 23) | mant
    x = bits.view(torch.float32).flatten()
    assert bool(torch.isfinite(x).all())
    assert _exact(x) and _exact(-x)
    masked = torch.where(torch.rand(64, generator=gen) < 0.5, -torch.inf,
                         torch.randn(64, generator=gen))
    p = torch.exp(masked - masked.max())
    assert _exact(torch.cat([p, torch.zeros(2), -torch.zeros(2)]))


@pytest.mark.parametrize("operand", ["P", "dS"])
def test_the_shifts_bring_every_operand_into_the_exact_range(operand):
    """Below 2**-SPLIT_EXACT the split is not exact (bf16's last bit
    under the normal range is 2**-133), so the kernels split P * 2**64
    and dS * 2**40: every fp32 P in [0, 1], subnormals included, and
    every dS from the least subnormal to 2**87 in magnitude lands in the
    exact range, and the shift is undone exactly on the fp32 sums."""
    tiny = torch.tensor([2.0 ** -126 * (1 + 2.0 ** -23)])
    assert not _exact(tiny)
    assert not _exact(torch.tensor([3.4e38]))
    gen = torch.Generator().manual_seed(1)
    lo, hi = (-149, 0) if operand == "P" else (-149, 86)
    shift = A.P_SHIFT if operand == "P" else A.DS_SHIFT
    exps = torch.arange(lo, hi + 1, dtype=torch.float64)
    x = (torch.rand((exps.numel(), 256), generator=gen, dtype=torch.float64)
         + 1) * torch.pow(2.0, exps)[:, None]
    x = torch.cat([x.flatten().float(), torch.tensor([2.0 ** -149, 0.0])])
    if operand == "P":
        x = torch.cat([x.clamp(max=1.0), torch.tensor([1.0])])
    else:
        x = torch.cat([x, -x])
    assert bool((x != 0).sum() > 0)
    shifted = x * 2.0 ** shift
    assert torch.equal(shifted * 2.0 ** -shift, x)
    assert _exact(shifted)


# -------------------------------------------- plain version vs the walk
def _case(gen, B, S, H, KV, hd):
    q, do = _bf16_valued(gen, B, S, H, hd), _bf16_valued(gen, B, S, H, hd)
    k, v = _bf16_valued(gen, B, S, KV, hd), _bf16_valued(gen, B, S, KV, hd)
    return q, k, v, do


def _walk_with_grads(q, k, v, do, qpos, kpos, causal):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = L.flash_attention(*leaves, q_positions=qpos, kv_positions=kpos,
                            causal=causal, kv_len=k.shape[1])
    out.backward(do)
    return out.detach(), *(t.grad for t in leaves)


@pytest.mark.parametrize("hd", A.HEAD_DIMS)
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "noncausal"])
def test_plain_version_matches_autograd_through_the_walk(causal, G, hd):
    """In fp32 (bf16-valued operands, as on the card): the output, dQ,
    dK and dV within ATOL of each tensor's scale; S = 200 is no multiple
    of any tile, and the positions start at 37 (the keys from position
    200 on are visible to no query)."""
    gen = torch.Generator().manual_seed(G * hd + causal)
    B, S, KV = 2, 200, 2
    q, k, v, do = _case(gen, B, S, KV * G, KV, hd)
    pos = torch.arange(37, 37 + S)
    o, o32, lse = A.fused_attention_plain(q, k, v, pos, pos, causal)
    grads = A.fused_attention_plain_backward(q, k, v, pos, pos, causal, o32,
                                             lse, do)
    want = _walk_with_grads(q, k, v, do, pos, pos, causal)
    assert torch.equal(o, o32)
    for got, ref in zip((o32, *grads), want):
        assert _rel(got, ref) <= ATOL


@pytest.mark.parametrize("rows", ["shared", "per-row"])
def test_fused_attention_through_autograd_in_bf16(rows):
    """``fused_attention`` on bf16 CPU tensors (the autograd Function with
    the plain version inside) against the walk's bf16 autograd: output
    and gradients within one bf16 rounding.  Per-row positions put the
    first queries of row 0 before every key: those rows get zeros and
    pass no gradient, as in the walk."""
    gen = torch.Generator().manual_seed(7)
    B, S, H, KV, hd = 2, 96, 4, 2, 64
    q, k, v, do = (t.to(torch.bfloat16) for t in _case(gen, B, S, H, KV,
                                                       hd))
    kpos = torch.arange(S)
    qpos = kpos if rows == "shared" else torch.stack([kpos - 5, kpos])
    launches = A.fused_attention.launches
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = A.fused_attention(*leaves, q_positions=qpos, kv_positions=kpos)
    out.backward(do)
    want = _walk_with_grads(q, k, v, do, qpos, kpos, True)
    assert out.dtype == torch.bfloat16
    for got, ref in zip((out.detach(), *(t.grad for t in leaves)), want):
        assert _within_bf16(got, ref)
    if rows == "per-row":
        assert not bool(out[0, :5].any())
        assert not bool(leaves[0].grad[0, :5].any())
    assert A.fused_attention.launches == launches   # no CUDA launch


def test_fused_attention_refuses_what_it_cannot_take():
    q = torch.zeros(1, 8, 4, 64)
    k = torch.zeros(1, 8, 3, 64)
    with pytest.raises(ValueError):
        A.fused_attention(q, k, k, q_positions=torch.arange(8),
                          kv_positions=torch.arange(8))
    with pytest.raises(ValueError):
        A.fused_attention(q, q, q, q_positions=torch.arange(8)[None],
                          kv_positions=torch.arange(8)[None])


# ------------------------------------------------------ the tile walk
def _positions(kind, gen, B, S):
    base = torch.arange(S)
    if kind == "arange":
        return base, base
    if kind == "offset":
        return base + 50, base + 50
    if kind == "per-row":
        return (torch.randint(-5, S + 5, (B, S), generator=gen),
                torch.randperm(S, generator=gen))
    return (torch.randint(0, 40, (S,), generator=gen),
            torch.randint(0, 40, (S,), generator=gen))


KINDS = ["arange", "offset", "per-row", "repeated"]


@pytest.mark.parametrize("kind", KINDS)
def test_tile_ranges_are_exact(kind):
    """Every (query tile, key tile) pair: before k_full (and from q_full)
    every key of the tile is visible to every query, from k_hi (and
    before q_lo) none is; ragged tiles included, and keys at positions
    >= T visible to none."""
    gen = torch.Generator().manual_seed(KINDS.index(kind))
    B = 2
    for S, BM, BN, causal in ((200, 64, 64, True), (257, 128, 64, True),
                              (130, 64, 64, False), (64, 128, 64, True)):
        qpos, kpos = _positions(kind, gen, B, S)
        r = A.tile_ranges(qpos, kpos, BM, BN, causal)
        q2 = qpos if qpos.ndim == 2 else qpos[None].expand(B, S)
        vis = (kpos < S)[None, None, :].expand(B, S, S)
        if causal:
            vis = vis & (kpos[None, None, :] <= q2[:, :, None])
        for b in range(B):
            rb = min(b, r["k_full"].shape[0] - 1)
            for i in range(-(-S // BM)):
                for j in range(-(-S // BN)):
                    blk = vis[b, i * BM:(i + 1) * BM, j * BN:(j + 1) * BN]
                    if j < r["k_full"][rb, i]:
                        assert blk.all() and blk.shape[1] == BN
                    if j >= r["k_hi"][rb, i] or i < r["q_lo"][rb, j]:
                        assert not blk.any()
                    if i >= r["q_full"][rb, j]:
                        assert blk.all()
    if kind == "arange":
        r = A.tile_ranges(torch.arange(256), torch.arange(256), 64, 64, True)
        assert r["k_full"].tolist() == [[0, 1, 2, 3]]
        assert r["k_hi"].tolist() == [[1, 2, 3, 4]]
        assert r["q_lo"].tolist() == [[0, 1, 2, 3]]
        assert r["q_full"].tolist() == [[1, 2, 3, 4]]


def test_tile_tables_are_reused_while_the_positions_are_unchanged():
    """The launchers' tables (int32 positions, the keys' effective
    positions, both kernels' tile_ranges as B rows) are computed once for
    a positions tensor and used again while it is the same object at the
    same in-place version, causal, batch and head size; positions made
    under inference_mode have no version and are computed at every
    call."""
    pos = torch.arange(300)
    n = A._ranges.computed
    first = A._ranges(pos, pos, True, 2, 64)
    assert A._ranges(pos, pos, True, 2, 64) is first
    assert A._ranges.computed == n + 1
    qp, kpe, tables = first
    fwd = A.tile_ranges(pos, pos, A.Q_TILE, A.K_TILE, True)
    bwd = A.tile_ranges(pos, pos, A.q_stage(64), A.KV_TILE, True)
    for name, want in (("k_full", fwd), ("k_hi", fwd), ("q_lo", bwd),
                       ("q_full", bwd)):
        assert torch.equal(tables[name], want[name].expand(2, -1))
    assert qp.dtype == kpe.dtype == torch.int32
    assert torch.equal(kpe, pos.to(torch.int32))
    A._ranges(pos, pos, False, 2, 64)
    A._ranges(pos, pos.clone(), False, 2, 64)
    A._ranges(pos, pos.clone(), False, 2, 128)
    pos.add_(1)
    again = A._ranges(pos, pos, True, 2, 64)
    assert again is not first and A._ranges.computed == n + 5
    assert torch.equal(again[0], first[0] + 1)
    assert int(again[1][-1]) == A.BIG          # position 300 >= T
    with torch.inference_mode():               # no version to key on
        ipos = torch.arange(64)
        A._ranges(ipos, ipos, False, 1, 64)
        fresh = A._ranges(ipos, ipos, False, 1, 64)
    assert A._ranges.computed == n + 7
    assert A._ranges(pos, pos, True, 2, 64) is again


def _tiled(q, k, v, do, qpos, kpos, causal):
    """The kernels' walk replayed in fp32: the forward's online softmax
    over its key tiles, dQ over the same (Q_TILE queries, K_TILE keys a
    tile), dK/dV over the query tiles of every head of the group
    (KV_TILE keys, q_stage(hd) queries a tile), each from tile_ranges,
    masked only where the ranges say; a fresh sum for each tile's
    products, added to the running one."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    BM, BN = A.Q_TILE, A.K_TILE
    BQ, BKV = A.q_stage(hd), A.KV_TILE
    scale = 1 / math.sqrt(hd)
    P, D = 2.0 ** A.P_SHIFT, 2.0 ** A.DS_SHIFT
    qe, ke = A.effective_positions(qpos, kpos, causal)
    q2 = qe if qe.ndim == 2 else qe[None].expand(B, S)
    r = A.tile_ranges(qpos, kpos, BM, BN, causal)
    rk = A.tile_ranges(qpos, kpos, BQ, BKV, causal)
    row = (lambda t, b: t[min(b, t.shape[0] - 1)])
    o32 = torch.zeros(B, S, H, hd)
    lse = torch.zeros(B, H, S)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    delta = torch.zeros(B, H, S)

    def scores(b, h, rows, cols, masked):
        s = (q[b, rows, h] @ k[b, cols, h // G].T) * scale
        if masked:
            s = torch.where(ke[cols][None] <= q2[b, rows][:, None], s,
                            -torch.inf)
        return s
    for b in range(B):
        for h in range(H):
            for i in range(-(-S // BM)):
                rows = torch.arange(i * BM, min(S, (i + 1) * BM))
                m = torch.full((len(rows),), -torch.inf)
                tot, acc = torch.zeros(len(rows)), torch.zeros(len(rows), hd)
                kf, kh = int(row(r["k_full"], b)[i]), int(row(r["k_hi"], b)[i])
                for j in range(kh):
                    cols = torch.arange(j * BN, min(S, (j + 1) * BN))
                    s = scores(b, h, rows, cols, j >= kf)
                    m_new = torch.maximum(m, s.amax(1))
                    ms = torch.where(torch.isinf(m_new), 0.0, m_new)
                    p = torch.exp(s - ms[:, None])
                    a = torch.exp(m - ms)
                    tot = tot * a + p.sum(1)
                    acc = A.split_matmul(p * P, v[b, cols, h // G]) + \
                        acc * a[:, None]
                    m = m_new
                o = acc / (tot.clamp(min=1e-20) * P)[:, None]
                o32[b, rows, h] = o
                ms = torch.where(torch.isinf(m), 0.0, m)
                lse[b, h, rows] = torch.where(tot > 0, ms + torch.log(tot),
                                              torch.inf)
                delta[b, h, rows] = (do[b, rows, h] * o).sum(1)
                for j in range(kh):
                    cols = torch.arange(j * BN, min(S, (j + 1) * BN))
                    p = torch.exp(scores(b, h, rows, cols, j >= kf)
                                  - lse[b, h, rows][:, None])
                    ds = p * (do[b, rows, h] @ v[b, cols, h // G].T
                              - delta[b, h, rows][:, None])
                    dq[b, rows, h] += A.split_matmul(ds * D, k[b, cols, h // G])
    dq *= scale / D
    for b in range(B):
        for kvh in range(k.shape[2]):
            for j in range(-(-S // BKV)):
                cols = torch.arange(j * BKV, min(S, (j + 1) * BKV))
                ql, qf = int(row(rk["q_lo"], b)[j]), int(row(rk["q_full"], b)[j])
                for h in range(kvh * G, (kvh + 1) * G):
                    for i in range(ql, -(-S // BQ)):
                        rows = torch.arange(i * BQ, min(S, (i + 1) * BQ))
                        pt = torch.exp(scores(b, h, rows, cols, i < qf).T
                                       - lse[b, h, rows][None])
                        dv[b, cols, kvh] += A.split_matmul(pt * P,
                                                           do[b, rows, h])
                        dst = pt * (v[b, cols, kvh] @ do[b, rows, h].T
                                    - delta[b, h, rows][None])
                        dk[b, cols, kvh] += A.split_matmul(dst * D,
                                                           q[b, rows, h])
    return o32, lse, dq, dk * scale / D, dv / P


@pytest.mark.parametrize("kind", KINDS)
def test_the_kernels_tile_walk_matches_the_plain_version(kind):
    """Replayed tile by tile (``_tiled``) with the kernels' tiles and a
    ragged last tile: the output, log-sum-exp and
    gradients within ATOL of the plain version's."""
    gen = torch.Generator().manual_seed(11 + KINDS.index(kind))
    B, S, H, KV, hd = 2, 150, 4, 2, 64
    q, k, v, do = _case(gen, B, S, H, KV, hd)
    qpos, kpos = _positions(kind, gen, B, S)
    got = _tiled(q, k, v, do, qpos, kpos, True)
    _, o32, lse = A.fused_attention_plain(q, k, v, qpos, kpos, True)
    want = (o32, lse, *A.fused_attention_plain_backward(
        q, k, v, qpos, kpos, True, o32, lse, do))
    assert torch.equal(torch.isinf(got[1]), torch.isinf(lse))
    fin = torch.isfinite(lse)
    assert _rel(got[1][fin], lse[fin]) <= ATOL
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        assert _rel(g, w) <= ATOL


@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "noncausal"])
def test_keys_past_the_length_are_masked_at_any_positions(causal):
    """Positions from 100 over T = 160 keys: the keys at positions 160 and
    on are visible to no query, as in the reference with no ``kv_len``
    (the walk given ``kv_len=T``).  The plain version and the tile walk
    (at head size 128, GQA 4) agree with it, and differ from the walk
    without ``kv_len``, which lets those keys through when it does not
    pad its last block."""
    gen = torch.Generator().manual_seed(100 + causal)
    B, S, H, KV, hd = 1, 160, 4, 1, 128
    q, k, v, do = _case(gen, B, S, H, KV, hd)
    pos = torch.arange(100, 100 + S)
    _, o32, lse = A.fused_attention_plain(q, k, v, pos, pos, causal)
    grads = A.fused_attention_plain_backward(q, k, v, pos, pos, causal, o32,
                                             lse, do)
    want = _walk_with_grads(q, k, v, do, pos, pos, causal)
    for got, ref in zip((o32, *grads), want):
        assert _rel(got, ref) <= ATOL
    tiled = _tiled(q, k, v, do, pos, pos, causal)
    for got, ref in zip(tiled[:1] + tiled[2:], (o32, *grads)):
        assert _rel(got, ref) <= ATOL
    assert not bool(grads[1][0, 60:].any()) and not bool(
        grads[2][0, 60:].any())
    unmasked = L.flash_attention(q, k, v, q_positions=pos, kv_positions=pos,
                                 causal=causal)
    assert _rel(o32, unmasked) > 1e-2


def test_a_permuted_q_gives_the_contiguous_result():
    """A dense q whose strides are permuted ((B, H, S, hd) transposed)
    through autograd gives the output and gradients of the contiguous
    one; the launchers take every operand through ``_dense``, which
    leaves a contiguous aligned tensor as it is."""
    gen = torch.Generator().manual_seed(9)
    B, S, H, KV, hd = 2, 80, 4, 2, 64
    q, k, v, do = (t.to(torch.bfloat16) for t in _case(gen, B, S, H, KV,
                                                       hd))
    pos = torch.arange(S)
    permuted = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not permuted.is_contiguous() and torch.equal(permuted, q)
    res = []
    for qq in (q, permuted):
        leaves = [qq.detach().requires_grad_(),
                  k.clone().requires_grad_(), v.clone().requires_grad_()]
        out = A.fused_attention(*leaves, q_positions=pos, kv_positions=pos)
        out.backward(do)
        res.append((out.detach(), *(t.grad for t in leaves)))
    for a, b in zip(*res):
        assert torch.equal(a, b)
    assert A._dense(q) is q and A._dense(permuted).is_contiguous()


def test_a_program_analysis_counts_the_kernel_and_its_work():
    """On the meta tensors of a program analysis a bf16 remat training
    step at head size 64 routes its attention to the kernel, as the card
    does: 2 x layers forward calls (the forward and the recompute) and
    one backward a layer, each reporting attention_work's flops and
    bytes, and no walk."""
    from repro_torch.launch.hlo_analysis import analyze_program
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import jit_train_step
    cfg = dataclasses.replace(get_config("stablelm-1.6b", smoke=True),
                              head_dim=64, compute_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(), "meta", masters=True)
    B, S = 2, 48
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int64),
             "labels": torch.zeros((B, S), dtype=torch.int64)}
    step = jit_train_step(model, opt.AdamWConfig(), remat=True)
    reg = get_registry()
    before = (reg.get("attn.kernel"), reg.get("attn.walk"))
    res = analyze_program(step, params, opt.init_state(params), batch)
    assert (reg.get("attn.kernel") - before[0],
            reg.get("attn.walk") - before[1]) == (2 * cfg.layers, 0)
    k = res["kernels"]
    shape = f"{B}x{S}x{S}x{cfg.n_heads}x{cfg.kv_heads}x64"
    assert k["fused_attention.forward"] == {"calls": 2 * cfg.layers,
                                            "shapes": {shape: 2 * cfg.layers}}
    assert k["fused_attention.backward"] == {"calls": cfg.layers,
                                             "shapes": {shape: cfg.layers}}
    work = A.attention_work(B, S, S, cfg.n_heads, cfg.kv_heads, 64, True)
    assert work["forward_flops"] == 4 * 2 * B * cfg.n_heads * 64 * S * (S + 1) // 2
    assert res["flops_by_dtype"]["bfloat16"] >= cfg.layers * (
        2 * work["forward_flops"] + work["backward_flops"])


# ------------------------------------------------------------ the route
ROUTES = {
    "self, no cache": ({}, "kernel"),
    "noncausal": ({"causal": False}, "kernel"),
    "window inactive": ({"window": 8, "window_active": False}, "kernel"),
    "with a cache": ({"cache": True}, "walk"),
    "cross-attention": ({"xkv": True}, "walk"),
    "window active": ({"window": 8, "window_active": True}, "walk"),
    "window always": ({"window": 8}, "walk"),
    "window per layer": ({"window": 8, "window_active": "tensor"}, "walk"),
    "softcap": ({"softcap": 30.0}, "walk"),
    "head 16": ({"head_dim": 16}, "walk"),
    "fp32": ({"dtype": torch.float32}, "walk"),
    "not on the kernel's device": ({"on_device": False}, "walk"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_attention_apply_routes_by_what_the_call_can_observe(case,
                                                             monkeypatch):
    """With the CPU standing in for the kernel's device
    (``on_kernel_device``), the calls that have no
    cache, no cross-attention, no softcap and no active window, at a
    kernel head size in bf16, run ``fused_attention`` (its plain version
    here) and count ``attn.kernel``; every other call runs the walk and
    counts ``attn.walk``, and its output is the walk's."""
    kw, want = ROUTES[case]
    kw = dict(kw)
    on_device = kw.pop("on_device", True)
    monkeypatch.setattr(L, "on_kernel_device", lambda t: on_device)
    dtype = kw.pop("dtype", torch.bfloat16)
    hd = kw.pop("head_dim", 64)
    gen = torch.Generator().manual_seed(3)
    B, S, d, H = 2, 24, 32, 2
    p = {n: {"w": (torch.randn(d, H * hd, generator=gen) * 0.2).to(dtype)}
         for n in ("wq", "wk", "wv")}
    p["wo"] = {"w": (torch.randn(H * hd, d, generator=gen) * 0.2).to(dtype)}
    x = torch.randn(B, S, d, generator=gen).to(dtype)
    if kw.pop("cache", False):
        kw["cache"] = {"k": torch.zeros(B, S, H, hd, dtype=dtype),
                       "v": torch.zeros(B, S, H, hd, dtype=dtype)}
    if kw.pop("xkv", False):
        kw["xkv"] = torch.randn(B, 10, d, generator=gen).to(dtype)
    if kw.get("window_active") == "tensor":
        kw["window_active"] = torch.tensor(True)
    reg = get_registry()
    before = (reg.get("attn.kernel"), reg.get("attn.walk"))
    calls = []
    monkeypatch.setattr(L, "fused_attention",
                        lambda *a, **k: calls.append(1)
                        or A.fused_attention(*a, **k))
    out, _ = L.attention_apply(p, x, n_heads=H, kv_heads=H, head_dim=hd,
                               rope_theta=10000.0,
                               q_positions=torch.arange(S), **kw)
    moved = (reg.get("attn.kernel") - before[0],
             reg.get("attn.walk") - before[1])
    assert moved == ((1, 0) if want == "kernel" else (0, 1))
    assert len(calls) == (want == "kernel")
    monkeypatch.setattr(L, "on_kernel_device", lambda t: False)
    if "cache" in kw:
        kw["cache"] = {n: torch.zeros_like(t) for n, t in kw["cache"].items()}
    walk, _ = L.attention_apply(p, x, n_heads=H, kv_heads=H, head_dim=hd,
                                rope_theta=10000.0,
                                q_positions=torch.arange(S), **kw)
    assert _within_bf16(out, walk) if want == "kernel" else \
        torch.equal(out, walk)


def test_a_remat_loss_takes_the_kernel_in_every_layer(monkeypatch):
    """A dense model in bf16 at head size 64 (stablelm's smoke config,
    widened), the CPU standing in for the kernel's device: its loss under grad
    with full remat calls the kernel twice a layer (the forward and the
    recompute) and the walk never, and its loss and gradients agree with
    the walk's to bf16 rounding."""
    cfg = dataclasses.replace(get_config("stablelm-1.6b", smoke=True),
                              head_dim=64, compute_dtype="bfloat16")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init_params(gen, "cpu", masters=True)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def loss_and_grads():
        leaves = {n: t.clone().requires_grad_()
                  for n, t in params["layers"]["attn"]["wq"].items()}
        ps = dict(params, layers=dict(params["layers"], attn=dict(
            params["layers"]["attn"], wq=leaves)))
        loss = model.loss(ps, batch, remat=True)
        loss.backward()
        return float(loss.detach()), leaves["w"].grad
    reg = get_registry()
    monkeypatch.setattr(L, "on_kernel_device", lambda t: True)
    before = (reg.get("attn.kernel"), reg.get("attn.walk"))
    got = loss_and_grads()
    assert (reg.get("attn.kernel") - before[0],
            reg.get("attn.walk") - before[1]) == (2 * cfg.layers, 0)
    monkeypatch.setattr(L, "on_kernel_device", lambda t: False)
    want = loss_and_grads()
    assert abs(got[0] - want[0]) <= 1e-2 * abs(want[0])
    assert _rel(got[1], want[1]) <= 0.05


# ------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the fused attention kernels run only "
                    "there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hd", A.HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "noncausal"])
def test_cuda_kernels_match_the_plain_version(cuda_device, causal, hd):
    """On the card, 2 x 300 tokens, 8 query heads on 2 KV heads,
    positions from 100 (the keys from position 300 on visible to no
    query): the kernels' fp32 output, log-sum-exp and fp32 gradients
    within ATOL of the plain version's on the same card; the
    log-sum-exp's padding past S is +inf."""
    gen = torch.Generator().manual_seed(hd + causal)
    q, k, v, do = (t.to(cuda_device) for t in _case(gen, 2, 300, 8, 2, hd))
    pos = torch.arange(100, 400, device=cuda_device)
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    o, o32, lse = A._launch_forward(*bf, pos, pos, causal)
    grads = A._launch_backward(*bf, pos, pos, causal, o32, lse,
                               do.to(torch.bfloat16),
                               grad_dtype=torch.float32)
    torch.cuda.synchronize()
    _, p32, plse = A.fused_attention_plain(q, k, v, pos, pos, causal)
    pgrads = A.fused_attention_plain_backward(q, k, v, pos, pos, causal,
                                              p32, plse, do)
    assert _rel(o32, p32) <= ATOL and _rel(lse[..., :300], plse) <= ATOL
    assert bool(torch.isinf(lse[..., 300:]).all())
    for g, w in zip(grads, pgrads):
        assert _rel(g, w) <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["per-row positions", "permuted q"])
def test_cuda_kernels_take_per_row_positions_and_any_strides(cuda_device,
                                                             layout):
    """Per-row query positions (some rows before every key) and a dense q
    with permuted strides: output and gradients through autograd within
    one bf16 rounding of the plain version's on the card."""
    gen = torch.Generator().manual_seed(21)
    B, S, H, KV, hd = 2, 200, 4, 2, 64
    q, k, v, do = (t.to(cuda_device, torch.bfloat16)
                   for t in _case(gen, B, S, H, KV, hd))
    kpos = torch.arange(S, device=cuda_device)
    qpos = kpos
    if layout == "permuted q":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        qpos = torch.stack([kpos - 7, kpos])
    res = []
    for device in (cuda_device, "cpu"):
        leaves = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
        out = A.fused_attention(*leaves, q_positions=qpos.to(device),
                                kv_positions=kpos.to(device))
        out.backward(do.to(device))
        res.append([t.detach().cpu() for t in (out, *(x.grad
                                                      for x in leaves))])
    for got, want in zip(*res):
        assert _within_bf16(got, want)


@pytest.mark.cuda
def test_cuda_kernels_count_their_launches(cuda_device):
    gen = torch.Generator().manual_seed(5)
    q, k, v, do = (t.to(cuda_device, torch.bfloat16)
                   for t in _case(gen, 1, 128, 4, 4, 64))
    pos = torch.arange(128, device=cuda_device)
    n = (A.fused_attention.launches, A.fused_attention.backward_launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    A.fused_attention(*leaves, q_positions=pos,
                      kv_positions=pos).backward(do)
    assert (A.fused_attention.launches - n[0],
            A.fused_attention.backward_launches - n[1]) == (1, 1)
