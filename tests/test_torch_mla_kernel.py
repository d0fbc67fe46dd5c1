"""The latent attention kernel's plain version (``kernels.mla_attention``:
the kernel's splits, tile walk and log-sum-exp combine in PyTorch)
against ``models.mla``'s absorbed attention through two products, at
DeepSeek-V2-Lite's latent widths (16 heads, keys 576 = 512 + 64), on the
CPU; the route through ``mla_apply`` and its ``attn.mla_kernel`` counts;
the wrapper's refusals and its meta branch.  The kernel itself runs on
the card only: the ``cuda``-marked test below (skipped without a card)
and ``chip_smoke.py --mla``.

Tolerance: 1e-5 of the output's scale in fp32, where the two differ only
in the order of their sums."""
import pytest
import torch

from repro_torch.configs.deepseek_v2_lite import CONFIG
from repro_torch.kernels import goma_gemm
from repro_torch.kernels import mla_attention as MK
from repro_torch.models import mla
from repro_torch.obs.registry import get_registry

TOL = 1e-5
H, R, ROPE = 16, 512, 64
CFG = CONFIG.replace(d_model=64)


def close(got, want, tol=TOL):
    return float((got - want).abs().max()) <= tol * float(want.abs().max())


def inputs(B, S, T, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q = 0.05 * torch.randn(B, S, H, R + ROPE, generator=g)
    ckv = torch.randn(B, T, R + ROPE, generator=g)
    return q.to(dtype), ckv.to(dtype)


def block(seed=1):
    """One latent-attention block's parameters at CFG's widths: W_kvb
    and the rest, in fp32."""
    g = torch.Generator().manual_seed(seed)
    return mla.mla_init(
        lambda shape, std, dt: (std * torch.randn(shape, generator=g)).to(dt),
        lambda shape, v, dt: torch.full(shape, v, dtype=dt), CFG, (),
        torch.float32, torch.float32)


def absorbed(p, q_nope, q_pe, ckv, qpos, *, kernel, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(mla, "kernel_route", lambda cfg, c: kernel)
        with torch.no_grad():
            return mla._absorbed(p, CFG, q_nope, q_pe, ckv, qpos)


def heads(B, S, seed=2):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, S, H, CFG.qk_nope_head_dim, generator=g),
            torch.randn(B, S, H, ROPE, generator=g))


@pytest.mark.parametrize("T", [77, 1100, 2 * MK.SPLIT + 33])
def test_decode_at_ragged_positions_equals_the_products(T, monkeypatch):
    """Rows at 0, T - 1, the last key of a split and the first of the
    next, and between; T a multiple of no split."""
    p = block()
    q_nope, q_pe = heads(6, 1)
    _, ckv = inputs(6, 1, T)
    qpos = torch.tensor([[0], [T - 1], [min(MK.SPLIT - 1, T - 2)],
                         [min(MK.SPLIT, T - 3)], [T // 3], [T // 2]])
    got = absorbed(p, q_nope, q_pe, ckv, qpos, kernel=True,
                   monkeypatch=monkeypatch)
    want = absorbed(p, q_nope, q_pe, ckv, qpos, kernel=False,
                    monkeypatch=monkeypatch)
    assert got.shape == (6, 1, H, CFG.v_head_dim)
    assert close(got, want)


def test_a_chunk_mid_cache_equals_the_chunk_at_one_write_position(
        monkeypatch):
    """A 6-wide chunk at 700 in the step graphs' form (per-row positions
    over the whole cache, later keys stale) against the same chunk at
    one write position, on the products over the keys before its end."""
    p = block()
    start, S, T = 700, 6, 1100
    q_nope, q_pe = heads(1, S)
    _, ckv = inputs(1, S, T)
    qpos = torch.arange(start, start + S)[None]
    got = absorbed(p, q_nope, q_pe, ckv, qpos, kernel=True,
                   monkeypatch=monkeypatch)
    want = absorbed(p, q_nope, q_pe, ckv[:, :start + S].contiguous(), qpos,
                    kernel=False, monkeypatch=monkeypatch)
    assert close(got, want)


def test_keys_past_every_position_never_reach_the_output():
    """Huge finite keys past each row's position: the output equals the
    one with zeros there, bit for bit."""
    q, ckv = inputs(3, 2, 1500)
    qpos = torch.tensor([[10, 11], [700, 701], [1100, 1101]])
    zero, huge = ckv.clone(), ckv.clone()
    for b, last in enumerate(qpos[:, -1].tolist()):
        zero[b, last + 1:] = 0.0
        huge[b, last + 1:] = 3e38
    got = MK.mla_attention(q, huge, qpos)
    assert torch.isfinite(got).all()
    assert torch.equal(got, MK.mla_attention(q, zero, qpos))


def test_bf16_rounds_where_the_kernel_rounds():
    """In bf16 the plain version rounds P and the output once each: it
    stays within bf16's rounding of the fp32 function."""
    q, ckv = inputs(2, 1, 1300, dtype=torch.bfloat16)
    qpos = torch.tensor([[1299], [400]])
    got = MK.mla_attention(q, ckv, qpos).float()
    want = MK.mla_attention_plain(q.float(), ckv.float(), qpos)
    assert close(got, want, 2e-2)


@pytest.mark.parametrize("bad", [
    "q dtype", "mixed dtypes", "key width", "qpos shape", "qpos dtype",
    "q layout", "ckv row stride", "ckv layout"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, ckv = inputs(2, 1, 64)
    qpos = torch.tensor([[3], [5]])
    if bad == "q dtype":
        q, ckv = q.half(), ckv.half()
    elif bad == "mixed dtypes":
        q = q.bfloat16()
    elif bad == "key width":
        q, ckv = q[..., :512].contiguous(), ckv[..., :512].contiguous()
    elif bad == "qpos shape":
        qpos = qpos[:, 0]
    elif bad == "qpos dtype":
        qpos = qpos.int()
    elif bad == "q layout":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "ckv row stride":
        ckv = torch.randn(2, 64, 640)[..., :576]
    else:
        ckv = ckv.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        MK.mla_attention(q, ckv, qpos)


def test_meta_tensors_give_the_output_shape_and_report_the_work():
    q = torch.empty(4, 2, H, 576, device="meta", dtype=torch.bfloat16)
    ckv = torch.empty(4, 3000, 576, device="meta", dtype=torch.bfloat16)
    qpos = torch.empty(4, 2, device="meta", dtype=torch.int64)
    assert mla.kernel_route(CFG, ckv)
    with goma_gemm.collect_traced() as calls:
        out = MK.mla_attention(q, ckv, qpos)
    assert out.shape == (4, 2, H, 512) and out.device.type == "meta"
    assert out.dtype == torch.bfloat16
    (call,) = calls
    assert call["name"] == "mla_attention"
    assert call["bytes"] == 4 * 3000 * 576 * 2 + 4 * 2 * H * 1088 * 2
    assert call["flops"] == {"bfloat16": 2 * 4 * 2 * H * 3000 * 1088}


def test_the_route_takes_the_card_and_meta_at_the_kernels_widths():
    cpu = torch.empty(1, 8, 576)
    assert not mla.kernel_route(CFG, cpu)
    assert not mla.kernel_route(CFG.replace(kv_lora_rank=32),
                                torch.empty(1, 8, 40, device="meta"))


def test_work_counts_each_rows_visible_keys_once():
    qpos = torch.tensor([[0, 1], [99, 5000]])
    w = MK.work(2, 2, H, 1000, qpos)
    assert w["bytes"] == (2 + 1000) * 576 * 2 + 2 * 2 * H * 1088 * 2
    assert w["flops"] == 2 * H * (1 + 2 + 100 + 1000) * 1088


def test_mla_apply_counts_the_calls_the_kernel_takes(monkeypatch):
    """A chunk at one write position and the decode step at per-row
    positions both take the kernel where the route sends it (on the CPU,
    its plain version), and the layer's outputs agree with the
    products'."""
    p = block()
    reg = get_registry()
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 5, CFG.d_model, generator=g)
    xd = torch.randn(2, 1, CFG.d_model, generator=g)
    outs = {}
    for kernel in (False, True):
        reg.reset()
        cache = {"ckv": torch.zeros(2, 40, R + ROPE)}
        monkeypatch.setattr(mla, "kernel_route", lambda cfg, c, k=kernel: k)
        with torch.no_grad():
            chunk = mla.mla_apply(p, CFG, x, torch.arange(5), cache=cache,
                                  cache_index=0)
            idx = torch.tensor([5, 5])
            outs[kernel] = (chunk, mla.mla_apply(
                p, CFG, xd, idx[:, None], cache=cache, cache_index=idx))
        assert reg.get("attn.mla") == 2
        assert reg.get("attn.mla_kernel") == 2 * int(kernel)
    for got, want in zip(outs[True], outs[False]):
        assert close(got, want)


def test_a_traced_chunk_at_one_write_position_records_the_kernel():
    """On meta tensors (the capture prewarm's trace) a chunk written at
    one int position reaches the kernel's traced branch over the keys up
    to its end, as on the card, and not two products over the cache."""
    p = torch.utils._pytree.tree_map(lambda t: t.to("meta"), block())
    start, S = 9, 5
    x = torch.empty(2, S, CFG.d_model, device="meta")
    cache = {"ckv": torch.empty(2, 40, R + ROPE, device="meta")}
    reg = get_registry()
    reg.reset()
    with torch.no_grad(), goma_gemm.collect_traced() as calls:
        out = mla.mla_apply(p, CFG, x, torch.arange(start, start + S,
                                                    device="meta"),
                            cache=cache, cache_index=start)
    assert out.shape == (2, S, CFG.d_model)
    assert [c["name"] for c in calls] == ["mla_attention"]
    assert calls[0]["shape"] == (2, S, H, start + S)
    assert reg.get("attn.mla_kernel") == reg.get("attn.mla") == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the latent attention kernel has no "
                    "CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S, T", [(1, 77), (1, 2 * MK.SPLIT + 33),
                                  (6, 1100)])
def test_cuda_kernel_matches_the_plain_version_and_its_graph(cuda_device,
                                                             S, T):
    """bf16 on the card against the plain version, at a strided cache
    view (a batch stride of a longer cache), and a captured graph's
    replay against the eager call bit for bit."""
    q, ckv = inputs(4, S, T + 50, dtype=torch.bfloat16)
    q, ckv = q.to(cuda_device), ckv.to(cuda_device)[:, :T]
    last = torch.tensor([0, T - 1, T // 2, min(MK.SPLIT, T - 1)])
    qpos = (last[:, None] - torch.arange(S - 1, -1, -1)).clamp(min=0)
    qpos = qpos.to(cuda_device)
    launches = MK.mla_attention.launches
    got = MK.mla_attention(q, ckv, qpos)
    torch.cuda.synchronize()
    assert MK.mla_attention.launches == launches + 1
    want = MK.mla_attention_plain(q, ckv, qpos)
    assert close(got.float(), want.float(), 1e-2)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = MK.mla_attention(q, ckv, qpos)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, got)
