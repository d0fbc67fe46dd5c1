"""The arithmetic of the Hopper scan kernels (B3 ``csrc/wkv6.cu``, B4
``csrc/mamba2_ssd.cu``), as a torch twin on the CPU, against the reference
on the same inputs (made with numpy from a seed).

The twins do what the kernels do: sub-chunks of 32 tokens whatever the
caller's chunk, the last one padded with zero rows; every product by
3xTF32, emulated on the float bits (round to nearest by adding 0x1000 to
the int32 view and masking with 0xFFFFE000; big = tf32(x), small =
tf32(x - big), three products); B3's decays factored per block of 16
tokens, with the exact exp per (t, s, p) only in the diagonal blocks; B4's
C Bm^T once per (batch, sub-chunk).  They are held against the Pallas
kernels in interpret mode and the sequential oracles at mild, typical and
strong decays, at the reference's tolerances (tests/test_kernels.py): y
1e-4, state 2e-3 (WKV6) and 1e-3 (SSD).  Every exponent a twin forms is
checked to be <= 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro.kernels.mamba2_ssd import ssd_pallas
from repro.kernels.wkv6 import wkv6_pallas

SUB, BLK = 32, 16
Y_TOL, WKV_STATE_TOL, SSD_STATE_TOL = 1e-4, 2e-3, 1e-3
DECAYS = ["mild", "typical", "strong"]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest, ties away
    from zero, as cvt.rna.tf32.f32 rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b by 3xTF32: small*big + big*small + big*big in fp32."""
    ab, bb = tf32(a), tf32(b)
    return (tf32(a - ab) @ bb + ab @ tf32(b - bb)) + ab @ bb


class Exps:
    """exp() that records the largest exponent it was given."""

    def __init__(self):
        self.max = -float("inf")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.max = max(self.max, float(x.max()))
        return torch.exp(x)


def pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """Zero rows on the sequence axis (1) up to a multiple of n."""
    extra = -t.shape[1] % n
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, extra)) if extra else t


def wkv6_twin(r, k, v, logw, u, exp):
    """B3's kernel arithmetic: (y, final state), fp32."""
    B, S, H, P = r.shape
    r, k, v, logw = (pad_rows(t, SUB).permute(0, 2, 1, 3)
                     for t in (r, k, v, logw))          # (B, H, S', P)
    state = torch.zeros((B, H, P, P))
    lower = torch.tril(torch.ones(BLK, BLK, dtype=torch.bool), -1)
    ys = []
    for t0 in range(0, r.shape[2], SUB):
        rc, kc, vc, lw = (t[:, :, t0:t0 + SUB] for t in (r, k, v, logw))
        cum = torch.cumsum(lw, dim=2)
        prev = F.pad(cum, (0, 0, 1, 0))[:, :, :-1]     # cum_{t-1}, 0 at t=0
        total = cum[:, :, -1]                           # (B, H, P)
        sc = torch.zeros((B, H, SUB, SUB))
        for d in (0, BLK):                              # diagonal blocks
            rt, kt = rc[:, :, d:d + BLK], kc[:, :, d:d + BLK]
            seg = (prev[:, :, d:d + BLK, None]
                   - cum[:, :, None, d:d + BLK])        # (B, H, t, s, P)
            decay = torch.zeros_like(seg)
            decay[:, :, lower] = exp(seg[:, :, lower])
            sc[:, :, d:d + BLK, d:d + BLK] = (
                torch.einsum("bhtp,bhtsp,bhsp->bhts", rt, decay, kt)
                + torch.diag_embed(torch.sum(rt * u[None, :, None] * kt, -1)))
        ref = cum[:, :, BLK - 1:BLK]                    # the last token before
        rq = rc[:, :, BLK:] * exp(prev[:, :, BLK:] - ref)
        kq = kc[:, :, :BLK] * exp(ref - cum[:, :, :BLK])
        sc[:, :, BLK:, :BLK] = mm3(rq, kq.transpose(-1, -2))
        rdec = rc * exp(prev)
        khat = kc * exp(total[:, :, None] - cum)
        ys.append(mm3(sc, vc) + mm3(rdec, state))
        state = (exp(total)[..., None] * state
                 + mm3(khat.transpose(-1, -2), vc))
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)[:, :S]
    return y, state


def ssd_twin(xh, dt, a_log, Bm, Cm, exp):
    """B4's kernel arithmetic, without the D x term: (y, final state)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    xh, dt, Bm, Cm = (pad_rows(t, SUB) for t in (xh, dt, Bm, Cm))
    Sp = xh.shape[1]
    # the prologue: C Bm^T once per (batch, sub-chunk)
    cb = mm3(Cm.reshape(B, Sp // SUB, SUB, N),
             Bm.reshape(B, Sp // SUB, SUB, N).transpose(-1, -2))
    a = -torch.exp(a_log)                               # (H,)
    state = torch.zeros((B, H, P, N))
    tril = torch.tril(torch.ones(SUB, SUB, dtype=torch.bool))
    ys = []
    for i, t0 in enumerate(range(0, Sp, SUB)):
        xc = xh[:, t0:t0 + SUB].permute(0, 2, 1, 3)     # (B, H, SUB, P)
        dtc = dt[:, t0:t0 + SUB].transpose(1, 2)        # (B, H, SUB)
        Bc, Cc = Bm[:, t0:t0 + SUB, None], Cm[:, t0:t0 + SUB, None]
        cum = torch.cumsum(dtc * a[None, :, None], dim=2)
        total = cum[..., -1:]
        seg = cum[..., :, None] - cum[..., None, :]
        decay = torch.zeros_like(seg)
        decay[..., tril] = exp(seg[..., tril])
        scores = cb[:, i, None] * decay
        xdt = xc * dtc[..., None]
        y = mm3(scores, xdt) + exp(cum)[..., None] * mm3(
            Cc.transpose(1, 2), state.transpose(-1, -2))
        ys.append(y)
        upd = mm3((xdt * exp(total - cum)[..., None]).transpose(-1, -2),
                  Bc.transpose(1, 2))
        state = exp(total)[..., None] * state + upd
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3)[:, :S], state


def wkv_arrays(seed, B, S, H, P, decay):
    """r, k, v, logw (B, S, H, P) and u (H, P).  Log-decays: "typical" as
    the reference's kernel test draws them, "mild" at the model's decay
    bias -6, "strong" down to -5 a step."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, P)) * 0.5 for _ in range(3))
    shape = (B, S, H, P)
    logw = {"mild": lambda: -np.exp(rng.standard_normal(shape) * 0.5 - 6.0),
            "typical": lambda: -np.exp(rng.standard_normal(shape) - 2.0),
            "strong": lambda: -rng.uniform(0.0, 5.0, shape)}[decay]()
    u = rng.standard_normal((H, P)) * 0.3
    return [a.astype(np.float32) for a in (r, k, v, logw, u)]


def ssd_arrays(seed, B, S, H, P, N, decay):
    """xh, dt = softplus(N(0,1)), a_log, Bm, Cm; a_log about -4 (mild), 0
    (typical, as the reference's kernel test) or 1.5 (strong)."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    a_log = rng.standard_normal(H) * 0.2 + {"mild": -4.0, "typical": 0.0,
                                            "strong": 1.5}[decay]
    Bm, Cm = (rng.standard_normal((B, S, N)) * 0.5 for _ in range(2))
    return [a.astype(np.float32) for a in (xh, dt, a_log, Bm, Cm)]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("decay", DECAYS)
def test_wkv6_twin_matches_reference(decay):
    """S = 80: two whole sub-chunks and one padded."""
    arrays = wkv_arrays(20, 2, 80, 2, 64, decay)
    exp = Exps()
    ty, tst = wkv6_twin(*(torch.from_numpy(a) for a in arrays), exp)
    assert exp.max <= 0.0
    jy, jst = wkv6_pallas(*(jnp.asarray(a) for a in arrays), chunk=16,
                          interpret=True)
    _close(ty, jy, Y_TOL)
    _close(tst, jst, WKV_STATE_TOL)
    _close(ty, jref.wkv6_ref(*(jnp.asarray(a) for a in arrays)), Y_TOL)


@pytest.mark.parametrize("decay", DECAYS)
def test_ssd_twin_matches_reference(decay):
    arrays = ssd_arrays(21, 2, 80, 3, 16, 16, decay)
    exp = Exps()
    ty, tst = ssd_twin(*(torch.from_numpy(a) for a in arrays), exp)
    assert exp.max <= 0.0
    jy, jst = ssd_pallas(*(jnp.asarray(a) for a in arrays), chunk=16,
                         interpret=True)
    _close(ty, jy, Y_TOL)
    _close(tst, jst, SSD_STATE_TOL)
    _close(ty, jref.ssd_ref(*(jnp.asarray(a) for a in arrays),
                            jnp.zeros(3)), Y_TOL)


def test_3xtf32_keeps_fp32_accuracy_where_one_tf32_product_does_not():
    """Products of unit-scale operands over k = 64, against the exact
    (fp64) product: 3xTF32 errs about as much as an fp32 product does;
    one TF32 product errs a hundred times more, near 1e-2, beyond the
    scans' 1e-4 tolerance."""
    rng = np.random.default_rng(22)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((64, 64), (64, 64)))
    exact = a.double() @ b.double()
    err32, err3, err1 = (float((p.double() - exact).abs().max())
                         for p in (a @ b, mm3(a, b), tf32(a) @ tf32(b)))
    assert err3 < 2 * err32 and err1 > 100 * err32 and err1 > 1e-3
    x = torch.tensor([1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 3 * 2 ** -12])
    assert tf32(x).tolist() == [1.0 + 2 ** -10, -(1.0 + 2 ** -10),
                                1.0 + 2 ** -10]
