"""The port's recurrent scans against the reference on the same inputs
(made with numpy from a seed): the plain versions of B3 and B4 against
the Pallas kernels in interpret mode, the chunked model forms against
the reference's with and without an incoming state, and the sequential
oracles against their twins.  Tolerances are the reference's own
(tests/test_kernels.py): y 1e-4 (bf16 5e-2), state 2e-3 (WKV6) and 1e-3
(SSD)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mamba2_ssd import ssd_pallas
from repro.kernels.wkv6 import wkv6_pallas
from repro.models import rwkv as JRW
from repro.models import ssm as JSSM
from repro_torch.kernels import ref
from repro_torch.kernels.mamba2_ssd import ssd_scan, ssd_scan_plain
from repro_torch.kernels.wkv6 import wkv6_scan, wkv6_scan_plain
from repro_torch.models import rwkv as RW
from repro_torch.models import ssm as SSM

Y_TOL = {"f32": 1e-4, "bf16": 5e-2}
WKV_STATE_TOL, SSD_STATE_TOL = 2e-3, 1e-3
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def wkv_arrays(seed, B, S, H, P):
    """r, k, v, logw (B, S, H, P) and u (H, P), as the reference's kernel
    test draws them: decays exp(-exp(N(0,1) - 2)) and a nonzero bonus."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, P)) * 0.5 for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, S, H, P)) - 2.0)
    u = rng.standard_normal((H, P)) * 0.3
    return [a.astype(np.float32) for a in (r, k, v, logw, u)]


def ssd_arrays(seed, B, S, H, P, N):
    """xh, dt = softplus(N(0,1)), a_log, Bm, Cm, as the reference's kernel
    test draws them."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    a_log = rng.standard_normal(H) * 0.2
    Bm, Cm = (rng.standard_normal((B, S, N)) * 0.5 for _ in range(2))
    return [a.astype(np.float32) for a in (xh, dt, a_log, Bm, Cm)]


def _np(t):
    return (t.to(torch.float32).numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("chunk,dtype", [(8, "f32"), (32, "f32"),
                                         (64, "f32"), (32, "bf16")])
def test_wkv6_plain_matches_pallas(chunk, dtype):
    arrays = wkv_arrays(0, 2, 128, 2, 64)
    *rkvw, u = arrays
    jy, jst = wkv6_pallas(*(jnp.asarray(a).astype(JDT[dtype]) for a in rkvw),
                          jnp.asarray(u), chunk=chunk, interpret=True)
    ty, tst = wkv6_scan_plain(*(torch.from_numpy(a).to(TDT[dtype])
                                for a in rkvw), torch.from_numpy(u),
                              chunk=chunk)
    assert ty.dtype == TDT[dtype] and tst.dtype == torch.float32
    _close(ty, jy, Y_TOL[dtype])
    _close(tst, jst, WKV_STATE_TOL)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_plain_matches_pallas(chunk):
    arrays = ssd_arrays(1, 2, 128, 2, 64, 16)
    jy, jst = ssd_pallas(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                         interpret=True)
    ty, tst = ssd_scan_plain(*(torch.from_numpy(a) for a in arrays),
                             chunk=chunk)
    _close(ty, jy, Y_TOL["f32"])
    _close(tst, jst, SSD_STATE_TOL)


def test_scan_wrappers_take_the_plain_version_on_the_cpu():
    """A CPU tensor runs the plain version and launches nothing."""
    ts = [torch.from_numpy(a) for a in wkv_arrays(2, 1, 24, 2, 64)]
    launches = wkv6_scan.launches
    for got, want in zip(wkv6_scan(*ts, chunk=8),
                         wkv6_scan_plain(*ts, chunk=8)):
        assert torch.equal(got, want)
    assert wkv6_scan.launches == launches
    ts = [torch.from_numpy(a) for a in ssd_arrays(3, 1, 24, 2, 16, 8)]
    launches = ssd_scan.launches
    for got, want in zip(ssd_scan(*ts, chunk=8), ssd_scan_plain(*ts, chunk=8)):
        assert torch.equal(got, want)
    assert ssd_scan.launches == launches


def test_scan_wrappers_refuse_ragged_shapes():
    ts = [torch.from_numpy(a) for a in wkv_arrays(4, 1, 20, 2, 64)]
    with pytest.raises(ValueError, match="chunk"):
        wkv6_scan(*ts, chunk=8)               # the caller pads first
    with pytest.raises(ValueError, match="u must be"):
        wkv6_scan(*ts[:4], ts[4][:1], chunk=4)
    ts = [torch.from_numpy(a) for a in ssd_arrays(5, 1, 20, 2, 16, 8)]
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(*ts, chunk=8)
    with pytest.raises(ValueError, match="Cm must be"):
        ssd_scan(ts[0], ts[1], ts[2], ts[3][:, :, :4], ts[4], chunk=4)


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init_state"])
def test_wkv_chunked_matches_reference(init):
    """S = 20 at chunk 8: three chunks, the last one padded."""
    r, k, v, logw, u = wkv_arrays(6, 2, 20, 3, 64)
    s0 = (np.random.default_rng(7).standard_normal((2, 3, 64, 64)) * 0.1
          ).astype(np.float32) if init else None
    jy, jst = JRW.wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, logw, u)),
                              chunk=8, init_state=None if s0 is None
                              else jnp.asarray(s0))
    ty, tst = RW.wkv_chunked(*(torch.from_numpy(a)
                               for a in (r, k, v, logw, u)),
                             chunk=8, init_state=None if s0 is None
                             else torch.from_numpy(s0))
    _close(ty, jy, Y_TOL["f32"])
    _close(tst, jst, WKV_STATE_TOL)


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init_state"])
def test_ssd_chunked_matches_reference(init):
    xh, dt, a_log, Bm, Cm = ssd_arrays(8, 2, 20, 3, 16, 8)
    D = (np.random.default_rng(9).standard_normal(3)).astype(np.float32)
    s0 = (np.random.default_rng(10).standard_normal((2, 3, 16, 8)) * 0.1
          ).astype(np.float32) if init else None
    jy, jst = JSSM.ssd_chunked(*(jnp.asarray(a)
                                 for a in (xh, dt, a_log, Bm, Cm, D)),
                               chunk=8, init_state=None if s0 is None
                               else jnp.asarray(s0))
    ty, tst = SSM.ssd_chunked(*(torch.from_numpy(a)
                                for a in (xh, dt, a_log, Bm, Cm, D)),
                              chunk=8, init_state=None if s0 is None
                              else torch.from_numpy(s0))
    _close(ty, jy, Y_TOL["f32"])
    _close(tst, jst, SSD_STATE_TOL)


def test_wkv6_ref_twin():
    arrays = wkv_arrays(11, 2, 24, 2, 64)
    _close(ref.wkv6_ref(*(torch.from_numpy(a) for a in arrays)),
           jref.wkv6_ref(*(jnp.asarray(a) for a in arrays)), Y_TOL["f32"])


def test_ssd_ref_twin():
    arrays = ssd_arrays(12, 2, 24, 3, 16, 8)
    D = np.full(3, 0.1, np.float32)
    _close(ref.ssd_ref(*(torch.from_numpy(a) for a in arrays),
                       torch.from_numpy(D)),
           jref.ssd_ref(*(jnp.asarray(a) for a in arrays), jnp.asarray(D)),
           Y_TOL["f32"])


def test_plain_scans_match_the_sequential_oracles():
    """B3's and B4's plain versions against the port's own oracles (B4
    without the D term, which the caller adds)."""
    arrays = wkv_arrays(13, 2, 32, 2, 64)
    ts = [torch.from_numpy(a) for a in arrays]
    _close(wkv6_scan_plain(*ts, chunk=8)[0], ref.wkv6_ref(*ts), Y_TOL["f32"])
    ts = [torch.from_numpy(a) for a in ssd_arrays(14, 2, 32, 3, 16, 8)]
    _close(ssd_scan_plain(*ts, chunk=8)[0],
           ref.ssd_ref(*ts, torch.zeros(3)), Y_TOL["f32"])
