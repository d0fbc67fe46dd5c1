"""B3: the RWKV-6 WKV chunked scan kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``wkv6_pallas`` of the reference
(``src/repro/kernels/wkv6.py``).  The kernel is CUDA C++ for sm_90a in
``csrc/wkv6.cu``.

What bounds it on the H100: at the rwkv6-7b prefill shape the bytes of
r, k, v, the log-decays and y (88 MB with the state, 0.026 ms at 3.35
TB/s).  An exp per (t, s, p) of the intra-chunk scores, products on the
CUDA cores and one CTA per SM would keep it far above that.

What the design does about it: one CTA per (batch, head) stream walks the
sequence in sub-chunks of 32 tokens (the same function for any chunk),
two CTAs to an SM, with the next sub-chunk's rows in flight (TMA boxes on
an mbarrier ring) while one computes.  The head size is RWKV-6's 64.  The decays are factored per
block of 16 tokens, so only the diagonal 16 x 16 blocks take an exp per
(t, s, p); every product runs on the tensor cores by 3xTF32 at fp32
accuracy; the cumulative decays are warp scans.

``wkv6_scan`` launches the kernel for CUDA tensors and counts the launch
in ``wkv6_scan.launches``; for CPU tensors it runs ``wkv6_scan_plain``,
which walks the chunks in the same order and computes each as the TPU
kernel's body does.
"""
from __future__ import annotations

import torch

from . import _build
from .goma_gemm import DTYPE_CODES, check_cuda_operands

# the head size the kernel is built for: RWKV-6's, the only one it has
HEAD = 64


def _check_shapes(r, k, v, logw, u, chunk: int) -> None:
    B, S, H, P = r.shape
    if any(t.shape != r.shape for t in (k, v, logw)):
        shapes = [tuple(t.shape) for t in (r, k, v, logw)]
        raise ValueError(f"r, k, v and logw must share one (B, S, H, P) "
                         f"shape, not {shapes}")
    if tuple(u.shape) != (H, P):
        raise ValueError(f"u must be (H, P) = {(H, P)}, not {tuple(u.shape)}")
    if chunk <= 0 or S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk "
                         f"{chunk}: pad it to the chunk size first")


def wkv6_scan_plain(r, k, v, logw, u, *, chunk: int = 64,
                    init_state=None):
    """The chunks in order, each as ``_wkv6_kernel`` computes it, in fp32,
    from ``init_state`` (B, H, P, P) or zeros.  Memory: one chunk's
    (B, C, C, H, P) decay tensor at a time."""
    _check_shapes(r, k, v, logw, u, chunk)
    B, S, H, P = r.shape
    f32 = torch.float32
    u = u.to(f32)
    state = (torch.zeros((B, H, P, P), dtype=f32, device=r.device)
             if init_state is None else init_state.to(f32))
    above = ~torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), -1)
    ys = []
    for c0 in range(0, S, chunk):
        rc, kc, vc, lw = (t[:, c0:c0 + chunk].to(f32)
                          for t in (r, k, v, logw))          # (B, C, H, P)
        cum = torch.cumsum(lw, dim=1)
        cum_tm1 = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], 1)
        total = cum[:, -1]                                   # (B, H, P)
        # scores[t,s] = sum_p r[t,p] exp(cum_tm1[t,p] - cum[s,p]) k[s,p]
        decay = (cum_tm1[:, :, None] - cum[:, None]).exp_()  # (B,C,C,H,P)
        decay.masked_fill_(above[None, :, :, None, None], 0.0)
        scores = decay.mul_(rc[:, :, None]).mul_(kc[:, None]).sum(-1)
        del decay
        y = torch.einsum("btsh,bshp->bthp", scores, vc)
        y = y + torch.sum(rc * u * kc, dim=-1, keepdim=True) * vc
        y = y + torch.einsum("bthp,bhpq->bthq", rc * torch.exp(cum_tm1),
                             state)
        state = (torch.exp(total)[..., None] * state
                 + torch.einsum("bshp,bshq->bhpq",
                                kc * torch.exp(total[:, None] - cum), vc))
        ys.append(y.to(r.dtype))
    return torch.cat(ys, dim=1), state


def wkv6_scan(r, k, v, logw, u, *, chunk: int = 64):
    """r/k/v/logw: (B, S, H, P), S a multiple of ``chunk``; u: (H, P).
    Returns (y: (B, S, H, P) in r's dtype, final_state: (B, H, P, P)
    fp32), from a zero initial state."""
    _check_shapes(r, k, v, logw, u, chunk)
    if r.device.type == "cpu":
        return wkv6_scan_plain(r, k, v, logw, u, chunk=chunk)
    B, S, H, P = r.shape
    u = u.to(torch.float32).contiguous()
    check_cuda_operands("wkv6_scan", r, k, v, logw)
    check_cuda_operands("wkv6_scan", u)
    lib = _build.load()
    if P != HEAD:
        raise ValueError(f"wkv6_scan takes RWKV-6's head size P={HEAD}, "
                         f"not P={P}")
    y = torch.empty_like(r)
    state = torch.empty((B, H, P, P), dtype=torch.float32, device=r.device)
    err = lib.wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), y.data_ptr(), state.data_ptr(), B, S, H, P, chunk,
        DTYPE_CODES[r.dtype], torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "wkv6_scan")
    wkv6_scan.launches += 1
    return y, state


wkv6_scan.launches = 0
