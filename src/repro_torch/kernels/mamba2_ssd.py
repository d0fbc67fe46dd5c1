"""B4: the Mamba2 SSD chunked scan kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``ssd_pallas`` of the reference
(``src/repro/kernels/mamba2_ssd.py``).  The kernel is CUDA C++ for sm_90a
in ``csrc/mamba2_ssd.cu``.  Like the TPU kernel it leaves out the D x
skip term, which the caller adds.

What bounds it on the H100: at the zamba2-2.7b prefill shape the bytes of
xh and y (48 MB with the rest, 0.014 ms at 3.35 TB/s).  Products on the
CUDA cores, C Bm^T recomputed by every head and one CTA per SM would keep
it far above that.

What the design does about it: a prologue kernel computes C Bm^T once
per (batch, sub-chunk of 32 tokens) into a scratch the wrapper allocates,
beside fp32 copies of that sub-chunk's Bm and Cm rows; then one CTA per
(batch, head) stream walks the sequence in sub-chunks of 32 tokens (the
same function for any chunk), three CTAs to an SM, with the next
sub-chunk's rows in flight (a TMA box of xh, one bulk copy of Bm and Cm,
on an mbarrier ring) while one computes.  The cumulative decays are warp
scans, and every product runs on the tensor cores by 3xTF32 at fp32
accuracy.  P and N are each 16 or 64.  Both launches are one counted
call.

``ssd_scan`` launches the kernels for CUDA tensors and counts the call
in ``ssd_scan.launches``; for CPU tensors it runs ``ssd_scan_plain``,
which walks the chunks in the same order and computes each as the TPU
kernel's body does.
"""
from __future__ import annotations

import torch

from . import _build
from .goma_gemm import (DTYPE_CODES, check_cuda_operands, note_traced,
                        refuse_grad, traced)
from .wkv6 import BLK, SUB

# the head (P) and state (N) sizes the kernel is built for, each one of
# these: zamba2-2.7b's 64 x 64 and its smoke config's 16 x 16
WIDTHS = (16, 64)


def _check_shapes(xh, dt, a_log, Bm, Cm, chunk: int) -> None:
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    want = {"dt": (B, S, H), "a_log": (H,), "Bm": (B, S, N),
            "Cm": (B, S, N)}
    for name, t in (("dt", dt), ("a_log", a_log), ("Bm", Bm), ("Cm", Cm)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]} for xh "
                             f"{tuple(xh.shape)}, not {tuple(t.shape)}")
    if chunk <= 0 or S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk "
                         f"{chunk}: pad it to the chunk size first")


def ssd_work(B, S, H, P, N) -> tuple[int, int]:
    """(product flops, other operations) of the SSD scan as the kernels do
    it: C Bm^T once per (batch, sub-chunk); per sub-chunk and head y's
    intra part (block rows of 16 and 32 keys), C S^T and the state update.
    Other operations (an exp counts as one): the cumsum and its exps, the
    decayed scores (sub, exp, multiply), xh dt, the suffix and exp(cum)
    scalings, and the state's decay."""
    subs = -(-S // SUB)
    products = (B * subs * 2 * SUB * SUB * N
                + B * H * subs * 2 * ((BLK * BLK + BLK * 2 * BLK) * P
                                      + 2 * SUB * N * P))
    other = B * H * subs * (SUB * 5 + SUB * (SUB + 1) // 2 * 3
                            + SUB * P * 4 + 2 * P * N)
    return products, other


def ssd_bytes(B, S, H, P, N, itemsize: int) -> int:
    """The bytes the scan's function moves: xh, dt, Bm, Cm read and y
    written once, a_log, the final state."""
    return ((2 * B * S * H * P + B * S * H + 2 * B * S * N) * itemsize
            + H * 4 + B * H * P * N * 4)


def ssd_scan_plain(xh, dt, a_log, Bm, Cm, *, chunk: int = 64,
                   init_state=None):
    """The chunks in order, each as ``_ssd_kernel`` computes it, in fp32,
    from ``init_state`` (B, H, P, N) or zeros.  Out of place throughout,
    so autograd differentiates it (the training path of the Mamba2
    families).  Memory: one chunk's (B, C, C, H) decay tensor at a
    time."""
    _check_shapes(xh, dt, a_log, Bm, Cm, chunk)
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))                            # (H,)
    state = (torch.zeros((B, H, P, N), dtype=f32, device=xh.device)
             if init_state is None else init_state.to(f32))
    above = ~torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xh.device))
    ys = []
    for c0 in range(0, S, chunk):
        xc, dtc, Bc, Cc = (t[:, c0:c0 + chunk].to(f32)
                           for t in (xh, dt, Bm, Cm))
        cum = torch.cumsum(dtc * a, dim=1)                   # (B, C, H)
        total = cum[:, -1]                                   # (B, H)
        xdt = xc * dtc[..., None]                            # (B, C, H, P)
        # masked before the exp, as in wkv6_scan_plain: zero gradient
        # where the exponent above the diagonal would overflow
        decay = (cum[:, :, None] - cum[:, None]).masked_fill(
            above[None, :, :, None], -torch.inf).exp()       # (B, C, C, H)
        scores = torch.einsum("btn,bsn->bts", Cc, Bc)[..., None] * decay
        y = torch.einsum("btsh,bshp->bthp", scores, xdt)
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "btn,bhpn->bthp", Cc, state)
        suffix = torch.exp(total[:, None] - cum)[..., None]  # (B, C, H, 1)
        state = (torch.exp(total)[..., None, None] * state
                 + torch.einsum("bshp,bsn->bhpn", xdt * suffix, Bc))
        ys.append(y.to(xh.dtype))
    return torch.cat(ys, dim=1), state


def ssd_scan(xh, dt, a_log, Bm, Cm, *, chunk: int = 64):
    """xh: (B, S, H, P); dt: (B, S, H); a_log: (H,); Bm/Cm: (B, S, N);
    S a multiple of ``chunk``.  Returns (y: (B, S, H, P) in xh's dtype
    WITHOUT the D x skip term, final_state: (B, H, P, N) fp32), from a
    zero initial state."""
    _check_shapes(xh, dt, a_log, Bm, Cm, chunk)
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    refuse_grad("ssd_scan", xh, dt, a_log, Bm, Cm)
    if xh.device.type != "cuda":
        if traced(xh):
            products, other = ssd_work(B, S, H, P, N)
            note_traced("ssd_scan", shape=(B, S, H, P, N, chunk),
                        nbytes=ssd_bytes(B, S, H, P, N, xh.element_size()),
                        flops={"tf32": products}, other_ops=other)
            return torch.empty_like(xh), xh.new_empty((B, H, P, N),
                                                      dtype=torch.float32)
        if xh.device.type == "cpu":
            return ssd_scan_plain(xh, dt, a_log, Bm, Cm, chunk=chunk)
    a_log = a_log.to(torch.float32).contiguous()
    if a_log.data_ptr() % 16:
        # a layer's row of a stacked (layers, H) tensor: with a
        # tensor-parallel rank's H (2 heads, say), not every row starts
        # at a 16-byte boundary; the kernel reads a copy of its own
        a_log = a_log.clone()
    check_cuda_operands("ssd_scan", xh, dt, Bm, Cm)
    check_cuda_operands("ssd_scan", a_log)
    lib = _build.load()
    code = DTYPE_CODES[xh.dtype]
    if P not in WIDTHS or N not in WIDTHS:
        raise ValueError(f"ssd_scan takes P and N each one of {WIDTHS}, "
                         f"not P={P}, N={N}")
    y = torch.empty_like(xh)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=xh.device)
    rec = torch.empty(lib.ssd_scratch_floats(B, S, N), dtype=torch.float32,
                      device=xh.device)
    err = lib.ssd_launch(
        xh.data_ptr(), dt.data_ptr(), a_log.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), state.data_ptr(), rec.data_ptr(), B, S,
        H, P, N, chunk, code,
        torch.cuda.current_stream(xh.device).cuda_stream)
    _build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
