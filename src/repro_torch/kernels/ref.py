"""Plain PyTorch oracles for the port's kernels (the counterpart of the
reference's ``kernels/ref.py``): the GEMM, and the RWKV-6 and Mamba2
scans as sequential loops over the sequence."""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """fp32-accumulated matmul oracle."""
    out = a.to(torch.float32) @ b.to(torch.float32)
    return out.to(out_dtype or a.dtype)


def wkv6_ref(r, k, v, logw, u):
    """Sequential RWKV-6 WKV oracle; r/k/v/logw: (B,S,H,P), u: (H,P)."""
    B, S, H, P = r.shape
    state = torch.zeros((B, H, P, P), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        rt, kt, vt, lwt = r[:, t], k[:, t], v[:, t], logw[:, t]
        kv = torch.einsum("bhp,bhq->bhpq", kt, vt)
        ys.append(torch.einsum("bhp,bhpq->bhq", rt,
                               state + u[None, :, :, None] * kv))
        state = state * torch.exp(lwt)[..., None] + kv
    return torch.stack(ys, dim=1)


def ssd_ref(xh, dt, a_log, Bm, Cm, D):
    """Sequential Mamba2/SSD oracle; xh: (B,S,H,P), dt: (B,S,H),
    Bm/Cm: (B,S,N)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(S):
        xt, dtt, bt, ct = xh[:, t], dt[:, t], Bm[:, t], Cm[:, t]
        a = torch.exp(dtt * (-torch.exp(a_log))[None, :])
        upd = torch.einsum("bhp,bk->bhpk", xt * dtt[..., None], bt)
        state = state * a[..., None, None] + upd
        ys.append(torch.einsum("bhpk,bk->bhp", state, ct))
    return torch.stack(ys, dim=1) + xh * D[None, None, :, None]
