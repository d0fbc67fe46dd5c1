"""Plain PyTorch oracles for the port's kernels (the counterpart of the
reference's ``kernels/ref.py``).  ``wkv6_ref`` and ``ssd_ref`` come with
the recurrent scans."""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """fp32-accumulated matmul oracle."""
    out = a.to(torch.float32) @ b.to(torch.float32)
    return out.to(out_dtype or a.dtype)
