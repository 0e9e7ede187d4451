"""Plain PyTorch version of the RG-LRU linear recurrence, the counterpart of
the reference's ``rglru_scan_ref``: ``h_t = a_t * h_{t-1} + b_t``, one step
at a time over the sequence axis in float32 (float64 inputs keep float64)
from ``h0``, output in a's dtype.

The CPU path of the port's wrapper, and what the CUDA kernel is held
against on the card: each step rounds its product and its sum to float32
separately, as the kernel does, so the two agree bit for bit.
"""

from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """a, b (B,S,W); h0 (B,W) -> h (B,S,W) in a's dtype."""
    acc = torch.promote_types(a.dtype, torch.float32)
    af, bf = a.to(acc), b.to(acc)
    h = h0.to(acc)
    out = torch.empty(af.shape, dtype=acc, device=a.device)
    for t in range(af.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype)
