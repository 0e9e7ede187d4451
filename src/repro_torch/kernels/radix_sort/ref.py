"""Plain PyTorch version of the bucketed radix argsort.

A sort-free stable counting sort: least-significant-digit radix passes of
4 bits each, every pass a one-hot exclusive cumsum (equal digits before
each element) plus the digit's start offset — the same counting scheme the
kernel runs by blocks.  Bit-identical to ``np.argsort(codes,
kind="stable")``, the reference engine's routing permutation.  The CPU path
of the port's wrapper, and what the CUDA kernel is held against on the card.
"""

from __future__ import annotations

import torch

_DIGIT_BITS = 4
_RADIX = 1 << _DIGIT_BITS


def bucket_argsort_ref(codes: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Stable argsort of codes in ``[0, num_buckets)`` → int64 order."""
    c = codes.to(torch.int64)
    n = c.numel()
    order = torch.arange(n, dtype=torch.int64, device=c.device)
    digits = torch.arange(_RADIX, dtype=torch.int64, device=c.device)
    bits = max(1, (int(num_buckets) - 1).bit_length())
    for shift in range(0, bits, _DIGIT_BITS):
        d = (c[order] >> shift) & (_RADIX - 1)
        onehot = (digits[:, None] == d).to(torch.int32)  # (radix, n)
        before = torch.cumsum(onehot, 1, dtype=torch.int32) - onehot
        within = before.gather(0, d[None, :]).squeeze(0)
        totals = onehot.sum(1)
        start = torch.cumsum(totals, 0) - totals
        rank = start[d] + within
        nxt = torch.empty_like(order)
        nxt[rank] = order
        order = nxt
    return order
