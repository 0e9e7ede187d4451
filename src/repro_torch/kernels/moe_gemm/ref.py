"""Plain PyTorch version of the grouped expert matmul, the counterpart of
the reference's ``moe_gemm_ref``: ``einsum("ecd,edf->ecf")`` in float32
(float64 inputs keep float64), cast to x's dtype.

The CPU path of the port's wrapper, and what the CUDA kernel is held
against on the card.
"""

from __future__ import annotations

import torch


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E,C,d) x (E,d,f) -> (E,C,f), accumulated in float32."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return torch.einsum("ecd,edf->ecf", x.to(acc), w.to(acc)).to(x.dtype)
