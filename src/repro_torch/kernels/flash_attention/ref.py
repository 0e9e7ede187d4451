"""Plain PyTorch version of flash attention: naive softmax attention with
GQA in f32 math (float64 inputs keep float64), the counterpart of the
reference's ``attention_ref``.

The CPU path of the port's wrapper, and what the CUDA kernel is held
against on the card.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """q (B,S,H,hd); k, v (B,T,KV,hd).  Returns (B,S,H,hd) in q's dtype."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, s, kvh, g, hd).to(acc)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.to(acc)) / math.sqrt(hd)
    spos = torch.arange(s, device=q.device)[:, None]
    tpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= tpos <= spos
    if window is not None:
        mask &= tpos > spos - window
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.to(acc))
    return out.reshape(b, s, h, hd).to(q.dtype)
