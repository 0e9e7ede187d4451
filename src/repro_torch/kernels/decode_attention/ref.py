"""Plain PyTorch version of flash-decode attention in f32 math, the
counterpart of the reference's ``decode_attention_ref``.

The CPU path of the port's wrapper, and what the CUDA kernel is held
against on the card.  A row with ``kv_len == 0`` softmaxes over nothing but
masked slots and returns the mean of v, as the reference's oracle does; the
kernel returns 0 there.  ``kv_len`` lies in ``[1, T]`` wherever it is used.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38


def decode_attention_ref(
    q: torch.Tensor,  # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, T, KV, hd)
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,  # (B,)
) -> torch.Tensor:
    b, _, h, hd = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k_cache.float()) / math.sqrt(hd)
    valid = torch.arange(t, device=q.device)[None, :] < kv_len.to(q.device)[:, None]
    scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)
