"""The LM kernels' arm on the meta device, for the dry run's op counter.

On a meta tensor (no storage) the wrappers of flash_attention,
decode_attention, rglru_scan and moe_gemm allocate their output's shape
and dtype and :func:`record` one kernel op with the work the kernel does on
the card: each input read once and each output written once, and the
operations of its body (the formula behind PERF.md §6's bound column).  The
dry run's counter (:mod:`repro_torch.launch.roofline`) listens through
:data:`RECORDERS`; nothing is launched and nothing is counted in the
wrappers' ``launches``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

#: Listeners ``(name, flops, nbytes)``: the innermost one hears each op.
RECORDERS: list[Callable[[str, float, float], None]] = []


def record(name: str, flops: float, nbytes: float) -> None:
    if RECORDERS:
        RECORDERS[-1](name, flops, nbytes)


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@functools.lru_cache(maxsize=None)
def attention_pairs(s: int, t: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs one head attends: query i (top-left aligned, as
    the kernel and its plain version mask) sees keys ``j < t`` with
    ``j <= i`` when causal and ``j > i - window`` under a window."""
    total = 0
    for i in range(s):
        hi = min(i, t - 1) if causal else t - 1
        lo = max(i - window + 1, 0) if window is not None else 0
        total += max(hi - lo + 1, 0)
    return total


def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    pairs = attention_pairs(s, k.shape[1], causal, window)
    record("flash_attention", 4 * b * h * hd * pairs, nbytes(q, k, v, out))
    return out


def decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """Counted over the whole capacity T: a meta trace has no ``kv_len``."""
    b, _, h, hd = q.shape
    out = torch.empty_like(q)
    record("decode_attention", 4 * b * h * hd * k_cache.shape[1],
           nbytes(q, k_cache, v_cache, out))
    return out


def rglru(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(a)
    record("rglru_scan", 2 * a.numel(), nbytes(a, b, out) + 4 * h0.numel())
    return out


def moe(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Counted on dense x: a meta trace has no live-expert flags."""
    e, c, d = x.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    record("moe_gemm", 2 * e * c * d * f, nbytes(x, w, out))
    return out
