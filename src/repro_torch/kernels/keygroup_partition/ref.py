"""Plain PyTorch version of the hash-partition/histogram kernel.

A restatement of the reference's ``keygroup_partition_ref`` (and of
``Topology.keygroups_of``'s integer path): the CPU path of the port's
wrapper, and what the CUDA kernel is held against on the card.

Torch's uint32 has no ``>>`` or ``%``, so the 32-bit mix runs in int64
lanes masked with ``& 0xFFFFFFFF``; the multiplies are split into 16-bit
halves so no intermediate product leaves the int64 range.
"""

from __future__ import annotations

import torch

_MIX_C1 = 0x85EBCA6B
_MIX_C2 = 0xC2B2AE35
_MASK32 = 0xFFFFFFFF
_MASK31 = 0x7FFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2**32`` for h in [0, 2**32), without int64 overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finisher over int64 lanes holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, _MIX_C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _MIX_C2)
    return h ^ (h >> 16)


def keygroup_partition_ref(
    keys32: torch.Tensor, num_keygroups: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(n,) folded int32 keys → (int64 key-group ids, int64 histogram)."""
    h = mix32(keys32.to(torch.int64) & _MASK32)
    kg = (h & _MASK31) % num_keygroups
    return kg, torch.bincount(kg, minlength=num_keygroups)
