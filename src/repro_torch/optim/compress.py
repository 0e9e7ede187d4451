"""Gradient compression for slow links (the cross-pod axis), the port of
``repro.optim.compress``.

Per-tensor symmetric int8 quantization with a float32 scale: 4x fewer
bytes on the wire.  :func:`compress_int8` and :func:`decompress_int8` are
bit-equal to the reference's.  :func:`compressed_psum` is an all-reduce
inside the reference's ``shard_map`` over a mesh axis: mesh code, not
ported yet.
"""

from __future__ import annotations

import torch


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The reference's int8 all-reduce over ``axis_name`` runs inside a
    ``shard_map`` over a device mesh."""
    raise NotImplementedError(
        f"compressed_psum over mesh axis {axis_name!r} is not ported to repro_torch yet: "
        "ROADMAP.md queue 1, item 11 (mesh and dry-run tooling)"
    )
