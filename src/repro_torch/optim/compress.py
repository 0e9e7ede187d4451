"""Gradient compression for slow links (the cross-pod axis), the port of
``repro.optim.compress``.

Per-tensor symmetric int8 quantization with a float32 scale: 4x fewer
bytes on the wire.  :func:`compress_int8` and :func:`decompress_int8` are
bit-equal to the reference's.  :func:`compressed_psum` is the reference's
int8 all-reduce over an axis of the current mesh
(:func:`repro_torch.models.common.current_mesh`); the port holds one
device, so the axis has one shard and the reduction is its quantize and
dequantize round trip, bit-equal to the reference's on a one-device mesh.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import current_mesh


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """All-reduce over the current mesh's ``axis_name`` with an int8 payload.

    Quantize on the shared grid (the max scale over the axis), sum the
    int32 codes over the axis, rescale: the reference's steps.  Raises
    outside a mesh context, for an axis the mesh lacks, and for an axis of
    more than one shard (the port holds one device)."""
    mesh = current_mesh()
    if mesh is None:
        raise ValueError("compressed_psum runs inside activation_rules(..., mesh=...)")
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh axes {tuple(mesh.shape)} have no {axis_name!r}")
    if mesh.shape[axis_name] != 1:
        raise ValueError(
            f"compressed_psum over {mesh.shape[axis_name]} shards of {axis_name!r}: the port "
            "holds one device"
        )
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0  # pmax over one shard
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int32)
    total = q  # psum over one shard
    return total.to(torch.float32) * scale
