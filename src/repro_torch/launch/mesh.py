"""Device meshes over the devices that are present.

The port of ``repro.launch.mesh``.  A :class:`Mesh` is a record: an
ordered ``shape`` (axis name → size), its ``axis_names`` and the device
its shards live on.  The port keeps no tensor across devices, so a mesh
holds only the devices that are present (one card, or the host for
``device="cpu"``): every axis has size 1, and a mesh that needs more
devices raises, as the reference's does when its devices are short.
Callers read ``.shape`` and ``.axis_names`` only, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Union

import torch

from repro_torch.device import resolve_device


def device_count(device: torch.device) -> int:
    """Devices of ``device``'s type present in this process: the cards
    for CUDA, one host for the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: dict[str, int]
    device: torch.device

    def __post_init__(self) -> None:
        for name, size in self.shape.items():
            if size < 1:
                raise ValueError(f"mesh axis {name!r} has size {size}")
        need, have = self.size, device_count(self.device)
        if need > have:
            raise RuntimeError(
                f"mesh {tuple(self.shape.values())} needs {need} devices, found {have} "
                f"{self.device.type} device(s)"
            )

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_mesh(
    shape: tuple[int, ...], axis_names: tuple[str, ...], *, device: Union[str, torch.device] = "cuda"
) -> Mesh:
    """A mesh of ``shape`` named by ``axis_names`` (the engine's one-axis
    ``make_mesh((1,), ("nodes",))``), on the card unless ``device="cpu"``."""
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} and axis names {axis_names} differ in length")
    return Mesh(dict(zip(axis_names, (int(n) for n in shape))), resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """16×16 single-pod (256 devices) or 2×16×16 multi-pod (512) mesh: raises
    unless that many devices are present."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = resolve_device(device)
    need, have = math.prod(shape), device_count(dev)
    if have < need:
        raise RuntimeError(f"mesh {shape} needs {need} devices, found {have}")
    return make_mesh(shape, axes, device=dev)


def make_host_mesh(data: int = 1, model: int = 1, device="cuda") -> Mesh:
    """Small ``("data", "model")`` mesh over the devices present."""
    return make_mesh((data, model), ("data", "model"), device=device)
