"""Hash partition + arrival histogram: the CUDA kernel's wrapper.

``keygroup_partition(keys, nkg, base=...)`` gives each raw integer key its
key-group id (``base + (mix32(fold(key)) & 0x7FFFFFFF) % nkg``, the
engine's routing hash) and the per-key-group tuple histogram the SPL
statistics feed on.  A CUDA tensor launches the kernel in
``csrc/keygroup_partition.cu``; a CPU tensor takes the plain version in
:mod:`.ref`.  Nothing falls back: a launch that fails raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.keygroup_partition.ref import keygroup_partition_ref

_KEY_DTYPES = (torch.int32, torch.int64)


def fold_keys64(keys: torch.Tensor) -> torch.Tensor:
    """Fold raw integer keys to the int32 lanes of the 32-bit mix.

    ``(u ^ (u >> 32)) & 0xFFFFFFFF`` on the two's-complement uint64 view
    (int32 keys sign-extend first), viewed as int32 — identical to the
    reference's ``fold_keys64``.
    """
    k = keys.to(torch.int64)
    f = (k ^ (k >> 32)) & 0xFFFFFFFF
    return torch.where(f >= 2**31, f - 2**32, f).to(torch.int32)


def _lib():
    lib = _build.load("keygroup_partition")
    fn = lib.keygroup_partition_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.c_longlong,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def keygroup_partition(
    keys: torch.Tensor, num_keygroups: int, *, base: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Key-group id per key (int64, offset by ``base``) and the int64
    histogram over the operator's ``num_keygroups`` local ids, on
    ``keys.device``."""
    if not isinstance(keys, torch.Tensor):
        raise TypeError("keygroup_partition takes a torch.Tensor of keys")
    if keys.dim() != 1 or keys.dtype not in _KEY_DTYPES:
        raise TypeError(
            f"keys must be a 1-D int32 or int64 tensor, got {keys.dtype} "
            f"of shape {tuple(keys.shape)}"
        )
    if not 1 <= num_keygroups < 2**31:
        raise ValueError(f"num_keygroups must be in [1, 2**31), got {num_keygroups}")
    dev = keys.device
    if dev.type == "cpu":
        kg, hist = keygroup_partition_ref(fold_keys64(keys), num_keygroups)
        return kg + base, hist
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    n = keys.numel()
    ids = torch.empty(n, dtype=torch.int64, device=dev)
    hist = torch.empty(num_keygroups, dtype=torch.int64, device=dev)
    launch = _lib()
    with torch.cuda.device(dev):
        rc = launch(
            keys.data_ptr(),
            keys.element_size(),
            n,
            num_keygroups,
            int(base),
            ids.data_ptr(),
            hist.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "keygroup_partition")
    keygroup_partition.launches += 1
    return ids, hist


#: Kernel launches since the last reset (CUDA tensors only).
keygroup_partition.launches = 0
