"""The RG-LRU linear recurrence: the CUDA kernel's wrapper.

``rglru_scan(a, b, h0)`` takes a, b (B,S,W), contiguous, both bf16 or both
f32, and h0 (B,W) in any float dtype (the carry is f32), and returns
``h_t = a_t * h_{t-1} + b_t`` as (B,S,W) in a's dtype.  A CUDA tensor
launches ``csrc/rglru_scan.cu`` on the current stream; a CPU tensor takes
the plain version in :mod:`.ref`.  Nothing falls back: a launch that fails
raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> None:
    """Raise on inputs the kernel does not take."""
    for name, x in (("a", a), ("b", b), ("h0", h0)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, a on {a.device}")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must share a (B,S,W) shape")
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"a and b must share a dtype in (bfloat16, float32); got {a.dtype}, "
                        f"{b.dtype}")
    if h0.shape != (a.shape[0], a.shape[2]) or not h0.is_floating_point():
        raise ValueError(f"h0 must be a float ({a.shape[0]}, {a.shape[2]}) tensor, got "
                         f"{h0.dtype} {tuple(h0.shape)}")


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    _check(a, b, h0)
    dev = a.device
    if dev.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    carry = h0.to(torch.float32).contiguous()
    bsz, s, w = a.shape
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(
            lib.rglru_scan_launch(a.data_ptr(), b.data_ptr(), carry.data_ptr(), out.data_ptr(),
                                  bsz, s, w, DTYPE_CODES[a.dtype], stream),
            "rglru_scan",
        )
    rglru_scan.launches += 1
    return out


#: Kernel launches since the last reset.
rglru_scan.launches = 0
