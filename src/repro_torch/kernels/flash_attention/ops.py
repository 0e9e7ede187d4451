"""Causal / sliding-window GQA flash attention: the CUDA kernel's wrapper.

``flash_attention(q, k, v, causal=True, window=None)`` takes q (B,S,H,hd)
and k, v (B,T,KV,hd), contiguous, bf16 or f32, with H % KV == 0, and
returns (B,S,H,hd) in q's dtype.  A CUDA tensor launches
``csrc/flash_attention.cu`` on the current stream, through the body that
:func:`kernel_path` picks; a CPU tensor takes the plain version in
:mod:`.ref`.  Nothing falls back: a launch that fails raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
#: bf16 head dims of the Hopper body (wgmma on a TMA-fed K/V ring).
WGMMA_HEAD_DIMS = (64, 128, 256)
#: bf16 head dims of the mma.sync body (the SMOKE configs).
MMA_HEAD_DIMS = (16, 32)
PATH_CODES = {"simt": 0, "mma": 1, "wgmma": 2}


def kernel_path(dtype: torch.dtype, hd: int) -> str:
    """The CUDA body that takes (dtype, head_dim): ``"wgmma"`` for bf16 at
    hd 64, 128 and 256, ``"mma"`` for bf16 at hd 16 and 32, ``"simt"`` (f32
    CUDA cores) for anything else."""
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
        return "wgmma"
    if dtype == torch.bfloat16 and hd in MMA_HEAD_DIMS:
        return "mma"
    return "simt"


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on inputs the kernel does not take."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.dim() != 4:
            raise TypeError(f"{name} must be a 4-D torch.Tensor")
        if x.dtype not in DTYPE_CODES or x.dtype != q.dtype:
            raise TypeError(
                f"q, k, v must share a dtype in (bfloat16, float32); {name} is {x.dtype}"
            )
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if h % k.shape[2] != 0:
        raise ValueError(f"{h} query heads are not a multiple of {k.shape[2]} KV heads")
    if not 1 <= hd <= MAX_HEAD_DIM or hd % 8 != 0:
        raise ValueError(f"head_dim {hd} must be a multiple of 8 in [8, {MAX_HEAD_DIM}]")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    check_qkv(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    dev = q.device
    if dev.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(
            lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, t, h, kvh, hd, int(causal), -1 if window is None else window,
                DTYPE_CODES[q.dtype], PATH_CODES[kernel_path(q.dtype, hd)], stream,
            ),
            "flash_attention",
        )
    flash_attention.launches += 1
    return out


#: Kernel launches since the last reset.
flash_attention.launches = 0
