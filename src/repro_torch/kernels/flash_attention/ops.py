"""Causal / sliding-window GQA flash attention: the CUDA kernel's wrapper.

``flash_attention(q, k, v, causal=True, window=None)`` takes q (B,S,H,hd)
and k, v (B,T,KV,hd), contiguous, bf16 or f32, with H % KV == 0 and
hd <= 256, and returns (B,S,H,hd) in q's dtype.  The kernel reads rows of
16 bytes at a time, so a head dim that is not a multiple of 8 (the
trainer's reduced configs: d_model 640 over 6 heads is 106) is padded
with zeros to the next multiple, q prescaled by sqrt(padded / hd) so the
kernel's 1/sqrt(padded) scale gives the softmax's 1/sqrt(hd); the padded
columns of the output are P·0 and are cut off.  A CUDA tensor launches
``csrc/flash_attention.cu`` on the current stream, through the body that
:func:`kernel_path` picks; a CPU tensor takes the plain version in
:mod:`.ref`; a meta tensor (the dry run's trace) the kernel's meta arm
(:mod:`repro_torch.kernels.meta`).  Nothing falls back: a launch that
fails raises.

Where a CUDA input requires grad (and grad mode is on), the launch runs
inside :class:`FlashAttentionFn`, whose backward recomputes the plain
version on the saved q, k, v and differentiates it (the reference has no
backward kernel: XLA differentiates its attention).  That backward
launches nothing; ``flash_attention.backward_launches`` stays 0.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, meta
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
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} must be in [1, {MAX_HEAD_DIM}]")


def padded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(q, k, v) with the head dim padded by zeros to a multiple of 8 and q
    prescaled by sqrt(padded / hd): the same attention under the kernel's
    1/sqrt(padded) scale, its output's first hd columns."""
    hd = q.shape[-1]
    pad = -hd % 8
    scale = math.sqrt((hd + pad) / hd)
    return (F.pad(q * scale, (0, pad)), F.pad(k, (0, pad)), F.pad(v, (0, pad)))


def _run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
         window: int | None) -> torch.Tensor:
    """The kernel on CUDA tensors: allocate the output, launch, count.  No
    autograd: the output has no ``grad_fn``.  On meta tensors: the output's
    shape, one op recorded for the dry run (:mod:`..meta`)."""
    if q.is_meta:
        return meta.flash(q, k, v, causal, window)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    hd = q.shape[-1]
    if hd % 8:
        return _run(*padded(q, k, v), causal, window)[..., :hd].contiguous()
    dev = q.device
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


class FlashAttentionFn(torch.autograd.Function):
    """The kernel's forward; the plain version's gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _run(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need) for t, need in zip((q, k, v),
                                                                      ctx.needs_input_grad)]
            out = attention_ref(*ins, causal=ctx.causal, window=ctx.window)
            wanted = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, dout))
        return (*(next(grads) if t.requires_grad else None for t in ins), None, None)


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
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return _run(q, k, v, causal, window)


#: Kernel launches since the last reset, and those made by a backward.
flash_attention.launches = 0
flash_attention.backward_launches = 0
