"""The grouped expert matmul: the CUDA kernel's wrapper.

``moe_gemm(x, w)`` takes x (E,C,d) and w (E,d,f), contiguous, both bf16 or
both f32, and returns (E,C,f) in x's dtype with f32 accumulation.  Any C,
d and f are taken (the kernel masks ragged edges).  A CUDA tensor launches
``csrc/moe_gemm.cu`` on the current stream, through the body that
:func:`kernel_path` picks; a CPU tensor takes the plain version in
:mod:`.ref`.  Nothing falls back: a launch that fails raises.

The ``"mma"`` body (decode and serve) skips the experts whose rows of x
are all zero (those of the experts no token chose): it reads none of their
weights and writes their rows as +0.  For finite weights that equals the
dense product exactly; an inf or NaN in a skipped expert's weights would
give NaN in the dense product and 0 here.

Where a CUDA input requires grad (and grad mode is on), the launch runs
inside :class:`MoeGemmFn`.  Its backward launches the kernel once more for
``dx = dy @ wᵀ`` (wᵀ made contiguous per expert; the skip applies to the
experts whose rows of dy are zero, exactly) and takes ``dw = xᵀ @ dy`` as
``torch.bmm``, as the reference's XLA does: an expert no token reached has
zero rows of x, so its ``dw`` is exactly 0.  The backward's launch counts
in ``moe_gemm.launches`` and, apart, in ``moe_gemm.backward_launches``.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from repro_torch.kernels import _build, meta
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PATH_CODES = {"simt": 0, "mma": 1, "wgmma": 2}
#: Fewest rows per expert that take the wgmma body.  Up to 64 rows (decode
#: and serve: 4 or 8) the product is byte-bound and the mma.sync body, one
#: tile of at most 64 rows deep, reads the weights faster; from 65 rows it
#: needs a second tile and the wgmma body's 256-row tiles win (chip_smoke.py
#: phase 2 times both bodies at 64 and 65 rows; PERF.md).
WGMMA_MIN_ROWS = 65


def kernel_path(e: int, c: int, d: int, f: int, dtype: torch.dtype, aligned: bool) -> str:
    """The CUDA body that takes x (e,c,d) @ w (e,d,f): ``"wgmma"`` for bf16
    with d and f multiples of 8, 16-byte-aligned tensors and at least
    :data:`WGMMA_MIN_ROWS` rows; ``"mma"`` for the same with fewer rows;
    ``"simt"`` (f32 CUDA cores) for anything else."""
    del e  # every expert count takes the same body
    if dtype != torch.bfloat16 or d % 8 or f % 8 or not aligned:
        return "simt"
    return "wgmma" if c >= WGMMA_MIN_ROWS else "mma"


def _lib():
    lib = _build.load("moe_gemm")
    fn = lib.moe_gemm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on inputs the kernel does not take."""
    if not isinstance(x, torch.Tensor) or not isinstance(w, torch.Tensor):
        raise TypeError("x and w must be torch.Tensors")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"x and w must share a dtype in (bfloat16, float32); got {x.dtype}, "
                        f"{w.dtype}")
    if x.device != w.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[:2] != (x.shape[0], x.shape[2]):
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} are not (E,C,d) and (E,d,f)")


def launch(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, path: str, *,
           skip_dead: bool = True, dead_expert: int = -1) -> None:
    """One launch of ``path``'s body on the current stream, without the
    wrapper's checks or its launch count.  For the mma body,
    ``skip_dead=False`` computes every block (the dense product the skip
    must equal) and ``dead_expert`` treats that expert as dead whatever its
    rows (a planted fault that chip_smoke.py's check must reject)."""
    e, c, d = x.shape
    f = w.shape[2]
    index = x.get_device()
    switch = index != torch.cuda.current_device()
    with torch.cuda.device(index) if switch else contextlib.nullcontext():
        _build.check(
            _lib().moe_gemm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
                                   DTYPE_CODES[x.dtype], PATH_CODES[path], int(skip_dead),
                                   dead_expert, torch._C._cuda_getCurrentRawStream(index)),
            f"moe_gemm ({path} body)",
        )


def _run(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors: allocate the output, launch, count.  No
    autograd: the output has no ``grad_fn``.  On meta tensors: the output's
    shape, one op recorded for the dry run (:mod:`..meta`)."""
    if x.is_meta:
        return meta.moe(x, w)
    dev = x.device
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    e, c, d = x.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    launch(x, w, out, kernel_path(e, c, d, f, x.dtype, aligned))
    moe_gemm.launches += 1
    return out


class MoeGemmFn(torch.autograd.Function):
    """The kernel's forward; dx by the kernel, dw by ``torch.bmm``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _run(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _run(dy, w.transpose(1, 2).contiguous())
            moe_gemm.backward_launches += 1
        if ctx.needs_input_grad[1]:
            dw = torch.bmm(x.transpose(1, 2), dy)
        return dx, dw


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check(x, w)
    dev = x.device
    if dev.type == "cpu":
        return moe_gemm_ref(x, w)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return MoeGemmFn.apply(x, w)
    return _run(x, w)


#: Kernel launches since the last reset, and those made by a backward.
moe_gemm.launches = 0
moe_gemm.backward_launches = 0
