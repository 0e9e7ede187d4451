"""The RG-LRU linear recurrence: the CUDA kernel's wrapper.

``rglru_scan(a, b, h0)`` takes a, b (B,S,W), contiguous, both bf16 or both
f32, and h0 (B,W) in any float dtype (the carry is f32), and returns
``h_t = a_t * h_{t-1} + b_t`` as (B,S,W) in a's dtype.  A CUDA tensor
launches ``csrc/rglru_scan.cu`` on the current stream, through the body
that :func:`kernel_path` picks; a CPU tensor takes the plain version in
:mod:`.ref`; a meta tensor (the dry run's trace) the kernel's meta arm
(:mod:`repro_torch.kernels.meta`).  Nothing falls back: a launch that
fails raises.

Where a CUDA input requires grad (and grad mode is on), the launch runs
inside :class:`RgluScanFn`.  Its backward is one more launch of the same
kernel: the adjoint of ``h_t = a_t h_{t-1} + b_t`` is the linear recurrence
``g_t = dL/dh_t + a_{t+1} g_{t+1}`` run from the end, i.e. the scan of
``a`` shifted one step and reversed over ``dL/dh`` reversed, from 0; then
``da_t = g_t h_{t-1}``, ``db_t = g_t`` and ``dh0 = a_1 g_1``.  The
backward's launches count in ``rglru_scan.launches`` and, apart, in
``rglru_scan.backward_launches``.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from repro_torch.kernels import _build, meta
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PATH_CODES = {"direct": 0, "tma": 1}
#: The tma body's channels per block, ring stages, and bytes of one
#: channel's a (and b) per stage (the kernel's kTile, kStages, kStepBytes):
#: at RecurrentGemma's prefill, (8, 2048, 2560), 128 blocks, one wave of at
#: most one block per SM.
TILE, STAGES, STEP_BYTES = 160, 3, 128


def kernel_path(dtype: torch.dtype, width: int, aligned: bool) -> str:
    """The CUDA body for a, b (B,S,width) of ``dtype``: ``"tma"`` (a TMA-fed
    ring of stages in shared memory) when a row is a whole number of 16
    bytes (width % 4 == 0 in f32, % 8 in bf16) and a and b are 16-byte
    aligned, which TMA needs; ``"direct"`` (each thread loads its own
    channel) otherwise."""
    row_bytes = width * dtype.itemsize
    return "tma" if row_bytes % 16 == 0 and aligned else "direct"


def plan(batch: int, s_len: int, width: int, dtype: torch.dtype) -> tuple[int, int, int]:
    """The tma body's (blocks, steps per stage, stages): one block per
    :data:`TILE` channels of a batch row (the last tile of a row partial
    when TILE does not divide W), each stage :data:`STEP_BYTES` of each
    channel's a and b, the last stage short when its steps do not divide S."""
    steps = STEP_BYTES // dtype.itemsize
    return batch * -(-width // TILE), steps, -(-s_len // steps)


def _lib():
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def launch(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, out: torch.Tensor, path: str, *,
           fault_stage: int = -1) -> None:
    """One launch of ``path``'s body on the current stream, without the
    wrapper's checks or its launch count; h0 float32 and contiguous.
    ``fault_stage`` (tma body) runs the consumers through that ring stage
    twice: a planted fault that chip_smoke.py's check must reject."""
    bsz, s, w = a.shape
    index = a.get_device()
    switch = index != torch.cuda.current_device()
    with torch.cuda.device(index) if switch else contextlib.nullcontext():
        _build.check(
            _lib().rglru_scan_launch(a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(),
                                     bsz, s, w, DTYPE_CODES[a.dtype], PATH_CODES[path],
                                     fault_stage, torch._C._cuda_getCurrentRawStream(index)),
            f"rglru_scan ({path} body)",
        )


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


def _run(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors: allocate the output, launch, count.  No
    autograd: the output has no ``grad_fn``.  On meta tensors: the output's
    shape, one op recorded for the dry run (:mod:`..meta`)."""
    if a.is_meta:
        return meta.rglru(a, b, h0)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    launch(a, b, h0.to(torch.float32).contiguous(), out,
           kernel_path(a.dtype, a.shape[2], aligned))
    rglru_scan.launches += 1
    return out


class RgluScanFn(torch.autograd.Function):
    """The kernel's forward; a backward that is the same kernel, reversed."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _run(a, b, h0)
        ctx.save_for_backward(a, h0, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h0, h = ctx.saved_tensors
        a_next = torch.zeros_like(a)
        a_next[:, :-1] = a[:, 1:]
        g = _run(a_next.flip(1).contiguous(), dh.to(a.dtype).flip(1).contiguous(),
                 torch.zeros_like(h0, dtype=torch.float32)).flip(1)
        rglru_scan.backward_launches += 1
        h_prev = torch.cat([h0.to(h.dtype)[:, None], h[:, :-1]], dim=1)
        da = (g.float() * h_prev.float()).to(a.dtype) if ctx.needs_input_grad[0] else None
        db = g if ctx.needs_input_grad[1] else None
        dh0 = (a[:, 0].float() * g[:, 0].float()).to(h0.dtype) if ctx.needs_input_grad[2] else None
        return da, db, dh0


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    _check(a, b, h0)
    dev = a.device
    if dev.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad or h0.requires_grad):
        return RgluScanFn.apply(a, b, h0)
    return _run(a, b, h0)


#: Kernel launches since the last reset, and those made by a backward.
rglru_scan.launches = 0
rglru_scan.backward_launches = 0
