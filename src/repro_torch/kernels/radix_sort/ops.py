"""Stable bucketed argsort of routing codes: the CUDA kernel's wrapper.

``bucket_argsort(codes, num_buckets)`` returns the int64 permutation
``np.argsort(codes, kind="stable")`` would, for codes in
``[0, num_buckets)`` — the engine's ``(node, key group)`` composite sort.
A CUDA tensor runs the LSD radix passes of ``csrc/radix_sort.cu`` (one
scratch allocation, one C call); a CPU tensor takes the plain version in
:mod:`.ref`.  Nothing falls back: a launch that fails raises.

Codes outside ``[0, num_buckets)`` are skipped on the card: the in-range
codes' order fills the first slots and the remaining slots are left
unwritten.  int64 codes are clamped to ``[-1, num_buckets]`` and narrowed
to int32 first, so an out-of-range code stays out of range.  With
``num_buckets == 1`` no pass runs and the order is ``arange(n)``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.radix_sort.ref import bucket_argsort_ref

_CODE_DTYPES = (torch.int16, torch.int32, torch.int64)

#: Widest digit of a pass (a 256-bin histogram per block).
MAX_DIGIT_BITS = 8
#: Codes per tile of a pass kernel (``kTile`` in csrc/radix_sort.cu).
TILE = 8192
#: Look-back status words per tile and pass (``kRadix``), 8 bytes each.
_RADIX = 1 << MAX_DIGIT_BITS
#: Scratch bytes before the status words: four 256-bin histograms and the
#: per-pass tile counters (``kStatusOff``).
_STATUS_OFF = 4 * _RADIX * 4 + 256


def plan(num_buckets: int) -> tuple[int, int]:
    """(passes, bits per pass) of the LSD sort of codes in
    ``[0, num_buckets)``: ``ceil(bits / 8)`` passes of ``ceil(bits /
    passes)`` bits, where ``bits = (num_buckets - 1).bit_length()``; (0, 0)
    for a single bucket."""
    bits = (int(num_buckets) - 1).bit_length()
    if bits == 0:
        return 0, 0
    passes = -(-bits // MAX_DIGIT_BITS)
    return passes, -(-bits // passes)


def _align256(nbytes: int) -> int:
    return (nbytes + 255) & ~255


@functools.lru_cache(maxsize=64)
def scratch_bytes(n: int, code_bytes: int, passes: int) -> int:
    """Bytes of the kernel's scratch buffer: histograms, tile counters and
    look-back status words (zeroed by the kernel's one memset), then the
    ping-pong key and index buffers of the passes before the last."""
    tiles = -(-n // TILE)
    keys_off = _align256(_STATUS_OFF + passes * tiles * _RADIX * 8)
    buffers = min(passes - 1, 2)
    return keys_off + buffers * (_align256(n * code_bytes) + _align256(n * 4))


def _lib():
    lib = _build.load("radix_sort")
    fn = lib.radix_sort_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def bucket_argsort(codes: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Stable argsort of int16/int32/int64 codes in ``[0, num_buckets)``,
    as an int64 order on ``codes.device``."""
    if not isinstance(codes, torch.Tensor):
        raise TypeError("bucket_argsort takes a torch.Tensor of codes")
    if codes.dim() != 1 or codes.dtype not in _CODE_DTYPES:
        raise TypeError(
            f"codes must be a 1-D int16/int32/int64 tensor, got {codes.dtype} "
            f"of shape {tuple(codes.shape)}"
        )
    if not 1 <= num_buckets < 2**31:
        raise ValueError(f"num_buckets must be in [1, 2**31), got {num_buckets}")
    n = codes.numel()
    if n >= 2**31:
        raise ValueError("bucket_argsort ranks in int32: at most 2**31 - 1 codes")
    dev = codes.device
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=dev)
    if dev.type == "cpu":
        return bucket_argsort_ref(codes, num_buckets)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    passes, bits = plan(num_buckets)
    if passes == 0:
        return torch.arange(n, dtype=torch.int64, device=dev)
    if codes.dtype == torch.int64:
        codes = codes.clamp(-1, num_buckets).to(torch.int32)
    size = scratch_bytes(n, codes.element_size(), passes)
    scratch = torch.empty(size, dtype=torch.uint8, device=dev)
    order = torch.empty(n, dtype=torch.int64, device=dev)
    # A sort of 2^20 codes takes tens of microseconds on the card, so the
    # host's share counts: the raw stream handle, and a device switch only
    # when the codes lie on another card than the current one.
    index = codes.get_device()
    switch = index != torch.cuda.current_device()
    with torch.cuda.device(index) if switch else contextlib.nullcontext():
        _build.check(
            _lib().radix_sort_launch(
                codes.data_ptr(), codes.element_size(), n, num_buckets, passes, bits,
                scratch.data_ptr(), size, order.data_ptr(),
                torch._C._cuda_getCurrentRawStream(index),
            ),
            "radix_sort",
        )
    bucket_argsort.launches += 1
    return order


#: Sorts launched on the card (each one memset, histogram and pass
#: kernels) since the last reset.
bucket_argsort.launches = 0
