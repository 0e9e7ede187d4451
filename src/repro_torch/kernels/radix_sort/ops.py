"""Stable bucketed argsort of routing codes: the CUDA kernel's wrapper.

``bucket_argsort(codes, num_buckets)`` returns the int64 permutation
``np.argsort(codes, kind="stable")`` would, for codes in
``[0, num_buckets)`` — the engine's ``(node, key group)`` composite sort.
A CUDA tensor launches the two passes of ``csrc/radix_sort.cu`` with the
exclusive scan between them as ``torch.cumsum`` glue; a CPU tensor takes
the plain version in :mod:`.ref`.  Nothing falls back: a launch that fails
raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.radix_sort.ref import bucket_argsort_ref

_CODE_DTYPES = (torch.int16, torch.int32, torch.int64)

#: Upper bound on the per-block histogram table (nblocks × num_buckets
#: int32): keeps it in the tens of MB at the engine's bucket counts.
TABLE_BYTES = 32 << 20
#: Fewest codes a block's chunk holds (one warp walks it in the rank pass).
MIN_CHUNK = 1024


def plan(n: int, num_buckets: int) -> tuple[int, int]:
    """(nblocks, chunk) for ``n`` codes over ``num_buckets`` buckets."""
    max_blocks = max(1, TABLE_BYTES // (4 * num_buckets))
    nblocks = max(1, min(-(-n // MIN_CHUNK), max_blocks))
    chunk = -(-n // nblocks)
    return -(-n // chunk), chunk


def _lib():
    lib = _build.load("radix_sort")
    for name, extra in (
        ("radix_sort_hist_launch", 1),
        ("radix_sort_rank_launch", 2),
    ):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [
                ctypes.c_void_p,
                ctypes.c_int,
                ctypes.c_longlong,
                ctypes.c_longlong,
                ctypes.c_int,
                ctypes.c_int,
            ] + [ctypes.c_void_p] * (extra + 1)
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
    if codes.dtype == torch.int64:
        codes = codes.to(torch.int32)
    nblocks, chunk = plan(n, num_buckets)
    lib = _lib()
    table = torch.empty(nblocks * num_buckets, dtype=torch.int32, device=dev)
    order = torch.empty(n, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (codes.data_ptr(), codes.element_size(), n, chunk, nblocks, num_buckets)
        _build.check(
            lib.radix_sort_hist_launch(*args, table.data_ptr(), stream),
            "radix_sort (histogram pass)",
        )
        # Exclusive scan of the bucket-major table: each (bucket, block)
        # slot's first output rank.
        base = torch.cumsum(table, 0, dtype=torch.int32)
        base -= table
        _build.check(
            lib.radix_sort_rank_launch(*args, base.data_ptr(), order.data_ptr(), stream),
            "radix_sort (rank pass)",
        )
    bucket_argsort.launches += 1
    return order


#: Kernel launches (histogram + rank pass pairs) since the last reset.
bucket_argsort.launches = 0
