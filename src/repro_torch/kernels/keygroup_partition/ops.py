"""Hash partition + arrival histogram: the CUDA kernel's wrapper.

``keygroup_partition(keys, nkg, base=...)`` gives each raw integer key its
key-group id (``base + (mix32(fold(key)) & 0x7FFFFFFF) % nkg``, the
engine's routing hash) and the per-key-group tuple histogram the SPL
statistics feed on.  A CUDA tensor launches the kernel in
``csrc/keygroup_partition.cu`` (one launch, no memset); a CPU tensor takes
the plain version in :mod:`.ref`.  Nothing falls back: a launch that fails
raises.

The kernel zeroes the histogram itself and synchronises its blocks through
two scratch words (a `ready` flag and an arrival count), 0 between
launches: the last arrival sets them back to 0.  The wrapper keeps one
pair per (device, stream), so launches that share one run in order and two
streams never share one.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.keygroup_partition.ref import keygroup_partition_ref

_KEY_DTYPES = (torch.int32, torch.int64)
#: Threads per block, 16-byte loads in flight per thread, blocks per
#: cluster (the kernel's kThreads, kLoads, kCluster).
THREADS, LOADS, CLUSTER = 256, 4, 8
#: Most key groups whose histogram a block keeps in shared memory (200 KiB
#: of counts; the kernel's kMaxSmemBuckets).  Above it the blocks add into
#: device memory directly.
SMEM_MAX_BUCKETS = 51_200
#: Blocks of the kernel an SM holds by its registers (``__launch_bounds__``).
BLOCKS_PER_SM = 4
#: Shared memory of an H100 SM, and what the card reserves per block.
SM_SHARED_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1024


def fold_keys64(keys: torch.Tensor) -> torch.Tensor:
    """Fold raw integer keys to the int32 lanes of the 32-bit mix.

    ``(u ^ (u >> 32)) & 0xFFFFFFFF`` on the two's-complement uint64 view
    (int32 keys sign-extend first), viewed as int32 — identical to the
    reference's ``fold_keys64``.
    """
    k = keys.to(torch.int64)
    f = (k ^ (k >> 32)) & 0xFFFFFFFF
    return torch.where(f >= 2**31, f - 2**32, f).to(torch.int32)


@functools.lru_cache(maxsize=None)
def magic(nkg: int) -> tuple[int, int]:
    """(m, shift) with ``x % nkg == x - nkg * ((x * m) >> shift)`` for every
    x in [0, 2**31): shift = 31 + ceil(log2 nkg), m = ceil(2**shift / nkg).
    Exact because m·nkg − 2**shift < nkg ≤ 2**(shift − 31), so x's error
    term stays below 1 / nkg; m < 2**32, so the product fits 64 bits."""
    if not 1 <= nkg < 2**31:
        raise ValueError(f"nkg must be in [1, 2**31), got {nkg}")
    shift = 31 + (nkg - 1).bit_length()
    m = -(-(1 << shift) // nkg)
    assert m < 2**32
    return m, shift


def head_keys(address: int, key_bytes: int, n: int) -> int:
    """Keys before the first 16-byte boundary at ``address`` (at most n),
    which the kernel takes one by one."""
    return min(n, (-address % 16) // key_bytes)


def kernel_path(nkg: int, key_bytes: int, n: int, address: int) -> str:
    """The kernel's body for n keys of ``key_bytes`` at ``address``:
    ``"shared/..."`` (a shared-memory histogram per block, flushed through
    a cluster) up to :data:`SMEM_MAX_BUCKETS` key groups, ``"global/..."``
    (warp-aggregated atomics in device memory) above; ``".../vector"`` when
    every key goes through 16-byte loads, ``".../scalar edges"`` when a
    head before the first 16-byte boundary or a tail short of a whole
    vector goes one key at a time."""
    head = head_keys(address, key_bytes, n)
    edges = head > 0 or (n - head) % (16 // key_bytes) != 0
    hist = "shared" if nkg <= SMEM_MAX_BUCKETS else "global"
    return f"{hist}/{'scalar edges' if edges else 'vector'}"


@functools.lru_cache(maxsize=None)
def plan(n: int, key_bytes: int, nkg: int, sms: int) -> int:
    """Blocks of one launch: enough for one trip of :data:`LOADS` vectors
    per thread, at most one wave of resident blocks (by registers and, for
    the shared body, by each block's histogram in shared memory), and for
    the shared body a whole number of clusters (at least one)."""
    want = max(1, -(-n // (THREADS * LOADS * (16 // key_bytes))))
    if nkg > SMEM_MAX_BUCKETS:
        return min(want, BLOCKS_PER_SM * sms)
    per_sm = min(BLOCKS_PER_SM, SM_SHARED_BYTES // (4 * nkg + BLOCK_RESERVED_BYTES))
    cap = max(CLUSTER, per_sm * sms // CLUSTER * CLUSTER)
    return min(-(-want // CLUSTER) * CLUSTER, cap)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


#: (device index, raw stream) -> the kernel's two int32 scratch words
#: (`ready`, `done`), 0 between launches.
_SYNC: dict[tuple[int, int], torch.Tensor] = {}


def _sync(index: int, stream: int) -> int:
    buf = _SYNC.get((index, stream))
    if buf is None:
        buf = _SYNC[(index, stream)] = torch.zeros(
            2, dtype=torch.int32, device=torch.device("cuda", index))
    return buf.data_ptr()


def _lib():
    lib = _build.load("keygroup_partition")
    fn = lib.keygroup_partition_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p,  # keys
            ctypes.c_int,  # key_bytes
            ctypes.c_longlong,  # n
            ctypes.c_int,  # head
            ctypes.c_int,  # nkg
            ctypes.c_uint,  # magic m
            ctypes.c_int,  # magic shift
            ctypes.c_longlong,  # base
            ctypes.c_void_p,  # ids
            ctypes.c_void_p,  # hist
            ctypes.c_void_p,  # sync
            ctypes.c_int,  # blocks
            ctypes.c_int,  # drop_block
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
    return fn


def launch(keys: torch.Tensor, num_keygroups: int, base: int = 0, *,
           drop_block: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch on the current stream, without the wrapper's checks or
    its launch count.  ``drop_block`` leaves that block's slice of its
    cluster's histogram flush out (shared body only): a planted fault that
    chip_smoke.py's check must reject."""
    n, key_bytes = keys.numel(), keys.element_size()
    head = head_keys(keys.data_ptr(), key_bytes, n)
    # ids + head must share keys + head's 16-byte alignment: an odd head
    # puts ids one int64 into its (16-byte aligned) allocation.
    if head % 2:
        ids = torch.empty(n + 1, dtype=torch.int64, device=keys.device)[1:]
    else:
        ids = torch.empty(n, dtype=torch.int64, device=keys.device)
    hist = torch.empty(num_keygroups, dtype=torch.int64, device=keys.device)
    index = keys.get_device()
    m, shift = magic(num_keygroups)
    switch = index != torch.cuda.current_device()
    with torch.cuda.device(index) if switch else contextlib.nullcontext():
        stream = torch._C._cuda_getCurrentRawStream(index)
        rc = _lib()(keys.data_ptr(), key_bytes, n, head, num_keygroups, m, shift, int(base),
                    ids.data_ptr(), hist.data_ptr(), _sync(index, stream),
                    plan(n, key_bytes, num_keygroups, _sms(index)), drop_block, stream)
    _build.check(rc, "keygroup_partition")
    return ids, hist


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
    out = launch(keys, num_keygroups, base)
    keygroup_partition.launches += 1
    return out


#: Kernel launches since the last reset (CUDA tensors only).
keygroup_partition.launches = 0
