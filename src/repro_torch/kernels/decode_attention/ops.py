"""Single-token flash-decode attention: the CUDA kernel's wrapper.

``decode_attention(q, k_cache, v_cache, kv_len)`` takes q (B,1,H,hd), the
caches (B,T,KV,hd), contiguous, bf16 or f32, and per-row lengths ``kv_len``
(B,), int32 or int64, in ``[1, T]``; slots at or past ``kv_len[b]`` are
masked.  Returns (B,1,H,hd) in q's dtype.  A CUDA tensor launches
``csrc/decode_attention.cu`` on the current stream, through the body that
:func:`kernel_path` picks; a CPU tensor takes the plain version in
:mod:`.ref`.  Nothing falls back: a launch that fails raises.

The kernel splits each row's keys over ``nsplit`` blocks per (row, KV
head) (:func:`plan`: one wave of blocks on the card), and the last
block of each (row, KV head) to finish merges their partial softmax
states, in the same launch.  Its arrival counters must be 0 when a launch
starts, and the merging blocks set them back to 0: the wrapper keeps one
set per (device, stream), so launches that share a set run in order and
two streams never share one.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.kernels import _build, meta
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import DTYPE_CODES, check_qkv

PATH_CODES = {"simt": 0, "mma": 1}
#: bf16 head dims of the tensor-core body (G <= MMA_MAX_GROUP).
MMA_HEAD_DIMS = (16, 32, 64, 128, 256)
MMA_MAX_GROUP = 16
#: Keys per tile of each body: a warp's 16-key tile (mma), a block's 64
#: (simt); a split takes whole tiles.
TILE_KEYS = {"mma": 16, "simt": 64}
#: Accumulator slots a thread of the simt body holds (G·hd ≤ 256 · MAX_ACC).
MAX_ACC = 16
SIMT_THREADS = 256


def kernel_path(dtype: torch.dtype, group: int, hd: int) -> str:
    """The CUDA body that takes (dtype, G, head_dim): ``"mma"`` (tensor
    cores, a warp-level cp.async ring) for bf16 with G <= 16 at hd 16, 32,
    64, 128 or 256; ``"simt"`` (f32 CUDA cores) for anything else."""
    if dtype == torch.bfloat16 and group <= MMA_MAX_GROUP and hd in MMA_HEAD_DIMS:
        return "mma"
    return "simt"


#: Most bytes of f32 partials the merging block of a (row, KV head) reads:
#: it merges alone, after every other split, so each split past what this
#: holds costs more in the merge than it gains in the key loop (measured on
#: an H100: at GLM-4-9B's decode shape 8 splits beat 12 and 16, at
#: RecurrentGemma's 8 beat 16; PERF.md).
MERGE_BYTES = 80 * 1024


def plan(batch: int, kv_heads: int, capacity: int, sms: int, path: str = "mma",
         hd: int = 128, group: int = 1) -> int:
    """Key splits per (row, KV head), at least 1 and at most one per tile
    of the cache.  The mma body streams at the card's rate with one block
    per SM, so it takes at most one wave of one block per SM and at most
    :data:`MERGE_BYTES` of partials; the simt body takes two blocks per SM."""
    pairs = max(batch * kv_heads, 1)
    if path == "mma":
        want = min(sms // pairs, MERGE_BYTES // (4 * group * hd))
    else:
        want = 2 * sms // pairs
    return max(1, min(want, -(-capacity // TILE_KEYS[path])))


def scratch_floats(batch: int, kv_heads: int, group: int, hd: int, nsplit: int) -> int:
    """f32 scratch of one launch: every split's partial acc (G x hd) and
    (m, l) (G x 2); none when there is one split."""
    return 0 if nsplit == 1 else batch * kv_heads * nsplit * group * (hd + 2)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


#: (device index, raw stream) -> int32 arrival counters, all 0 between launches.
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _counters(index: int, stream: int, n: int) -> torch.Tensor:
    buf = _COUNTERS.get((index, stream))
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[(index, stream)] = torch.zeros(
            max(n, 1024), dtype=torch.int32, device=torch.device("cuda", index))
    return buf


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def launch(q, k_cache, v_cache, kv_len, out, *, path: str, nsplit: int,
           drop_last_split: bool = False) -> None:
    """One launch of the kernel on the current stream, without the
    wrapper's checks or its launch count.  ``drop_last_split`` leaves the
    merging block's own split out of every merge: a planted fault that
    chip_smoke.py's check must reject."""
    b, _, h, hd = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    index = q.get_device()
    switch = index != torch.cuda.current_device()
    with torch.cuda.device(index) if switch else contextlib.nullcontext():
        stream = torch._C._cuda_getCurrentRawStream(index)
        size = scratch_floats(b, kvh, h // kvh, hd, nsplit)
        part = torch.empty(size, dtype=torch.float32, device=q.device) if size else None
        counters = _counters(index, stream, b * kvh)
        _build.check(
            _lib().decode_attention_launch(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_len.data_ptr(),
                kv_len.element_size(), out.data_ptr(), 0 if part is None else part.data_ptr(),
                counters.data_ptr(), b, t, h, kvh, hd, nsplit, DTYPE_CODES[q.dtype],
                PATH_CODES[path], int(drop_last_split), stream,
            ),
            "decode_attention",
        )


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,
) -> torch.Tensor:
    check_qkv(q, k_cache, v_cache)
    b, one, h, hd = q.shape
    if hd % 8:
        raise ValueError(f"head_dim {hd} must be a multiple of 8 (16-byte rows)")
    if one != 1:
        raise ValueError(f"decode takes one query token per row, got {one}")
    if not isinstance(kv_len, torch.Tensor) or kv_len.shape != (b,):
        raise ValueError(f"kv_len must be a ({b},) tensor")
    if kv_len.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"kv_len must be int32 or int64, got {kv_len.dtype}")
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, kv_len)
    if dev.type == "meta":
        return meta.decode(q, k_cache, v_cache)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("q and the caches must be contiguous")
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    group = h // kvh
    path = kernel_path(q.dtype, group, hd)
    if path == "simt" and group * hd > SIMT_THREADS * MAX_ACC:
        raise ValueError(f"group size {group} x head_dim {hd} exceeds the kernel's "
                         f"{SIMT_THREADS * MAX_ACC} accumulators per block")
    # The kernel reads int32 or int64 lengths where they lie: no copy when
    # they are on the card already (the model passes positions + 1, int64).
    if kv_len.device != dev or not kv_len.is_contiguous():
        kv_len = kv_len.to(device=dev).contiguous()
    out = torch.empty_like(q)
    launch(q, k_cache, v_cache, kv_len, out, path=path,
           nsplit=plan(b, kvh, t, _sms(q.get_device()), path, hd, group))
    decode_attention.launches += 1
    return out


#: Kernel launches since the last reset.
decode_attention.launches = 0
