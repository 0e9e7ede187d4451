"""Single-token flash-decode attention: the CUDA kernel's wrapper.

``decode_attention(q, k_cache, v_cache, kv_len)`` takes q (B,1,H,hd), the
caches (B,T,KV,hd), contiguous, bf16 or f32, and per-row lengths ``kv_len``
(B,) in ``[1, T]``; slots at or past ``kv_len[b]`` are masked.  Returns
(B,1,H,hd) in q's dtype.  A CUDA tensor launches
``csrc/decode_attention.cu`` on the current stream; a CPU tensor takes the
plain version in :mod:`.ref`.  Nothing falls back: a launch that fails
raises.

The kernel splits each row's keys over ``nsplit`` blocks per (row, KV
head) and merges their partial softmax states in a second launch
(:func:`plan` picks ``nsplit`` so that about two blocks run on every SM).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import DTYPE_CODES, check_qkv

#: Accumulator slots a thread of the kernel holds (G·hd ≤ 256 · MAX_ACC).
MAX_ACC = 16
THREADS = 256
TILE_KEYS = 64
BLOCKS_PER_SM = 2


def plan(batch: int, kv_heads: int, capacity: int, sms: int) -> int:
    """Key splits per (row, KV head): enough blocks for ``BLOCKS_PER_SM`` on
    each of ``sms`` SMs, at most one per 64-key tile of the cache."""
    want = -(-BLOCKS_PER_SM * sms // max(batch * kv_heads, 1))
    return max(1, min(want, -(-capacity // TILE_KEYS)))


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,
) -> torch.Tensor:
    check_qkv(q, k_cache, v_cache)
    b, one, h, hd = q.shape
    if one != 1:
        raise ValueError(f"decode takes one query token per row, got {one}")
    if not isinstance(kv_len, torch.Tensor) or kv_len.shape != (b,):
        raise ValueError(f"kv_len must be a ({b},) tensor")
    if kv_len.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"kv_len must be int32 or int64, got {kv_len.dtype}")
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, kv_len)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("q and the caches must be contiguous")
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    if (h // kvh) * hd > THREADS * MAX_ACC:
        raise ValueError(f"group size {h // kvh} x head_dim {hd} exceeds the kernel's "
                         f"{THREADS * MAX_ACC} accumulators per block")
    lens = kv_len.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    nsplit = plan(b, kvh, t, torch.cuda.get_device_properties(dev).multi_processor_count)
    # f32 partial (acc, m, l) of every split; unused when nsplit is 1.
    part_acc = torch.empty(b * h * hd * nsplit, dtype=torch.float32, device=dev)
    part_ml = torch.empty(b * h * 2 * nsplit, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(
            lib.decode_attention_launch(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
                out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
                b, t, h, kvh, hd, nsplit, DTYPE_CODES[q.dtype], stream,
            ),
            "decode_attention",
        )
    decode_attention.launches += 1
    return out


#: Kernel launches since the last reset.
decode_attention.launches = 0
