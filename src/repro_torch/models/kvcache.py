"""Decode caches as trees with a stacked layer dim, as in the reference.

Cache layout mirrors the parameter layout: one stacked entry per pattern
position (leading dim = cycles), plus unstacked entries for remainder blocks
and, for enc-dec models, a per-decoder-layer cross-attention cache.  So a
``scan`` leaf of an attention block is ``(cycles, batch, cap, KV, hd)``: the
batch (sequence slot) is axis 1, not axis 0.  A LOCAL_ATTN leaf is a ring of
``min(local_window, capacity)`` slots (token t in slot t % w, written by
:func:`update_kv`'s ``positions % cap``); an RGLRU block keeps its state
``h`` ``(batch, W)`` in float32 and its conv buffer ``conv`` ``(batch, 3,
W)`` of raw inputs, oldest first, updated in place by the block.  An MLSTM
block keeps ``C`` ``(batch, H, hd, hd)``, ``n`` ``(batch, H, hd)`` and
``m`` ``(batch, H)`` in float32; an SLSTM block ``c``, ``n``, ``m``
``(batch, d)`` in float32 and ``h`` in the activation dtype (bf16 here, as
the reference hard-wires); both update them in place in decode.  An
encoder-decoder model's ``cross`` leaves are ``(cycles, batch, enc_len,
KV, hd)``: the same shapes a prefill with ``enc_len`` encoder frames
builds (``Model.forward(build_cache=True, encoder_embeds=...)``).

``init_cache`` materializes zeros for serving, ``cache_specs`` the same
tree as meta tensors (the dry run's stand-ins), and ``cache_logical`` the
logical axes of every leaf, which :mod:`repro_torch.launch.sharding`
resolves onto a mesh.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import (
    ATTN,
    ATTN_MOE,
    LOCAL_ATTN,
    MLSTM,
    RGLRU,
    SLSTM,
    ModelConfig,
)
from repro_torch.device import resolve_device


def _block_cache_shapes(
    cfg: ModelConfig, kind: str, batch: int, capacity: int
) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    h = cfg.num_heads
    d = cfg.d_model
    if kind in (ATTN, ATTN_MOE):
        cap = min(capacity, cfg.max_seq_len)
        return {
            "k": ((batch, cap, kv, hd), torch.bfloat16),
            "v": ((batch, cap, kv, hd), torch.bfloat16),
        }
    if kind == LOCAL_ATTN:
        w = min(cfg.local_window, capacity)
        return {
            "k": ((batch, w, kv, hd), torch.bfloat16),
            "v": ((batch, w, kv, hd), torch.bfloat16),
        }
    if kind == RGLRU:
        w = cfg.lru_width or d
        return {
            "h": ((batch, w), torch.float32),
            "conv": ((batch, 3, w), torch.bfloat16),
        }
    if kind == MLSTM:
        mhd = d // h
        return {
            "C": ((batch, h, mhd, mhd), torch.float32),
            "n": ((batch, h, mhd), torch.float32),
            "m": ((batch, h), torch.float32),
        }
    if kind == SLSTM:
        return {
            "c": ((batch, d), torch.float32),
            "n": ((batch, d), torch.float32),
            "h": ((batch, d), torch.bfloat16),
            "m": ((batch, d), torch.float32),
        }
    raise ValueError(kind)


_LOGICAL_BY_KIND: dict[str, dict[str, tuple]] = {
    ATTN: {
        "k": ("cache_batch", "cache_seq", "cache_heads", None),
        "v": ("cache_batch", "cache_seq", "cache_heads", None),
    },
    LOCAL_ATTN: {
        "k": ("cache_batch", "cache_seq", "cache_heads", None),
        "v": ("cache_batch", "cache_seq", "cache_heads", None),
    },
    RGLRU: {"h": ("cache_batch", "lru"), "conv": ("cache_batch", None, "lru")},
    MLSTM: {
        "C": ("cache_batch", "heads", None, None),
        "n": ("cache_batch", "heads", None),
        "m": ("cache_batch", "heads"),
    },
    SLSTM: {
        "c": ("cache_batch", None),
        "n": ("cache_batch", None),
        "h": ("cache_batch", None),
        "m": ("cache_batch", None),
    },
}
_LOGICAL_BY_KIND[ATTN_MOE] = _LOGICAL_BY_KIND[ATTN]


def cache_logical(cfg: ModelConfig) -> dict:
    """Logical-axis tree mirroring the cache_specs/init_cache structure."""
    out: dict[str, Any] = {"scan": [], "rem": []}
    for kind in cfg.pattern:
        out["scan"].append({n: ("layers", *ax) for n, ax in _LOGICAL_BY_KIND[kind].items()})
    for kind in cfg.remainder:
        out["rem"].append(dict(_LOGICAL_BY_KIND[kind]))
    if cfg.is_encdec:
        out["cross"] = {
            "k": ("layers", "cache_batch", "cache_seq", "cache_heads", None),
            "v": ("layers", "cache_batch", "cache_seq", "cache_heads", None),
        }
    return out


def _build(
    cfg: ModelConfig,
    batch: int,
    capacity: int,
    make: Callable[[tuple[int, ...], torch.dtype], torch.Tensor],
    enc_len: int = 0,
) -> dict:
    cache: dict[str, Any] = {"scan": [], "rem": []}
    for kind in cfg.pattern:
        shapes = _block_cache_shapes(cfg, kind, batch, capacity)
        cache["scan"].append(
            {n: make((cfg.cycles, *shp), dt) for n, (shp, dt) in shapes.items()}
        )
    for kind in cfg.remainder:
        shapes = _block_cache_shapes(cfg, kind, batch, capacity)
        cache["rem"].append({n: make(shp, dt) for n, (shp, dt) in shapes.items()})
    if cfg.is_encdec:
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        # Cross-attention k/v over the encoder sequence, one per decoder layer.
        cache["cross"] = {
            "k": make((cfg.cycles, batch, enc_len, kv, hd), torch.bfloat16),
            "v": make((cfg.cycles, batch, enc_len, kv, hd), torch.bfloat16),
        }
    return cache


def cache_specs(cfg: ModelConfig, batch: int, capacity: int, enc_len: int = 0) -> dict:
    """The cache tree of :func:`init_cache` as meta tensors (no storage)."""
    return _build(
        cfg, batch, capacity,
        lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta"),
        enc_len=enc_len,
    )


def init_cache(
    cfg: ModelConfig, batch: int, capacity: int, enc_len: int = 0, *, device="cuda"
) -> dict:
    """Zero caches for ``batch`` slots of ``capacity`` positions (bf16 k/v,
    as the reference hard-wires), on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    return _build(
        cfg, batch, capacity,
        lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=device),
        enc_len=enc_len,
    )


def cache_capacity(cfg: ModelConfig, kind: str, capacity: int) -> int:
    if kind == LOCAL_ATTN:
        return min(cfg.local_window, capacity)
    return min(capacity, cfg.max_seq_len)


def update_kv(
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    positions: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one token's k/v (B,1,KV,hd) at per-batch positions (mod
    capacity).

    Writes **in place** into ``cache_k``/``cache_v`` and returns them: the
    reference's functional update copies the whole cache, which at serving
    sizes is gigabytes per token.  Mixed dtypes raise, as the reference's
    ``dynamic_update_slice`` does.
    """
    if k_new.dtype != cache_k.dtype or v_new.dtype != cache_v.dtype:
        raise TypeError(
            f"cache is {cache_k.dtype}, new k/v are {k_new.dtype}: the reference's "
            "update_kv rejects mixed dtypes too"
        )
    cap = cache_k.shape[1]
    rows = torch.arange(cache_k.shape[0], device=cache_k.device)
    idx = positions.to(cache_k.device).long() % cap
    cache_k[rows, idx] = k_new[:, 0]
    cache_v[rows, idx] = v_new[:, 0]
    return cache_k, cache_v
