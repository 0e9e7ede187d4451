"""Attention (GQA full / chunked-flash / decode / cross) and MLP (SwiGLU /
GeGLU / GELU) layers, functional style.

GQA is computed with an explicit group dimension so repeated KV heads are
never materialized:  q (B,S,KV,G,hd) × k (B,T,KV,hd) → scores (B,KV,G,S,T).

On a CUDA tensor, :func:`attention` runs the hand-written flash kernel
(:mod:`repro_torch.kernels.flash_attention`) at every length,
:func:`decode_attention` the decode kernel
(:mod:`repro_torch.kernels.decode_attention`), and :func:`cross_attention`
(an encoder-decoder's cross sublayer) the one or the other by query
length, at exactly the call sites where the reference calls their XLA
counterparts.  A meta tensor (the dry run's trace) takes the same route,
into the kernels' meta arms.  On a CPU tensor all three keep the
reference's own math (full or chunked attention), so the CPU tests compare
like with like.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention as decode_kernel
from repro_torch.kernels.flash_attention import flash_attention as flash_kernel
from repro_torch.models.common import (
    ParamSpec,
    apply_mrope,
    apply_rope,
    at_least_f32,
    norm_specs,
    text_mrope_positions,
)

NEG_INF = -2.0e38
CHUNK_Q = 1024
CHUNK_KV = 1024
FULL_ATTN_MAX_SEQ = 8192  # above this, use the chunked path (CPU)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def attn_specs(cfg: ModelConfig, *, cross: bool = False) -> dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
        **{f"norm_{k}": v for k, v in norm_specs(cfg.norm_kind, d).items()},
    }


def mlp_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {
            "w_gate": ParamSpec((d, f), ("embed", "ff")),
            "w_up": ParamSpec((d, f), ("embed", "ff")),
            "w_down": ParamSpec((f, d), ("ff", "embed")),
            **{f"norm_{k}": v for k, v in norm_specs(cfg.norm_kind, d).items()},
        }
    return {
        "w_up": ParamSpec((d, f), ("embed", "ff")),
        "w_down": ParamSpec((f, d), ("ff", "embed")),
        **{f"norm_{k}": v for k, v in norm_specs(cfg.norm_kind, d).items()},
    }


# ---------------------------------------------------------------------------
# Projections + positional encoding
# ---------------------------------------------------------------------------


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matmul."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).unflatten(-1, (h, hd))


def qkv_project(
    cfg: ModelConfig, p: dict, x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return (
        project_heads(x, p["wq"]),
        project_heads(x, p["wk"]),
        project_heads(x, p["wv"]),
    )


def position_encode(
    cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    if cfg.rope_kind == "rope":
        return (
            apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta),
        )
    if cfg.rope_kind == "mrope":
        thw = text_mrope_positions(positions)
        return (
            apply_mrope(q, thw, cfg.rope_theta),
            apply_mrope(k, thw, cfg.rope_theta),
        )
    return q, k  # "none" | "learned" (handled at the embedding)


# ---------------------------------------------------------------------------
# Core attention math (GQA, grouped) — the reference's, for CPU tensors
# ---------------------------------------------------------------------------


def _grouped(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    b, s, h, hd = q.shape
    return q.reshape(b, s, num_kv, h // num_kv, hd)


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int] = None,
    q_offset: int | torch.Tensor = 0,
    kv_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Unchunked GQA attention.  q (B,S,H,hd); k,v (B,T,KV,hd)."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    dev = q.device
    qg = _grouped(q, kvh)  # (B,S,KV,G,hd)
    scores = at_least_f32(torch.einsum("bskgh,btkh->bkgst", qg, k))
    scores = scores / torch.tensor(math.sqrt(hd), dtype=torch.float32)
    # Positions: q_offset may be scalar or per-batch (B,) (windowed decode).
    offset = torch.as_tensor(q_offset, device=dev)
    spos = torch.arange(s, device=dev)[None, :, None] + offset.reshape(-1, 1, 1)
    tpos = torch.arange(t, device=dev)[None, None, :]
    mask = torch.ones(torch.broadcast_shapes(spos.shape, tpos.shape), dtype=torch.bool,
                      device=dev)
    if causal:
        mask &= tpos <= spos
    if window is not None:
        mask &= tpos > spos - window
    scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    if kv_len is not None:  # decode: only the first kv_len cache slots exist
        valid = torch.arange(t, device=dev)[None, :] < kv_len[:, None]  # (B,T)
        scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(b, s, h, hd)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk_q: int = CHUNK_Q,
    chunk_kv: int = CHUNK_KV,
) -> torch.Tensor:
    """Flash-style online-softmax attention with O(S·chunk) memory: an outer
    loop over query chunks, an inner loop over KV chunks with an
    (m, l, acc) carry.  Fully masked chunks are still computed, as on the
    reference's XLA path."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    nq, nkv = s // chunk_q, t // chunk_kv
    assert s % chunk_q == 0 and t % chunk_kv == 0, (s, t, chunk_q, chunk_kv)
    dev = q.device
    scale = 1.0 / torch.tensor(math.sqrt(hd), dtype=torch.float32)
    qg = _grouped(q, kvh)
    outs = []
    for qi in range(nq):
        q_chunk = qg[:, qi * chunk_q : (qi + 1) * chunk_q]  # (B,Cq,KV,G,hd)
        m = torch.full((b, kvh, g, chunk_q), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, kvh, g, chunk_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kvh, g, chunk_q, hd), dtype=torch.float32, device=dev)
        spos = qi * chunk_q + torch.arange(chunk_q, device=dev)[:, None]
        for kj in range(nkv):
            k_chunk = k[:, kj * chunk_kv : (kj + 1) * chunk_kv]
            v_chunk = v[:, kj * chunk_kv : (kj + 1) * chunk_kv]
            sc = torch.einsum("bskgh,btkh->bkgst", q_chunk, k_chunk).float() * scale
            tpos = kj * chunk_kv + torch.arange(chunk_kv, device=dev)[None, :]
            mask = torch.ones((chunk_q, chunk_kv), dtype=torch.bool, device=dev)
            if causal:
                mask &= tpos <= spos
            if window is not None:
                mask &= tpos > spos - window
            sc = sc.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bkgst,btkh->bkgsh", p.to(v_chunk.dtype), v_chunk)
            acc = acc * alpha[..., None] + pv.float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-37)[..., None]  # (B,KV,G,Cq,hd)
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))  # (B,Cq,KV,G,hd)
    return torch.cat(outs, dim=1).reshape(b, s, h, hd)


# ---------------------------------------------------------------------------
# Routed entry points
# ---------------------------------------------------------------------------


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    max_full_seq: int = FULL_ATTN_MAX_SEQ,
) -> torch.Tensor:
    if q.is_cuda or q.is_meta:
        return flash_kernel(q, k, v, causal=causal, window=window)
    s = q.shape[1]
    if s <= max_full_seq or s % CHUNK_Q != 0 or k.shape[1] % CHUNK_KV != 0:
        return full_attention(q, k, v, causal=causal, window=window)
    return chunked_attention(q, k, v, causal=causal, window=window)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unmasked attention of the decoder's queries q (B,S,H,hd) over the
    encoder's keys and values k, v (B,T,KV,hd), where the reference calls
    ``full_attention(causal=False)``.

    On a CUDA tensor: the flash kernel for S > 1 (or where autograd needs
    its Function), the decode kernel with ``kv_len = T`` for one query
    token.  On a CPU tensor: the reference's math.  With T = 0 (the
    reference's serve loop decodes against an empty encoder) the result is
    exactly 0, which is the reference's too; nothing is launched.
    """
    if k.shape[1] == 0:
        return torch.zeros_like(q)
    if not (q.is_cuda or q.is_meta):
        return full_attention(q, k, v, causal=False)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if q.shape[1] == 1 and not grad:
        kv_len = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32, device=q.device)
        return decode_kernel(q, k, v, kv_len)
    return flash_kernel(q, k, v, causal=False)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One-token decode against a (B,T,KV,hd) cache with per-batch lengths."""
    if q.is_cuda or q.is_meta:
        if window is not None:
            raise NotImplementedError(
                "windowed decode over a linear cache has no CUDA kernel: the decode "
                "kernel, like the TPU one, takes no window.  The model decodes "
                "LOCAL_ATTN on its ring cache, which needs none"
            )
        return decode_kernel(q, k_cache, v_cache, kv_len)
    return full_attention(
        q,
        k_cache,
        v_cache,
        causal=False,
        window=window,
        q_offset=torch.clamp(kv_len - 1, min=0) if window is not None else 0,
        kv_len=kv_len,
    )


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_forward(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_kind == "swiglu":
        gate = F.silu(x @ p["w_gate"])
        return (gate * (x @ p["w_up"])) @ p["w_down"]
    if cfg.mlp_kind == "geglu":
        gate = F.gelu(x @ p["w_gate"], approximate="tanh")
        return (gate * (x @ p["w_up"])) @ p["w_down"]
    return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]
