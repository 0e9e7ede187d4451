"""xLSTM blocks (arXiv:2405.04517), the port of the reference's
``repro.models.xlstm``: mLSTM (matrix memory, parallelizable) and sLSTM
(scalar memory, recurrent) — the xlstm-1.3b architecture at ratio 7:1.

mLSTM state per head: C (hd×hd) matrix memory, n (hd) normalizer, m scalar
stabilizer.

    i_t = exp(ĩ_t),  f_t = σ(f̃_t)  (stabilized: m_t = max(log f + m⁻, log i))
    C_t = f C_{t−1} + i (v_t k_tᵀ)
    n_t = f n_{t−1} + i k_t
    h_t = (C_t q_t) / max(|n_tᵀ q_t|, 1)

Prefill and training use the reference's *chunkwise-parallel* form: a loop
over chunks of :data:`MLSTM_CHUNK` tokens carrying (C, n, m), the
intra-chunk part computed like attention, in float32 (float64 inputs keep
float64, for checks), as batched matmuls over (batch, head).  Decode is the O(hd²) recurrent step.  The carry update
``Σ_u w_u v_u k_uᵀ`` is two explicit steps (scale v by w_u, then one
matmul), so no (B, chunk, H, hd, hd) intermediate is built.  The reference
computes all of it in plain jnp and ``lax.scan``, outside any Pallas
kernel, so torch ops take its place here.

**Departure from the reference.** The carried term of a chunk is C q, as
in the decode step and the paper (:func:`carry_readout`).  The reference
contracts q with C's *first* (value) index (``"bthk,bhkl->bthl"``,
``src/repro/models/xlstm.py:150-152``), which is Cᵀq; its decode step
computes C q (``:209``).  In the first chunk C is 0, so the two agree up to
256 tokens; after that the reference's forward departs from its own
recurrent decode.  ``tests/test_torch_xlstm.py::
test_reference_mlstm_carry_contracts_the_value_index`` pins the
reference's behaviour, and the port's multi-chunk forward is held against
both packages' recurrent decode there.

As in the reference, a sequence longer than one chunk must be a whole
number of chunks (``s % min(256, s) == 0``): 257 to 511 tokens raise.

sLSTM keeps the true recurrence (h_{t−1} feeds the gates): a Python loop
over time, its four block-diagonal recurrent products in one batched
matmul a step, ``h_t`` rounded to the activation dtype every step as the
reference's scan carry is.

In decode mode (a ``cache``), both blocks update their state **in place**
and return the cache, as the port's RG-LRU block does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (
    ParamSpec,
    apply_norm,
    at_least_f32,
    loop_steps,
    norm_specs,
)
from repro_torch.models.layers import project_heads

MLSTM_CHUNK = 256


def mlstm_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    return {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", None)),
        "wk": ParamSpec((d, h, hd), ("embed", "heads", None)),
        "wv": ParamSpec((d, h, hd), ("embed", "heads", None)),
        "w_i": ParamSpec((d, h), ("embed", "heads")),
        "w_f": ParamSpec((d, h), ("embed", "heads")),
        "b_i": ParamSpec((h,), (None,), init="zeros"),
        "b_f": ParamSpec((h,), (None,), init="ones"),
        "w_o": ParamSpec((d, d), ("embed", None)),  # output gate
        "w_up": ParamSpec((d, 2 * d), ("embed", "ff")),
        "w_down": ParamSpec((2 * d, d), ("ff", "embed")),
        "wo": ParamSpec((h, hd, d), ("heads", None, "embed")),
        **{f"norm_{k}": v for k, v in norm_specs(cfg.norm_kind, d).items()},
    }


def slstm_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    return {
        # Input projections for z, i, f, o.
        "w_z": ParamSpec((d, d), ("embed", None)),
        "w_i": ParamSpec((d, d), ("embed", None)),
        "w_f": ParamSpec((d, d), ("embed", None)),
        "w_o": ParamSpec((d, d), ("embed", None)),
        # Block-diagonal recurrent matrices (per head hd×hd).
        "r_z": ParamSpec((h, hd, hd), ("heads", None, None)),
        "r_i": ParamSpec((h, hd, hd), ("heads", None, None)),
        "r_f": ParamSpec((h, hd, hd), ("heads", None, None)),
        "r_o": ParamSpec((h, hd, hd), ("heads", None, None)),
        "b_z": ParamSpec((d,), (None,), init="zeros"),
        "b_i": ParamSpec((d,), (None,), init="zeros"),
        "b_f": ParamSpec((d,), (None,), init="ones"),
        "b_o": ParamSpec((d,), (None,), init="zeros"),
        "w_proj": ParamSpec((d, d), ("embed", None)),
        **{f"norm_{k}": v for k, v in norm_specs(cfg.norm_kind, d).items()},
    }


def _norms(p: dict) -> dict:
    return {k[5:]: v for k, v in p.items() if k.startswith("norm_")}


def _scaled_heads(x: torch.Tensor, w: torch.Tensor, hd: int) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w) / sqrt(hd)``; the divisor in x's
    dtype, as the reference's weakly typed ``jnp.sqrt(hd)`` is."""
    return project_heads(x, w) / torch.tensor(math.sqrt(hd), dtype=x.dtype)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_gates(p: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """log-input-gate ĩ and log-forget-gate log σ(f̃), shapes (B,S,H), in
    float32 (float64 for float64 inputs)."""
    i_pre = x @ p["w_i"] + p["b_i"]
    f_pre = x @ p["w_f"] + p["b_f"]
    return at_least_f32(i_pre), F.logsigmoid(at_least_f32(f_pre))


def carry_readout(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The carried state read by each query row: C q.  q (B,H,L,hd), C
    (B,H,hd,hd) indexed [value, key] → (B,H,L,hd), ``out[k] = Σ_l C[k,l]
    q[l]``, as the decode step (and the paper) read it."""
    return q @ c.transpose(-1, -2)


def mlstm_chunk_parallel(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    state: tuple | None = None,
) -> tuple[torch.Tensor, tuple]:
    """Chunkwise-parallel mLSTM.  x (B,S,d) with S % min(256, S) == 0.
    Returns h (B,S,H,hd) in x's dtype and the final (C, n, m) in float32
    (float64 for float64 inputs)."""
    b, s, d = x.shape
    h = cfg.num_heads
    hd = d // h
    chunk = min(MLSTM_CHUNK, s)
    if s % chunk:
        raise ValueError(
            f"mLSTM prefill of {s} tokens: a sequence longer than one chunk must be a "
            f"whole number of {MLSTM_CHUNK}-token chunks (the reference asserts it too)"
        )
    # (B,H,S,·): each chunk's products are batched matmuls over (B, H).
    q = at_least_f32(_scaled_heads(x, p["wq"], hd).transpose(1, 2))
    k = at_least_f32(_scaled_heads(x, p["wk"], hd).transpose(1, 2))
    v = at_least_f32(project_heads(x, p["wv"]).transpose(1, 2))
    i_pre, log_f = (g.transpose(1, 2) for g in _mlstm_gates(p, x))  # (B,H,S)

    if state is None:
        c = q.new_zeros((b, h, hd, hd))
        n = q.new_zeros((b, h, hd))
        m = q.new_zeros((b, h))
    else:
        c, n, m = state
    future = ~torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    outs = []
    for j in loop_steps(s // chunk):
        j *= chunk
        qj, kj, vj = q[:, :, j : j + chunk], k[:, :, j : j + chunk], v[:, :, j : j + chunk]
        ij, fj = i_pre[:, :, j : j + chunk], log_f[:, :, j : j + chunk]
        csum_f = fj.cumsum(-1)  # (B,H,L): Σ log f within the chunk
        total_f = csum_f[..., -1]
        log_w_inter = csum_f + m[..., None]  # weight of the carry-in at t
        # a[t, u] = i_u + csum_f_t − csum_f_u for u ≤ t.
        a = csum_f[..., :, None] - csum_f[..., None, :] + ij[..., None, :]  # (B,H,t,u)
        a = a.masked_fill(future, -math.inf)
        m_t = torch.maximum(a.amax(-1), log_w_inter)  # (B,H,L)
        w_intra = torch.exp(a - m_t[..., None])
        w_inter = torch.exp(log_w_inter - m_t)
        # Intra-chunk attention-like term; the normalizer n_t·q_t is the
        # weighted scores' sum.
        scores = (qj @ kj.transpose(-1, -2)) * w_intra
        num_intra = scores @ vj
        den_intra = scores.sum(-1)
        # Inter-chunk carry term: C q (see carry_readout).
        num_inter = carry_readout(qj, c) * w_inter[..., None]
        den_inter = (qj @ n[..., None])[..., 0] * w_inter
        den = torch.abs(den_intra + den_inter)
        outs.append((num_intra + num_inter) / torch.maximum(den, torch.exp(-m_t))[..., None])
        # Carry to the chunk's end: C ← w_c C + Σ_u w_u v_u k_uᵀ, as
        # (v scaled by w_u)ᵀ @ k.
        decay = total_f[..., None] - csum_f + ij  # (B,H,L)
        m_new = torch.maximum(m + total_f, decay.amax(-1))
        w_c = torch.exp(m + total_f - m_new)
        w_u = torch.exp(decay - m_new[..., None])
        c = c * w_c[..., None, None] + (vj * w_u[..., None]).transpose(-1, -2) @ kj
        n = n * w_c[..., None] + (w_u[..., None, :] @ kj)[..., 0, :]
        m = m_new
    outs *= s // chunk // len(outs)  # one folded step stands for all (loop_steps)
    hs = torch.cat(outs, dim=2).transpose(1, 2).to(x.dtype)  # (B,S,H,hd)
    return hs, (c, n, m)


def _mlstm_step(cfg: ModelConfig, p: dict, normed: torch.Tensor, cache: dict) -> torch.Tensor:
    """The recurrent decode step on (B,1,d): updates C, n, m in place and
    returns h (B,1,H,hd) in the activation dtype."""
    hd = normed.shape[-1] // cfg.num_heads
    q = at_least_f32(_scaled_heads(normed, p["wq"], hd)[:, 0])  # (B,H,hd)
    k = at_least_f32(_scaled_heads(normed, p["wk"], hd)[:, 0])
    v = at_least_f32(project_heads(normed, p["wv"])[:, 0])
    i_pre, log_f = (g[:, 0] for g in _mlstm_gates(p, normed))  # (B,H)
    c, n, m_prev = cache["C"], cache["n"], cache["m"]
    m_t = torch.maximum(log_f + m_prev, i_pre)
    w_f = torch.exp(log_f + m_prev - m_t)
    w_i = torch.exp(i_pre - m_t)
    c.mul_(w_f[..., None, None]).add_(w_i[..., None, None] * (v[..., :, None] * k[..., None, :]))
    n.mul_(w_f[..., None]).add_(w_i[..., None] * k)
    m_prev.copy_(m_t)
    num = (c @ q[..., None])[..., 0]
    den = torch.abs((n * q).sum(-1))
    h_t = num / torch.maximum(den, torch.exp(-m_t))[..., None]
    return h_t[:, None].to(normed.dtype)


def mlstm_block(
    cfg: ModelConfig, p: dict, x: torch.Tensor, *, cache: dict | None = None
) -> tuple[torch.Tensor, dict]:
    """Pre-norm mLSTM, output gate, residual, then the block's 2× GELU
    up/down projection.  Without ``cache`` (sequence mode) returns the built
    decode state ``{"C", "n", "m"}``; with it (decode, S = 1) updates it in
    place and returns it."""
    normed = apply_norm(cfg.norm_kind, _norms(p), x)
    if cache is None:
        hs, (c_f, n_f, m_f) = mlstm_chunk_parallel(cfg, p, normed)
        new_cache = {"C": c_f, "n": n_f, "m": m_f}
    else:
        hs = _mlstm_step(cfg, p, normed, cache)
        new_cache = cache
    o_gate = torch.sigmoid(normed @ p["w_o"])
    wo = p["wo"]
    y = x + (hs.flatten(-2) @ wo.reshape(-1, wo.shape[-1])) * o_gate
    # Position-wise up/down projection (the block's internal 2× FFN).
    y = y + F.gelu(y @ p["w_up"], approximate="tanh") @ p["w_down"]
    return y, new_cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_block(
    cfg: ModelConfig, p: dict, x: torch.Tensor, *, cache: dict | None = None
) -> tuple[torch.Tensor, dict]:
    """The sLSTM recurrence over x (B,S,d), then its projection and
    residual.  Without ``cache`` starts from zeros and returns the built
    state ``{"c", "n", "h", "m"}``; with it continues from the cache and
    updates it in place.  ``h`` is kept in x's dtype, the rest in f32."""
    b, s, d = x.shape
    h = cfg.num_heads
    hd = d // h
    normed = apply_norm(cfg.norm_kind, _norms(p), x)
    # The four gate inputs side by side, (B,S,4,d): z, i, f, o.
    pre = torch.stack([normed @ p[f"w_{g}"] + p[f"b_{g}"] for g in "zifo"], dim=2)
    # Block-diagonal recurrent matrices side by side: (H, hd, 4·hd).
    r = torch.cat([p[f"r_{g}"] for g in "zifo"], dim=-1)

    if cache is None:
        h_t = x.new_zeros((b, d))
        c_t = n_t = m_t = at_least_f32(h_t)
    else:
        if cache["h"].dtype != x.dtype:
            raise TypeError(
                f"sLSTM cache h is {cache['h'].dtype}, activations {x.dtype}: the state is "
                "carried in the activation dtype (the reference's scan rejects a mismatch too)"
            )
        c_t, n_t, h_t, m_t = cache["c"], cache["n"], cache["h"], cache["m"]
    hs = []
    for t in loop_steps(s):
        # einsum("bhk,hkl->bhl", h_prev, r_g) for the four gates at once.
        rec = torch.bmm(h_t.view(b, h, hd).transpose(0, 1), r)  # (H,B,4·hd)
        rec = rec.view(h, b, 4, hd).permute(1, 2, 0, 3).reshape(b, 4, d)
        z_pre, i_pre, f_pre, o_pre = (pre[:, t] + rec).unbind(1)
        z = torch.tanh(z_pre)
        o = torch.sigmoid(o_pre)
        i_pre = at_least_f32(i_pre)
        log_f = F.logsigmoid(at_least_f32(f_pre))
        m_new = torch.maximum(log_f + m_t, i_pre)
        i_g = torch.exp(i_pre - m_new)
        f_g = torch.exp(log_f + m_t - m_new)
        c_t = f_g * c_t + i_g * at_least_f32(z)
        n_t = f_g * n_t + i_g
        h_t = (at_least_f32(o) * c_t / torch.clamp(n_t, min=1e-6)).to(x.dtype)
        m_t = m_new
        hs.append(h_t)
    hs *= s // max(len(hs), 1)  # one folded step stands for all (loop_steps)
    out = x + torch.stack(hs, dim=1) @ p["w_proj"]
    if cache is None:
        return out, {"c": c_t, "n": n_t, "h": h_t, "m": m_t}
    for name, value in (("c", c_t), ("n", n_t), ("h", h_t), ("m", m_t)):
        cache[name].copy_(value)
    return out, cache
