"""RecurrentGemma RG-LRU block (arXiv:2402.19427), the port of the
reference's ``repro.models.rglru``.

Block structure (Griffin recurrent block):

    x ─ norm ─┬─ linear → GeLU ───────────────────┐
              └─ linear → conv1d(4) → RG-LRU ──────┤⊙ → linear → + residual

RG-LRU recurrence (per channel):

    r_t = σ(W_a x_t + b_a)                    recurrence gate
    i_t = σ(W_x x_t + b_x)                    input gate
    a_t = exp(−c · softplus(Λ) · r_t)         gated decay, a ∈ (0,1)
    h_t = a_t · h_{t−1} + √(1 − a_t²) · (i_t ⊙ x_t)

The prefill scans through the ``rglru_scan`` kernel (:mod:`repro_torch.
kernels.rglru_scan`: CUDA on the card, the plain sequential recurrence on
the CPU) where the reference runs ``jax.lax.associative_scan``; decode is
the O(1) step.  The reference's dtypes are kept: the gates and the carry in
float32, the scan's output in the activation dtype, the built ``h`` in
float32 and the conv buffer in the activation dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan import rglru_scan as scan_kernel
from repro_torch.models.common import ParamSpec, apply_norm, norm_specs

RGLRU_C = 8.0  # the paper's fixed decay temperature
CONV_WIDTH = 4


def rglru_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "w_gate_branch": ParamSpec((d, w), ("embed", "lru")),
        "w_x_branch": ParamSpec((d, w), ("embed", "lru")),
        "conv_w": ParamSpec((CONV_WIDTH, w), (None, "lru")),
        "conv_b": ParamSpec((w,), ("lru",), init="zeros"),
        "w_a": ParamSpec((w, w), ("lru", None)),
        "b_a": ParamSpec((w,), (None,), init="zeros"),
        "w_i": ParamSpec((w, w), ("lru", None)),
        "b_i": ParamSpec((w,), (None,), init="zeros"),
        "lam": ParamSpec((w,), (None,), init="ones"),  # Λ (softplus → decay)
        "w_out": ParamSpec((w, d), ("lru", "embed")),
        **{f"norm_{k}": v for k, v in norm_specs(cfg.norm_kind, d).items()},
    }


def _decay(p: dict, gated_x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (a_t, gated input b_t) for the recurrence h = a·h⁻ + b.

    ``gated_x`` is float32; the weights are upcast to it, as JAX promotes a
    float32 by bfloat16 product.  softplus(Λ) and its scaling stay in the
    parameters' dtype, as in the reference."""
    r = torch.sigmoid(gated_x @ p["w_a"].to(gated_x.dtype) + p["b_a"])
    i = torch.sigmoid(gated_x @ p["w_i"].to(gated_x.dtype) + p["b_i"])
    log_a = -RGLRU_C * F.softplus(p["lam"]) * r  # (…, w)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) * (i * gated_x)
    return a, b


def conv1d_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width 4.  x (B,S,W); w (4,W)."""
    pads = F.pad(x, (0, 0, CONV_WIDTH - 1, 0))
    out = sum(pads[:, i : i + x.shape[1], :] * w[i] for i in range(CONV_WIDTH))
    return out + b


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None) -> torch.Tensor:
    """h_t = a_t h_{t−1} + b_t over axis 1, through the scan kernel (h0 = 0
    when absent, which the reference's fold ``b_0 += a_0·h0`` also gives)."""
    if h0 is None:
        h0 = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32, device=a.device)
    return scan_kernel(a, b, h0)


def rglru_forward(
    cfg: ModelConfig, p: dict, x_branch: torch.Tensor, h0: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequence form.  x_branch (B,S,W) post-conv; returns (h_seq, h_last)."""
    a, b = _decay(p, x_branch.float())
    h = rglru_scan(a, b, h0)
    return h.to(x_branch.dtype), h[:, -1, :]


def rglru_step(
    cfg: ModelConfig, p: dict, x_t: torch.Tensor, h_prev: torch.Tensor
) -> torch.Tensor:
    """Decode step.  x_t (B,W); h_prev (B,W) → h_t in x_t's dtype."""
    a, bb = _decay(p, x_t.float())
    return (a * h_prev + bb).to(x_t.dtype)


def rglru_block(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    *,
    cache: dict | None = None,
) -> tuple[torch.Tensor, dict]:
    """Full Griffin recurrent block.  x (B,S,d).

    Without ``cache`` (prefill) returns the built decode cache: the final
    state ``h`` (B,W) in float32 and the last 3 raw (pre-conv) inputs
    ``conv`` (B,3,W), oldest first.  With ``cache`` (decode, S = 1) it
    updates {"h", "conv"} **in place** and returns it: the reference returns
    new arrays, with ``h`` in the activation dtype; a bfloat16 ``h_t``
    written into the float32 buffer keeps the reference's values exactly.
    """
    normed = apply_norm(
        cfg.norm_kind,
        {k[5:]: v for k, v in p.items() if k.startswith("norm_")},
        x,
    )
    gate = F.gelu(normed @ p["w_gate_branch"], approximate="tanh")
    xb = normed @ p["w_x_branch"]

    if cache is None:
        xb_conv = conv1d_causal(xb, p["conv_w"], p["conv_b"])
        h, h_last = rglru_forward(cfg, p, xb_conv)
        out = (gate * h) @ p["w_out"]
        s = xb.shape[1]
        conv_buf = xb[:, -3:, :] if s >= 3 else F.pad(xb, (0, 0, 3 - s, 0))
        return x + out, {"h": h_last.float(), "conv": conv_buf}

    # Decode: xb (B,1,W).  Conv over the rolling buffer of the last 3 inputs.
    if cache["conv"].dtype != xb.dtype:
        raise TypeError(
            f"conv cache is {cache['conv'].dtype}, activations {xb.dtype}: the buffer is "
            "updated in place and keeps its dtype"
        )
    xb_t = xb[:, 0, :]
    window = torch.cat([cache["conv"], xb_t[:, None, :]], dim=1)  # (B,4,W)
    conv_out = torch.einsum("bcw,cw->bw", window, p["conv_w"]) + p["conv_b"]
    h_t = rglru_step(cfg, p, conv_out, cache["h"])
    out = (gate[:, 0, :] * h_t) @ p["w_out"]
    cache["h"].copy_(h_t)
    cache["conv"].copy_(window[:, 1:, :])
    return x + out[:, None, :], cache
