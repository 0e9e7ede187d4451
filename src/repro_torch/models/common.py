"""Shared model primitives: norms, RoPE variants, initializers and tree
helpers for the parameter/cache trees (nested dicts and lists of tensors).

Parameters carry *logical* axis names (``ParamSpec.logical``) as plain data,
as in the reference; resolving them onto a device mesh waits for the mesh
tooling (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree: Any, is_leaf: Callable = None) -> Any:
    """``fn`` over the leaves of nested dicts/lists/tuples, keeping the
    structure."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, t, is_leaf) for k, t in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, is_leaf) for t in tree)
    return fn(tree)


def tree_leaves(tree: Any, is_leaf: Callable = None) -> list:
    """Leaves in the reference's flatten order (dict keys sorted)."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t, is_leaf)]
    return [tree]


def tree_unflatten(tree: Any, leaves: list) -> Any:
    """``tree``'s structure with its leaves replaced by ``leaves``, given in
    :func:`tree_leaves` order (dicts keep their own key order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(tree)


# ---------------------------------------------------------------------------
# Parameter specs and initialization
# ---------------------------------------------------------------------------

#: Largest f32 draw made at once while initializing (elements): a stacked
#: (cycles, d, f) leaf is drawn one leading slice at a time below this.
_DRAW_CHUNK = 1 << 28


@dataclasses.dataclass
class ParamSpec:
    """A parameter: shape, logical axes, initializer."""

    shape: tuple[int, ...]
    logical: tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 1.0

    def initializer(
        self, gen: torch.Generator, dtype: torch.dtype, device: torch.device
    ) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        # The reference's rule, kept exactly: std = scale / sqrt(shape[-2]).
        # For the 3-D projections (d, heads, hd) and (heads, hd, d) that
        # fan-in is heads or head_dim, not d_model.
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        std = self.scale / math.sqrt(max(fan_in, 1))
        out = torch.empty(self.shape, dtype=dtype, device=device)
        rows = out.view(-1, *self.shape[-2:]) if len(self.shape) >= 3 else out[None]
        per = max(1, _DRAW_CHUNK // max(rows[0].numel(), 1))
        for i in range(0, rows.shape[0], per):
            part = rows[i : i + per]
            draw = torch.randn(
                part.shape, generator=gen, dtype=torch.float32, device=device
            )
            part.copy_(draw.mul_(std))
        return out


def init_from_specs(
    tree_specs: Any, gen: torch.Generator, dtype: torch.dtype, device: torch.device
) -> Any:
    """Materialize a ParamSpec tree; leaves drawn from ``gen`` in the
    reference's flatten order (dict keys sorted)."""
    is_spec = lambda x: isinstance(x, ParamSpec)  # noqa: E731
    values = {
        id(s): s.initializer(gen, dtype, device)
        for s in tree_leaves(tree_specs, is_leaf=is_spec)
    }
    return tree_map(lambda s: values[id(s)], tree_specs, is_leaf=is_spec)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, as the reference's ``astype(jnp.float32)``; a
    float64 input keeps float64 (for checks that run a model in float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = at_least_f32(x)
    var = xf.square().mean(-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + at_least_f32(scale))).to(x.dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    xf = at_least_f32(x)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def norm_specs(kind: str, d: int) -> dict[str, ParamSpec]:
    if kind == "rmsnorm":
        return {"scale": ParamSpec((d,), (None,), init="zeros")}
    return {
        "scale": ParamSpec((d,), (None,), init="ones"),
        "bias": ParamSpec((d,), (None,), init="zeros"),
    }


def apply_norm(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"])
    return layer_norm(x, params["scale"], params["bias"])


# ---------------------------------------------------------------------------
# RoPE (standard + M-RoPE)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta**exponent)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    return _rotate(x, angles[..., None, :])  # broadcast over heads


def mrope_sections(head_dim: int) -> tuple[int, int, int]:
    """Split hd/2 rotary dims into (t, h, w) sections — qwen2-vl uses 16/24/24
    for hd=128; generalize proportionally."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    w = half - t - h
    return t, h, w


def apply_mrope(x: torch.Tensor, positions_thw: torch.Tensor, theta: float) -> torch.Tensor:
    """M-RoPE: positions_thw (..., S, 3) with temporal/height/width ids."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (half,)
    t, h, w = mrope_sections(hd)
    sec = torch.tensor([0] * t + [1] * h + [2] * w, device=x.device)
    pos = positions_thw.float()[..., sec]  # (..., S, half)
    return _rotate(x, (pos * freqs)[..., None, :])


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """Text-only M-RoPE: all three streams share the token index."""
    return torch.stack([positions] * 3, dim=-1)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return torch.tanh(logits / cap) * cap
