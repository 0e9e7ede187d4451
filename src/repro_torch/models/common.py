"""Shared model primitives: norms, RoPE variants, initializers, tree
helpers for the parameter/cache trees (nested dicts and lists of tensors),
and the logical-axis sharding rules.

Parameters carry *logical* axis names (``ParamSpec.logical``) as plain
data, as in the reference; :func:`logical_spec` resolves them to mesh axes
through a rules table (``DEFAULT_RULES``: tensor parallelism over
``model``, FSDP over ``data``, the ``pod`` axis pure data parallelism).  A
resolved spec is a tuple with one entry per dim: a mesh-axis name, a tuple
of two or more names, or None (replicated), as jax's ``PartitionSpec``
holds them.  The port runs on the devices that are
present (:mod:`repro_torch.launch.mesh`): on one card every mesh axis has
size 1, so a spec fixes the per-device shapes that
:mod:`repro_torch.launch.sharding` reports and moves no data.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

# ---------------------------------------------------------------------------
# Logical axis rules
# ---------------------------------------------------------------------------

# logical axis name → mesh axis (or None = replicated)
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),  # activation batch
    "seq": None,  # sequence (sharded only under SP rules)
    "embed": "data",  # model width — FSDP shard
    "embed_nofsdp": None,
    "vocab": "model",  # vocab — TP shard
    "heads": "model",  # attention heads — TP shard
    "kv_heads": None,  # kv heads (often < model axis; replicate by default)
    "head_dim": None,
    "ff": "model",  # MLP hidden — TP shard
    "expert": "model",  # MoE experts — EP shard
    "layers": None,  # stacked layer dim
    "lru": "model",  # recurrence width — TP shard
    "cache_batch": ("pod", "data"),
    "cache_seq": None,
    "cache_heads": "model",
}

# Sequence-parallel override used by long-context shapes.
SP_RULES = dict(DEFAULT_RULES, seq="model", cache_seq="model", cache_heads=None)


def mesh_axes(entry):
    """One dim's entry of a spec as jax's ``PartitionSpec`` keeps it: a
    one-name tuple becomes the name."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def logical_spec(axes: tuple[Optional[str], ...], rules: Optional[dict] = None) -> tuple:
    """The mesh axes of each dim named by ``axes`` under ``rules``."""
    rules = rules or DEFAULT_RULES
    return tuple(None if ax is None else mesh_axes(rules.get(ax)) for ax in axes)


# ---------------------------------------------------------------------------
# Activation rules and the current mesh
# ---------------------------------------------------------------------------

_ACTIVATION_RULES: list[Optional[dict]] = [None]
_ACTIVATION_MESH: list[Any] = [None]


class activation_rules:
    """Context manager carrying the sharding rules and the mesh of a step.

    The dry run (:mod:`repro_torch.launch.dryrun`) traces its steps inside
    it, and MoE expert parallelism (:mod:`repro_torch.models.moe`) and
    :func:`repro_torch.optim.compress.compressed_psum` read the mesh from
    here, as in the reference.  Outside it :func:`constrain` is a no-op.
    """

    def __init__(self, rules: dict, mesh: Any = None):
        self.rules = rules
        self.mesh = mesh

    def __enter__(self):
        _ACTIVATION_RULES.append(self.rules)
        _ACTIVATION_MESH.append(self.mesh)
        return self

    def __exit__(self, *exc):
        _ACTIVATION_RULES.pop()
        _ACTIVATION_MESH.pop()
        return False


def current_rules() -> Optional[dict]:
    return _ACTIVATION_RULES[-1]


def current_mesh():
    return _ACTIVATION_MESH[-1]


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """``x`` pinned to the layout ``axes`` name under the current rules.

    On a mesh whose axes all have size 1 (one card) every layout is the
    whole tensor, so ``x`` comes back unchanged; a layout for more devices
    than that raises, since the port holds no tensor across devices."""
    rules = _ACTIVATION_RULES[-1]
    if rules is None:
        return x
    if len(axes) != x.dim():
        raise ValueError(f"{len(axes)} logical axes {axes} for a {x.dim()}-D tensor")
    mesh = _ACTIVATION_MESH[-1]
    if mesh is not None and any(n != 1 for n in mesh.shape.values()):
        raise ValueError(f"mesh {dict(mesh.shape)} spans more than one device")
    return x


#: The dry run's loop folding (:mod:`repro_torch.launch.roofline`): a
#: context-manager factory that weights the ops counted inside it by a trip
#: count, or None outside a counting trace.
_LOOP_FOLD: list[Optional[Callable]] = [None]


def loop_steps(n: int):
    """``range(n)`` for a Python loop whose body keeps its shapes.

    Inside the dry run's counting trace it yields 0 once, with every op of
    the body weighted by ``n``, as the reference's HLO analysis weights a
    while body by its trip count: the caller repeats the one step's
    per-step outputs to ``n``.  A body that reads its index ``t`` sees 0."""
    fold = _LOOP_FOLD[-1]
    if fold is None or n <= 1:
        yield from range(n)
        return
    with fold(n):
        yield 0


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


def tree_logical(tree_specs: Any) -> Any:
    """Map a tree of ParamSpec to its logical axes (for sharding resolution)."""
    return tree_map(lambda s: s.logical, tree_specs, is_leaf=lambda x: isinstance(x, ParamSpec))


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
