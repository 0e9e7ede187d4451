"""Sharding resolution: logical axes → per-device layouts per (arch, shape).

The port of ``repro.launch.sharding``.  The production policy is the
reference's:

* batch over ``("pod", "data")`` (pure DP on the pod axis),
* TP over ``model`` (heads / ff columns / experts / lru width / vocab),
* FSDP over ``data`` (params and optimizer state),
* decode caches head-sharded when kv_heads divides the model axis, else
  sequence-sharded,
* degenerate batches (long_500k: batch 1) replicate the batch axis.

Shape trees are meta tensors (no storage).  A sharding is a
:class:`Sharding`, a (mesh, spec) record whose spec holds one entry per
dim (a mesh-axis name, a tuple of names, or None); a dim's per-device size
is its size divided by the sizes of the mesh axes it names.  On one card
every axis has size 1 and every per-device shape is the whole shape.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec, input_specs, torch_dtype
from repro_torch.models import kvcache
from repro_torch.models.common import (
    DEFAULT_RULES,
    ParamSpec,
    logical_spec,
    mesh_axes,
    tree_map,
)
from repro_torch.models.transformer import param_specs
from repro_torch.optim.adamw import AdamWState


def mesh_axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.shape else 1


@dataclasses.dataclass(frozen=True)
class Sharding:
    mesh: Any
    spec: tuple

    def shard_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        """The per-device shape of a ``shape`` laid out by this spec."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more dims than shape {tuple(shape)}")
        out = []
        for i, n in enumerate(shape):
            axes = self.spec[i] if i < len(self.spec) else None
            if axes is None:
                out.append(n)
                continue
            axes = (axes,) if isinstance(axes, str) else axes
            ways = math.prod(mesh_axis_size(self.mesh, a) for a in axes)
            if n % ways:
                raise ValueError(f"dim {i} of {tuple(shape)} does not divide over {axes}")
            out.append(n // ways)
        return tuple(out)

    def device_bytes(self, t: torch.Tensor) -> int:
        """Bytes one device holds of ``t`` under this layout."""
        return math.prod(self.shard_shape(tuple(t.shape))) * t.element_size()


def rules_for(cfg: ModelConfig, shape: ShapeSpec, mesh) -> dict[str, Any]:
    """Resolve the logical→mesh rules for one (arch, shape, mesh) cell.

    Each logical axis falls back to replication when its size does not
    divide the mesh axis (e.g. llama3.2's 24 heads on a 16-wide model axis
    → attention params FSDP-only; the MLP keeps TP via d_ff), as in the
    reference, rule for rule.
    """
    rules = dict(DEFAULT_RULES)
    model = mesh_axis_size(mesh, "model")
    data = mesh_axis_size(mesh, "data")

    def div(n: int, m: int) -> bool:
        return n > 0 and n % m == 0

    rules["heads"] = "model" if div(cfg.num_heads, model) else None
    rules["kv_heads"] = None  # replicated by default (GQA kv heads are few)
    rules["ff"] = "model" if div(cfg.d_ff, model) else None
    rules["vocab"] = "model" if div(cfg.vocab_size, model) else None
    rules["embed"] = "data" if div(cfg.d_model, data) else None
    if cfg.moe is not None:
        rules["expert"] = "model" if div(cfg.moe.num_experts, model) else None
    lru = cfg.lru_width or cfg.d_model
    rules["lru"] = "model" if div(lru, model) else None

    batch_axes = ("pod", "data") if "pod" in mesh.shape else ("data",)
    dp = math.prod(mesh_axis_size(mesh, a) for a in batch_axes)
    if shape.global_batch % dp != 0 or shape.global_batch < dp:
        # Degenerate batch (long_500k): replicate batch, keep TP.
        rules["batch"] = None
        rules["cache_batch"] = None
    else:
        rules["batch"] = batch_axes
        rules["cache_batch"] = batch_axes

    if shape.kind in ("decode", "prefill"):  # both produce/carry caches
        cap = min(shape.seq_len, cfg.max_seq_len)
        if div(cfg.num_kv_heads, model):
            rules["cache_heads"], rules["cache_seq"] = "model", None
        elif div(cap, model):
            # Sequence-sharded cache (flash-decode): kv heads replicated.
            rules["cache_heads"], rules["cache_seq"] = None, "model"
        else:
            rules["cache_heads"], rules["cache_seq"] = None, None
        if cfg.local_window and min(cfg.local_window, shape.seq_len) % model != 0:
            # Ring-buffer caches with non-dividing windows stay replicated.
            if rules["cache_heads"] is None:
                rules["cache_seq"] = None
    return rules


# ---------------------------------------------------------------------------
# Spec/shape trees
# ---------------------------------------------------------------------------

_is_spec = lambda x: isinstance(x, ParamSpec)  # noqa: E731


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def param_shapes(cfg: ModelConfig) -> Any:
    dtype = torch_dtype(cfg.dtype)
    return tree_map(lambda s: _meta(s.shape, dtype), param_specs(cfg), is_leaf=_is_spec)


def param_shardings(cfg: ModelConfig, mesh, rules) -> Any:
    return tree_map(
        lambda s: Sharding(mesh, logical_spec(s.logical, rules)), param_specs(cfg),
        is_leaf=_is_spec,
    )


def opt_shapes(cfg: ModelConfig, optimizer=None) -> AdamWState:
    """AdamW's state as meta tensors: an int32 step, f32 moments."""
    ps = param_shapes(cfg)
    f32 = lambda t: _meta(t.shape, torch.float32)  # noqa: E731
    return AdamWState(step=_meta((), torch.int32), m=tree_map(f32, ps), v=tree_map(f32, ps))


def opt_shardings(cfg: ModelConfig, mesh, rules) -> AdamWState:
    psh = param_shardings(cfg, mesh, rules)
    return AdamWState(step=Sharding(mesh, ()), m=psh, v=psh)


def batch_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh, rules) -> dict:
    out = {}
    for name, t in input_specs(cfg, shape).items():
        if t.dim() == 3:  # (B, S, D) embeds
            spec = (rules["batch"], rules["seq"], None)
        elif t.dim() == 2:  # (B, S) tokens/labels
            spec = (rules["batch"], rules["seq"])
        else:  # (B,) positions
            spec = (rules["batch"],)
        out[name] = Sharding(mesh, tuple(mesh_axes(a) for a in spec))
    return out


def cache_shapes(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    enc_len = shape.seq_len if cfg.is_encdec else 0
    return kvcache.cache_specs(cfg, shape.global_batch, shape.seq_len, enc_len=enc_len)


def cache_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh, rules) -> dict:
    return tree_map(
        lambda ax: Sharding(mesh, logical_spec(ax, rules)), kvcache.cache_logical(cfg),
        is_leaf=_is_axes,
    )


def logits_sharding(cfg: ModelConfig, mesh, rules) -> Sharding:
    return Sharding(mesh, tuple(mesh_axes(a) for a in (rules["batch"], None, rules["vocab"])))
