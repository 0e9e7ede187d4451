"""Mixture-of-Experts FFN with sort-based dispatch, the port of the
reference's ``repro.models.moe``.

Dispatch is the reference's, exactly: per sequence, top-k over float32
router logits and a softmax over the k gates; a stable argsort of the flat
expert ids, each token's position within its expert's bucket by
``searchsorted`` (so earlier tokens win), capacity C = max(⌊S·k/E·cf⌋, 1)
per row with overflow dropped; the expert products (E, C, d) × (E, d, f)
through the ``moe_gemm`` kernel (:mod:`repro_torch.kernels.moe_gemm`); and a
float32 combine by gate-weighted scatter-add.

The reference ``vmap``s the rows.  Here the batch is written out and
folded into the capacity axis, (B, E, C, d) → (E, B·C, d), so one launch of
each product serves all rows and every row's products are unchanged: 3
launches per layer (gate, up, down) for the gated MLP kinds.

Expert parallelism (:func:`_moe_expert_parallel`, the reference's
``shard_map`` over the ``model`` mesh axis) is taken by the reference's
rule, inside :class:`~repro_torch.models.common.activation_rules` whose
rules put experts on ``model``.  The port runs on the devices that are
present: on its 1×1 mesh the one shard holds experts [0, E), the ZeRO
all-gather over ``data`` and the psum over ``model`` are over one shard
each, and both paths run the same body (:func:`_moe_local`), through
``moe_gemm``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.models.common import ParamSpec, current_mesh, current_rules, norm_specs


def moe_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    assert cfg.moe is not None
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    specs: dict[str, ParamSpec] = {
        "router": ParamSpec((d, e), ("embed_nofsdp", None)),
        "w_up": ParamSpec((e, d, f), ("expert", "embed", None)),
        "w_down": ParamSpec((e, f, d), ("expert", None, "embed")),
        **{f"norm_{k}": v for k, v in norm_specs(cfg.norm_kind, d).items()},
    }
    if cfg.mlp_kind in ("swiglu", "geglu"):
        specs["w_gate"] = ParamSpec((e, d, f), ("expert", "embed", None))
    return specs


def _activation(cfg: ModelConfig, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_kind == "swiglu":
        return F.silu(gate) * up
    if cfg.mlp_kind == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    return F.gelu(up, approximate="tanh")


def capacity(cfg: ModelConfig, seq_len: int) -> int:
    """Slots per expert and row: the reference's ⌊S·k/E·cf⌋, at least 1."""
    moe = cfg.moe
    return max(int(seq_len * moe.top_k / moe.num_experts * moe.capacity_factor), 1)


def _row_dispatch(
    cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor, cap: int, lo: int, e_local: int
) -> tuple[torch.Tensor, ...]:
    """Each row's sort-based dispatch to the experts [lo, lo + e_local):
    (tok_slot, gate_slot, used), each (B, e_local·cap), for slot
    (e - lo)·cap + position of expert e's bucket, then the f32 router
    logits (B, S, E) and the chosen experts (B, S, k)."""
    moe = cfg.moe
    b, s, _ = x.shape
    e, k = moe.num_experts, moe.top_k
    dev = x.device

    logits = (x @ router).float()  # (B, S, E)
    gates, chosen = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(gates, dim=-1)

    flat_e = chosen.reshape(b, s * k)
    flat_t = torch.arange(s, device=dev).repeat_interleave(k).expand(b, -1)
    flat_g = gates.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se, st, sg = (a.gather(1, order) for a in (flat_e, flat_t, flat_g))
    # Position within the expert bucket (stable sort ⇒ earlier tokens win).
    pos = torch.arange(s * k, device=dev) - torch.searchsorted(se, se, side="left")

    n_slots = e_local * cap
    # Overflow and other shards' experts write to a last slot past the end,
    # which is cut off.
    local = (se >= lo) & (se < lo + e_local) & (pos < cap)
    slot = torch.where(local, (se - lo) * cap + pos, n_slots)

    def scatter(src: torch.Tensor) -> torch.Tensor:
        buf = torch.zeros((b, n_slots + 1), dtype=src.dtype, device=dev)
        return buf.scatter_(1, slot, src)[:, :n_slots]

    used = torch.ones_like(st, dtype=torch.bool)
    return scatter(st), scatter(sg), scatter(used), logits, chosen


def _moe_local(
    cfg: ModelConfig, p: dict, x: torch.Tensor, *, lo: int = 0, e_local: int | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The experts [lo, lo + e_local) (default all) on this device, whose
    weights ``p`` holds, the rows folded into the capacity axis.  Returns
    (this shard's part of the output, router logits, chosen experts)."""
    b, s, d = x.shape
    e = cfg.moe.num_experts if e_local is None else e_local
    cap = capacity(cfg, s)
    tok_slot, gate_slot, used, logits, chosen = _row_dispatch(cfg, x, p["router"], cap, lo, e)
    rows = torch.arange(b, device=x.device)[:, None]

    xin = x[rows, tok_slot] * used[..., None].to(x.dtype)  # (B, E·C, d)
    # contiguous(): at cap == 1 (decode) the reshape alone can stay a strided view.
    xin = xin.reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d).contiguous()
    up = moe_gemm(xin, p["w_up"])
    if "w_gate" in p:
        h = _activation(cfg, moe_gemm(xin, p["w_gate"]), up)
    else:
        h = _activation(cfg, up, up)
    expert_out = moe_gemm(h, p["w_down"])  # (E, B·C, d)
    expert_out = expert_out.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)

    contrib = expert_out.float() * (gate_slot * used)[..., None]
    out = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, (rows * s + tok_slot).reshape(-1), contrib.reshape(-1, d))
    return out.reshape(b, s, d).to(x.dtype), logits, chosen


def _moe_expert_parallel(cfg: ModelConfig, p: dict, x: torch.Tensor, rules: dict):
    """Expert parallelism over the current mesh's ``model`` axis, the
    reference's layout: x split by ``rules["batch"]``, the router
    replicated, expert weights EP over ``model`` and ZeRO over ``data``;
    each shard all-gathers its experts over ``data``, dispatches every
    token to its e_local = E / ep experts [lo, lo + e_local), and a psum
    over ``model`` combines the shards.  This process holds one device, the
    mesh's one shard: lo = 0, e_local = E, and the all-gather and the psum
    are over one shard.  Returns (out, router logits, chosen experts)."""
    mesh = current_mesh()
    if math.prod(mesh.shape.values()) != 1:
        raise ValueError(
            f"expert parallelism over mesh {dict(mesh.shape)}: the port holds one device"
        )
    e_local = cfg.moe.num_experts // mesh.shape["model"]
    lo = 0  # this shard's index on "model" × e_local
    names = [n for n in ("w_gate", "w_up", "w_down") if n in p]
    local = {**p, **{n: p[n][lo : lo + e_local] for n in names}}
    return _moe_local(cfg, local, x, lo=lo, e_local=e_local)


def moe_forward(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    *,
    return_router_stats: bool = False,
):
    """x: (B, S, d) → (B, S, d) [, router stats for the controller].

    The stats reuse the dispatch's logits and top-k, and count tokens per
    expert with a scatter-add (``bincount`` would wait for the card)."""
    moe = cfg.moe
    assert moe is not None
    rules = current_rules()
    mesh = current_mesh()
    use_ep = (
        rules is not None
        and rules.get("expert") == "model"
        and mesh is not None
        and "model" in mesh.shape
        and moe.num_experts % mesh.shape["model"] == 0
    )
    if use_ep:
        out, logits, chosen = _moe_expert_parallel(cfg, p, x, rules)
    else:
        out, logits, chosen = _moe_local(cfg, p, x)
    if return_router_stats:
        flat = chosen.reshape(-1)
        tokens_per_expert = torch.zeros(moe.num_experts, dtype=torch.int64, device=x.device)
        tokens_per_expert.index_add_(0, flat, torch.ones_like(flat))
        logits = logits.reshape(-1, moe.num_experts)
        return out, {"tokens_per_expert": tokens_per_expert, "router_logits": logits}
    return out


def load_balancing_loss(
    router_logits: torch.Tensor, chosen: torch.Tensor, e: int
) -> torch.Tensor:
    """Switch-style auxiliary loss (density × mean gate probability)."""
    probs = torch.softmax(router_logits, dim=-1)  # (T, E)
    density = F.one_hot(chosen[..., 0], e).to(probs.dtype).mean(dim=0)
    return e * torch.sum(density * probs.mean(dim=0))
