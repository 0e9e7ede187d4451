"""Model assembly from a config's block pattern: serving and training.

Parameters and caches keep the reference's tree layout: dicts whose
``blocks``/``scan`` entries carry a leading ``cycles`` dim, so the tests
compare like with like.  Inside, a plain Python loop over layers takes the
place of ``lax.scan``; the stacked parameters are unbound once per forward
(so a gradient is stacked once, not scattered into a full-size buffer per
layer).  Where the parameters require grad, each pattern cycle of the
trunk is rematerialized per ``cfg.remat`` (:func:`_maybe_remat`), as the
reference wraps its scanned cycle in ``jax.checkpoint``; remat does not
apply to inference.

Every block kind runs, for inference and training: ATTN (every dense
config: GLM-4, Llama-3.2, Mistral-NeMo, Gemma, the Qwen2-VL backbone with
M-RoPE), ATTN_MOE (DBRX, Moonlight), RGLRU and LOCAL_ATTN
(RecurrentGemma), MLSTM and SLSTM (xLSTM, :mod:`repro_torch.models.xlstm`),
and the encoder-decoder path (Whisper): :meth:`Model.encode` runs the
stacked encoder blocks without a causal mask, and each decoder block's
cross sublayer (:func:`_cross_part`) attends to the encoder's output
through :func:`~repro_torch.models.layers.cross_attention`.  The built
cache of an encoder-decoder model holds ``cross``: the first pattern
entry's cross k/v, stacked over cycles, as in the reference.

A LOCAL_ATTN cache is a ring of w = min(local_window, capacity) slots,
token t in slot t % w, and decodes with ``kv_len = min(pos + 1, w)`` and no
window mask: the ring holds exactly the last w tokens (RoPE is already
applied to k, and softmax does not depend on the keys' order).  The
reference masks the ring by slot index against absolute positions and
slices a wrong-sized ring from prompts shorter than w; the port departs
from it there (ROADMAP queue 3).

Step builders:

* ``make_train_step``  — loss + grads + optimizer update (training shapes)
* ``make_prefill_step`` — forward + cache construction (prefill shapes)
* ``make_serve_step``  — one-token decode against a cache (decode shapes)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import (
    ATTN,
    ATTN_MOE,
    LOCAL_ATTN,
    MLSTM,
    RGLRU,
    SLSTM,
    ModelConfig,
    torch_dtype,
)
from repro_torch.device import resolve_device
from repro_torch.models import kvcache as kv
from repro_torch.models.common import (
    ParamSpec,
    apply_norm,
    init_from_specs,
    norm_specs,
    softcap,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.models.layers import (
    attention,
    attn_specs,
    cross_attention,
    decode_attention,
    mlp_forward,
    mlp_specs,
    position_encode,
    project_heads,
    qkv_project,
)
from repro_torch.models.moe import moe_forward, moe_specs
from repro_torch.models.rglru import rglru_block, rglru_specs
from repro_torch.models.xlstm import mlstm_block, mlstm_specs, slstm_block, slstm_specs


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def _block_specs(cfg: ModelConfig, kind: str, *, with_cross: bool = False) -> dict:
    if kind in (ATTN, LOCAL_ATTN):
        s = {"attn": attn_specs(cfg), "mlp": mlp_specs(cfg)}
    elif kind == ATTN_MOE:
        s = {"attn": attn_specs(cfg), "moe": moe_specs(cfg)}
    elif kind == RGLRU:
        s = {"rglru": rglru_specs(cfg), "mlp": mlp_specs(cfg)}
    elif kind == MLSTM:
        s = {"mlstm": mlstm_specs(cfg)}
    elif kind == SLSTM:
        s = {"slstm": slstm_specs(cfg)}
    else:
        raise ValueError(kind)
    if with_cross:
        s["cross"] = attn_specs(cfg, cross=True)
    return s


def _stack_spec(spec: ParamSpec, n: int) -> ParamSpec:
    return ParamSpec(
        shape=(n, *spec.shape),
        logical=("layers", *spec.logical),
        init=spec.init,
        scale=spec.scale,
    )


def param_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    specs: dict[str, Any] = {
        "embed": ParamSpec((v, d), ("vocab", "embed_nofsdp")),
        "final_norm": norm_specs(cfg.norm_kind, d),
        "blocks": [],
        "rem_blocks": [],
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((d, v), ("embed_nofsdp", "vocab"))
    if cfg.rope_kind == "learned":
        specs["pos_embed"] = ParamSpec((cfg.max_seq_len, d), (None, "embed"))
    stack = lambda blk, n: tree_map(  # noqa: E731
        lambda s: _stack_spec(s, n), blk, is_leaf=lambda x: isinstance(x, ParamSpec)
    )
    for kind in cfg.pattern:
        specs["blocks"].append(stack(_block_specs(cfg, kind, with_cross=cfg.is_encdec),
                                     cfg.cycles))
    for kind in cfg.remainder:
        specs["rem_blocks"].append(_block_specs(cfg, kind, with_cross=cfg.is_encdec))
    if cfg.is_encdec:
        specs["encoder"] = {
            "blocks": stack(_block_specs(cfg, ATTN), cfg.encoder_layers),
            "final_norm": norm_specs(cfg.norm_kind, d),
            "pos_embed": ParamSpec((1 << 16, d), (None, "embed")),
        }
    return specs


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random parameters in ``cfg.dtype``, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_from_specs(param_specs(cfg), gen, torch_dtype(cfg.dtype), dev)


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------


def _norms(p: dict) -> dict:
    return {k[5:]: v for k, v in p.items() if k.startswith("norm_")}


def _attn_part(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int],
    cache: Optional[dict],
    decode_positions: Optional[torch.Tensor],
) -> tuple[torch.Tensor, dict]:
    """Attention sublayer.  Returns (residual-added x, built/updated cache)."""
    h = apply_norm(cfg.norm_kind, _norms(p), x)
    q, k_, v_ = qkv_project(cfg, p, h)
    if cache is None:
        q, k_ = position_encode(cfg, q, k_, positions)
        out = attention(
            q, k_, v_, causal=causal, window=window, max_full_seq=cfg.full_attn_max_seq
        )
        new_cache = {"k": k_, "v": v_}  # full-sequence kv = prefill-built cache
    else:
        pos = decode_positions  # (B,)
        q, k_ = position_encode(cfg, q, k_, pos[:, None])
        ck, cv = kv.update_kv(cache["k"], cache["v"], k_, v_, pos)
        if window is None:
            out = decode_attention(q, ck, cv, pos + 1)
        else:  # the ring holds the last min(pos + 1, w) tokens: no mask needed
            out = decode_attention(q, ck, cv, torch.clamp(pos + 1, max=ck.shape[1]))
        new_cache = {"k": ck, "v": cv}
    wo = p["wo"]
    x = x + out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])
    return x, new_cache


def _cross_part(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    *,
    encoder_out: Optional[torch.Tensor],
    cross_cache: Optional[dict],
) -> tuple[torch.Tensor, dict]:
    """Cross-attention sublayer: the decoder's queries over the encoder's
    k/v, from ``cross_cache`` (decode) or projected from ``encoder_out``
    (sequence mode).  No positions, no mask.  Returns (residual-added x,
    the k/v it attended to)."""
    h = apply_norm(cfg.norm_kind, _norms(p), x)
    q = project_heads(h, p["wq"])
    if cross_cache is not None:
        ck, cv = cross_cache["k"], cross_cache["v"]
    elif encoder_out is not None:
        ck, cv = project_heads(encoder_out, p["wk"]), project_heads(encoder_out, p["wv"])
    else:
        raise ValueError(
            f"{cfg.name}: a cross-attention block needs the encoder's output (sequence mode) "
            "or a cross cache (decode)"
        )
    out = cross_attention(q, ck, cv)
    wo = p["wo"]
    x = x + out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])
    return x, {"k": ck, "v": cv}


def block_forward(
    cfg: ModelConfig,
    kind: str,
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: Optional[dict] = None,
    decode_positions: Optional[torch.Tensor] = None,
    encoder_out: Optional[torch.Tensor] = None,
    cross_cache: Optional[dict] = None,
    causal: bool = True,
) -> tuple[torch.Tensor, dict, torch.Tensor, Optional[dict]]:
    """Returns (x, built/updated cache, aux_loss, built cross cache).

    In sequence mode (cache=None) the returned cache is the *built* decode
    cache (the full-sequence k/v for attention kinds, the final state for
    the recurrent kinds); in decode mode it is the cache, updated in place.
    ``aux_loss`` is the MoE router's z-loss term (0 for the other kinds,
    and in decode).  The cross cache is the k/v a block's cross sublayer
    attended to (None without one).
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cross: Optional[dict] = None
    if kind == MLSTM:
        x, new_cache = mlstm_block(cfg, p["mlstm"], x, cache=cache)
        return x, new_cache, aux, None
    if kind == SLSTM:
        x, new_cache = slstm_block(cfg, p["slstm"], x, cache=cache)
        return x, new_cache, aux, None
    if kind == RGLRU:
        x, new_cache = rglru_block(cfg, p["rglru"], x, cache=cache)
    elif kind in (ATTN, ATTN_MOE, LOCAL_ATTN):
        x, new_cache = _attn_part(
            cfg,
            p["attn"],
            x,
            positions,
            causal=causal,
            window=cfg.local_window if kind == LOCAL_ATTN else None,
            cache=cache,
            decode_positions=decode_positions,
        )
        if "cross" in p:
            x, new_cross = _cross_part(
                cfg, p["cross"], x, encoder_out=encoder_out, cross_cache=cross_cache
            )
    else:
        raise ValueError(kind)
    if kind == ATTN_MOE:
        h = apply_norm(cfg.norm_kind, _norms(p["moe"]), x)
        if cache is None:
            moe_out, stats = moe_forward(cfg, p["moe"], h, return_router_stats=True)
            # Router z-loss-style aux kept tiny, as in the reference.
            aux = aux + 1e-3 * torch.mean(
                torch.square(torch.logsumexp(stats["router_logits"], dim=-1))
            )
        else:  # decode: the aux is dropped, so no stats
            moe_out = moe_forward(cfg, p["moe"], h)
        x = x + moe_out
    else:
        h = apply_norm(cfg.norm_kind, _norms(p["mlp"]), x)
        x = x + mlp_forward(cfg, p["mlp"], h)
    return x, new_cache, aux, new_cross


def _layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return tree_map(lambda a: a[i], tree)


def _unstack(tree: Any, n: int) -> list:
    """The ``n`` layers of a stacked tree, each leaf unbound once (views)."""
    parts = tree_map(lambda a: a.unbind(0), tree, is_leaf=lambda a: isinstance(a, torch.Tensor))
    return [tree_map(lambda u: u[i], parts, is_leaf=lambda u: isinstance(u, tuple))
            for i in range(n)]


# ---------------------------------------------------------------------------
# Whole-model forward
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    # -- embedding ---------------------------------------------------------
    def embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens].to(torch_dtype(self.cfg.dtype))

    def unembed(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
        logits = (x @ w.to(x.dtype)).float()
        return softcap(logits, self.cfg.logits_softcap)

    # -- encoder (whisper) ---------------------------------------------------
    def encode(self, params: dict, encoder_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder stack over frame embeddings (B,T,d): learned
        positions, ``encoder_layers`` ATTN blocks without a causal mask
        (each rematerialized per ``cfg.remat`` where the parameters require
        grad), then the encoder's final norm."""
        cfg = self.cfg
        enc = params["encoder"]
        s = encoder_embeds.shape[1]
        x = encoder_embeds + enc["pos_embed"][:s].to(encoder_embeds.dtype)
        positions = torch.arange(s, device=x.device)[None, :]

        def body(xc, layer_params):
            return block_forward(cfg, ATTN, layer_params, xc, positions, causal=False)[0]

        if _needs_remat(params):
            body = _maybe_remat(cfg, body)
        for layer_params in _unstack(enc["blocks"], cfg.encoder_layers):
            x = body(x, layer_params)
        return apply_norm(cfg.norm_kind, enc["final_norm"], x)

    # -- full-sequence forward (prefill) -------------------------------------
    def _trunk(
        self,
        params: dict,
        tokens: Optional[torch.Tensor],
        inputs_embeds: Optional[torch.Tensor],
        build_cache: bool,
        cache_capacity: Optional[int],
        encoder_embeds: Optional[torch.Tensor] = None,
    ) -> tuple[torch.Tensor, Optional[dict], torch.Tensor]:
        """The final-normed hidden states, the built cache (or None) and the
        summed aux loss."""
        cfg = self.cfg
        if inputs_embeds is not None:
            x = inputs_embeds.to(torch_dtype(cfg.dtype))
        else:
            x = self.embed(params, tokens)
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)[None, :]
        if cfg.rope_kind == "learned":
            x = x + params["pos_embed"][:s].to(x.dtype)
        encoder_out = None
        if cfg.is_encdec:
            if encoder_embeds is None:
                raise ValueError(
                    f"{cfg.name} is an encoder-decoder model: pass encoder_embeds (the "
                    "reference asserts them too)"
                )
            encoder_out = self.encode(params, encoder_embeds)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        built: list[list[dict]] = [[] for _ in cfg.pattern]
        crosses: list[dict] = []

        def cycle(xc, cycle_params):
            aux = torch.zeros((), dtype=torch.float32, device=xc.device)
            for j, kind in enumerate(cfg.pattern):
                xc, layer_cache, a, cross = block_forward(
                    cfg, kind, cycle_params[j], xc, positions, encoder_out=encoder_out,
                    causal=True,
                )
                aux = aux + a
                if build_cache:
                    built[j].append(layer_cache)
                    if j == 0 and cross is not None:
                        crosses.append(cross)
            return xc, aux

        if not build_cache and _needs_remat(params):
            cycle = _maybe_remat(cfg, cycle)
        layers = [_unstack(blk, cfg.cycles) for blk in params["blocks"]]
        for c in range(cfg.cycles):
            x, aux = cycle(x, [per_cycle[c] for per_cycle in layers])
            aux_total = aux_total + aux
        rem_built = []
        for j, kind in enumerate(cfg.remainder):
            x, layer_cache, aux, _ = block_forward(
                cfg, kind, params["rem_blocks"][j], x, positions, encoder_out=encoder_out,
                causal=True,
            )
            aux_total = aux_total + aux
            rem_built.append(layer_cache)
        x = apply_norm(cfg.norm_kind, params["final_norm"], x)
        cache = None
        if build_cache:
            cache = self._cache_from_built(built, rem_built, s, cache_capacity or s)
            if crosses:
                cache["cross"] = {n: torch.stack([e[n] for e in crosses]) for n in ("k", "v")}
        return x, cache, aux_total

    def forward(
        self,
        params: dict,
        *,
        tokens: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        encoder_embeds: Optional[torch.Tensor] = None,
        build_cache: bool = False,
        cache_capacity: Optional[int] = None,
    ) -> tuple[torch.Tensor, Optional[dict], torch.Tensor]:
        """Returns (logits, cache_or_None, aux_loss).

        An encoder-decoder config needs ``encoder_embeds`` (B,T,d), the
        frame embeddings its stub frontend stands for; a decoder-only
        config ignores them, as the reference does.
        """
        x, cache, aux = self._trunk(params, tokens, inputs_embeds, build_cache, cache_capacity,
                                    encoder_embeds)
        return self.unembed(params, x), cache, aux

    def _cache_from_built(
        self, built: list[list[dict]], rem_built: list[dict], s: int, capacity: int
    ) -> dict:
        """Assemble a decode cache from prefill by-products.

        ATTN / ATTN_MOE: the full-sequence k/v *is* the cache, grown to
        ``capacity`` (zero slots past ``s``) so decode at position s does not
        wrap onto slot 0; a capacity at or below ``s`` keeps length ``s``, as
        in the reference.  LOCAL_ATTN: a ring of w = min(local_window,
        capacity) slots holding the last w tokens, token t in slot t % w; a
        prompt shorter than w fills slots 0..s-1 and leaves zeros after them.
        The recurrent kinds (RGLRU, MLSTM, SLSTM): the final state each
        block returned, as it is.
        """
        cfg = self.cfg
        cap = max(capacity, s)
        ring = min(cfg.local_window, capacity)

        def grow(layers: list[torch.Tensor]) -> torch.Tensor:
            first = layers[0]
            out = first.new_zeros((len(layers), first.shape[0], cap, *first.shape[2:]))
            for i, a in enumerate(layers):
                out[i, :, :s] = a
            return out

        def to_ring(layers: list[torch.Tensor]) -> torch.Tensor:
            first = layers[0]
            out = first.new_zeros((len(layers), first.shape[0], ring, *first.shape[2:]))
            keep = torch.arange(max(s - ring, 0), s, device=first.device)
            for i, a in enumerate(layers):
                out[i][:, keep % ring] = a[:, keep]
            return out

        def assemble(kind: str, entries: list[dict]) -> dict:
            if kind in (RGLRU, MLSTM, SLSTM):
                return {n: torch.stack([e[n] for e in entries]) for n in entries[0]}
            fix = to_ring if kind == LOCAL_ATTN else grow
            return {n: fix([e[n] for e in entries]) for n in ("k", "v")}

        return {
            "scan": [assemble(kind, entries) for kind, entries in zip(cfg.pattern, built)],
            "rem": [
                {n: a[0] for n, a in assemble(kind, [entry]).items()}
                for kind, entry in zip(cfg.remainder, rem_built)
            ],
        }

    # -- decode step -----------------------------------------------------------
    def decode_step(
        self,
        params: dict,
        cache: dict,
        tokens: torch.Tensor,
        positions: torch.Tensor,
    ) -> tuple[torch.Tensor, dict]:
        """One-token decode.  tokens (B,1); positions (B,).

        Updates ``cache`` in place (one k/v row, or the recurrent state, per
        sequence and layer) and returns it beside the logits (B,1,V) in f32.
        An encoder-decoder model reads cycle c's cross k/v from
        ``cache["cross"]`` (leaves (cycles, B, T_enc, KV, hd)).
        """
        cfg = self.cfg
        x = self.embed(params, tokens)
        if cfg.rope_kind == "learned":
            x = x + params["pos_embed"][positions][:, None].to(x.dtype)
        cross = cache.get("cross")
        for c in range(cfg.cycles):
            cycle_cross = None if cross is None else _layer(cross, c)
            for j, kind in enumerate(cfg.pattern):
                x, _, _, _ = block_forward(
                    cfg,
                    kind,
                    _layer(params["blocks"][j], c),
                    x,
                    positions[:, None],
                    cache=_layer(cache["scan"][j], c),
                    decode_positions=positions,
                    cross_cache=cycle_cross,
                )
        for j, kind in enumerate(cfg.remainder):
            x, _, _, _ = block_forward(
                cfg,
                kind,
                params["rem_blocks"][j],
                x,
                positions[:, None],
                cache=cache["rem"][j],
                decode_positions=positions,
            )
        x = apply_norm(cfg.norm_kind, params["final_norm"], x)
        return self.unembed(params, x), cache

    # -- loss ---------------------------------------------------------------
    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token NLL of ``batch["labels"]`` under float32
        log-softmax logits, plus the MoE router aux (a 0-d float32)."""
        logits, _, aux = self.forward(
            params,
            tokens=batch.get("tokens"),
            inputs_embeds=batch.get("inputs_embeds"),
            encoder_embeds=batch.get("encoder_embeds"),
        )
        labels = batch["labels"].to(torch.int64)
        nll = F.cross_entropy(logits.flatten(0, -2), labels.flatten(), reduction="mean")
        return nll + aux


#: The matmuls with no batch dims (``x @ w`` folds to ``mm``): what
#: ``remat="dots"`` keeps, as the reference's
#: ``checkpoint_dots_with_no_batch_dims`` does; everything else, the
#: kernels' Functions included, is recomputed in the backward.
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op in _NO_BATCH_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _needs_remat(params: dict) -> bool:
    """Whether a forward is differentiated: grad mode on and a parameter
    requiring grad (remat does not apply to inference)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tree_leaves(params))


def _maybe_remat(cfg: ModelConfig, fn: Callable) -> Callable:
    """``fn`` rematerialized per ``cfg.remat``: ``"none"`` keeps every
    activation, ``"full"`` recomputes the whole cycle in the backward,
    ``"dots"`` keeps the no-batch-dim matmuls' outputs and recomputes the
    rest."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        context = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=context)
    return functools.partial(checkpoint, fn, use_reentrant=False)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


def make_train_step(cfg: ModelConfig, optimizer) -> Callable:
    """(params, opt_state, batch) → (params, opt_state, metrics).

    ``batch`` holds ``tokens`` and ``labels`` as int tensors on the
    parameters' device (and, for an encoder-decoder model,
    ``encoder_embeds``).  The gradients of :meth:`Model.loss` go through
    the kernels' autograd Functions on the card; the optimizer's
    :meth:`~repro_torch.optim.AdamW.apply` then gives ``(p + u).to(p.dtype)``
    leaf by leaf, as the reference's step does, and spends ``opt_state``
    (its moments are updated in place).  ``metrics`` holds the loss and
    the gradients' global norm as 0-d tensors: nothing is read back to the
    host.
    """
    model = Model(cfg)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_() for p in leaves]
        loss = model.loss(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
        del live
        grads = tree_unflatten(params, list(grads))
        params, opt_state = optimizer.apply(grads, opt_state, params)
        gnorm = optimizer.global_norm(grads)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """(params, batch) → (last-position logits (B,1,V), cache).

    Like the reference, it passes no ``cache_capacity``: the cache holds
    exactly S slots, and decoding at position S would wrap onto slot 0; to
    decode after a prefill, call ``Model.forward(build_cache=True,
    cache_capacity=...)``.  Only the last position is unembedded: the
    reference computes every position's logits and returns ``logits[:, -1:]``,
    which are the same values (up to the unembedding matmul's summation
    order).
    """
    model = Model(cfg)

    def prefill_step(params, batch):
        x, cache, _ = model._trunk(
            params, batch.get("tokens"), batch.get("inputs_embeds"), True, None,
            batch.get("encoder_embeds"),
        )
        return model.unembed(params, x[:, -1:]), cache

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    model = Model(cfg)

    def serve_step(params, cache, tokens, positions):
        return model.decode_step(params, cache, tokens, positions)

    return serve_step
