"""Model/shape configuration and the architecture registry.

Every architecture provides ``repro_torch/configs/<id>.py`` exposing
``CONFIG`` (the exact published config) and ``SMOKE`` (a reduced same-family
config for CPU smoke tests), copied verbatim from the reference package's
registry.  ``ModelConfig.dtype`` stays a string; :func:`torch_dtype` maps it
to the torch dtype.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch

# ---------------------------------------------------------------------------
# Block kinds assembled by repro_torch.models.transformer
# ---------------------------------------------------------------------------
ATTN = "attn"  # GQA attention + MLP
ATTN_MOE = "attn_moe"  # GQA attention + MoE FFN
RGLRU = "rglru"  # RecurrentGemma RG-LRU block (conv + gated linear recurrence)
LOCAL_ATTN = "local_attn"  # windowed attention + MLP
MLSTM = "mlstm"  # xLSTM matrix-memory block
SLSTM = "slstm"  # xLSTM scalar-memory block

#: float64 is for checks that need rounding out of the way (chip_smoke.py's
#: xLSTM chunk-boundary check); the configs themselves are bf16.
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string (``"bfloat16"`` etc.)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r} (use one of {sorted(_DTYPES)})")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture.  ``pattern`` × ``cycles`` (+ ``remainder``) = layers."""

    name: str
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: tuple[str, ...]  # block kinds in one repeating cycle
    cycles: int  # stacked layer count of each pattern position
    remainder: tuple[str, ...] = ()  # trailing blocks outside the stack
    head_dim: Optional[int] = None  # defaults to d_model // num_heads
    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu
    rope_kind: str = "rope"  # rope | mrope | none | learned
    rope_theta: float = 10_000.0
    moe: Optional[MoEConfig] = None
    local_window: int = 2048  # for LOCAL_ATTN blocks
    lru_width: Optional[int] = None  # RG-LRU recurrence width
    # Encoder–decoder (whisper): encoder layer count; 0 → decoder-only.
    encoder_layers: int = 0
    encoder_is_input_embeds: bool = False  # frontend stub feeds embeddings
    decoder_only_inputs_embeds: bool = False  # VLM stub: embeddings, not ids
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    logits_softcap: float = 0.0
    tie_embeddings: bool = False
    max_seq_len: int = 131_072
    dtype: str = "bfloat16"
    # Training-time policies (kept for parity with the reference's configs).
    remat: str = "full"  # full | none | dots
    scan_layers: bool = True
    full_attn_max_seq: int = 8192  # above this, chunked (flash-style) attention

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.cycles + len(self.remainder)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """True when no block attends to unbounded context (long_500k eligible)."""
        kinds = set(self.pattern) | set(self.remainder)
        return ATTN not in kinds and ATTN_MOE not in kinds

    def param_count(self) -> int:
        """Approximate parameter count."""
        d, hd = self.d_model, self.resolved_head_dim
        qo = d * self.num_heads * hd * 2
        kv = d * self.num_kv_heads * hd * 2
        n_mlp_mats = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        total = 0
        for kind in self.pattern * self.cycles + self.remainder:
            if kind in (ATTN, LOCAL_ATTN):
                total += qo + kv + n_mlp_mats * d * self.d_ff + 2 * d
            elif kind == ATTN_MOE:
                assert self.moe is not None
                total += qo + kv + d * self.moe.num_experts
                total += self.moe.num_experts * n_mlp_mats * d * self.d_ff + 2 * d
            elif kind == RGLRU:
                w = self.lru_width or d
                total += 2 * d * w + w * 4 + w * d + n_mlp_mats * d * self.d_ff + 2 * d
            elif kind == MLSTM:
                total += qo + kv + 2 * d * 2 * d + 3 * d + 2 * d
            elif kind == SLSTM:
                total += 4 * d * d + 4 * d + 2 * d
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.is_encdec:
            total += self.encoder_layers * (
                qo + kv + n_mlp_mats * d * self.d_ff + 2 * d
            )
            # decoder cross-attention
            total += self.num_layers * (qo + kv)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        n_mlp_mats = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        expert_mats = (
            self.num_layers
            * self.moe.num_experts
            * n_mlp_mats
            * self.d_model
            * self.d_ff
        )
        active_mats = (
            self.num_layers * self.moe.top_k * n_mlp_mats * self.d_model * self.d_ff
        )
        return full - expert_mats + active_mats


# ---------------------------------------------------------------------------
# Assigned input shapes (identical for all LM archs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the shape skip rules."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of this (arch, shape),
    the reference's shapes and dtypes.  Nothing is allocated: the dry run
    traces against these."""
    b, s = shape.global_batch, shape.seq_len

    def spec(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.is_encdec:
            # Audio frontend stub: frame embeddings, then decoder tokens.
            out = {
                "encoder_embeds": spec((b, s, cfg.d_model), torch.bfloat16),
                "tokens": spec((b, min(s, 448))),
            }
            if shape.kind == "train":
                out["labels"] = spec((b, min(s, 448)))
            return out
        if cfg.decoder_only_inputs_embeds:
            # VLM stub: patch embeddings folded into the embeds input.
            out = {"inputs_embeds": spec((b, s, cfg.d_model), torch.bfloat16)}
        else:
            out = {"tokens": spec((b, s))}
        if shape.kind == "train":
            out["labels"] = spec((b, s))
        return out
    # decode: one new token against a seq_len-deep cache (the caller builds
    # it with kvcache.cache_specs); here only the step inputs.
    return {"tokens": spec((b, 1)), "positions": spec((b,))}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "glm4_9b",
    "llama3_2_3b",
    "mistral_nemo_12b",
    "gemma_7b",
    "dbrx_132b",
    "moonshot_v1_16b_a3b",
    "recurrentgemma_2b",
    "whisper_small",
    "qwen2_vl_7b",
    "xlstm_1_3b",
)


# CLI ids use dashes; module names use underscores.
def canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canon(arch)}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False) -> dict[str, ModelConfig]:
    return {a: get_config(a, smoke=smoke) for a in ARCH_IDS}
