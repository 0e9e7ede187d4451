"""Architecture registry: one module per architecture (copies of the
reference package's ``configs``)."""

from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    MoEConfig,
    ShapeSpec,
    all_configs,
    canon,
    get_config,
    shape_applicable,
    torch_dtype,
)

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "MoEConfig",
    "ShapeSpec",
    "all_configs",
    "canon",
    "get_config",
    "shape_applicable",
    "torch_dtype",
]
