"""Configuration: model/runtime/scheduler dataclasses, input shapes and the
architecture registry."""

from repro_torch.config.model import (
    AttentionKind,
    BlockKind,
    Modality,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)
from repro_torch.config.registry import (
    get_config,
    list_configs,
    register_config,
    smoke_variant,
)
from repro_torch.config.runtime import MeshConfig, RuntimeConfig, ScheduleConfig
from repro_torch.config.shapes import INPUT_SHAPES, InputShape, get_shape

__all__ = [
    "AttentionKind",
    "BlockKind",
    "Modality",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "MeshConfig",
    "RuntimeConfig",
    "ScheduleConfig",
    "InputShape",
    "INPUT_SHAPES",
    "get_shape",
    "get_config",
    "list_configs",
    "register_config",
    "smoke_variant",
]
