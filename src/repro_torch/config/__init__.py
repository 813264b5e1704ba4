"""Configuration: model/scheduler dataclasses + the architecture registry."""

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
from repro_torch.config.runtime import ScheduleConfig

__all__ = [
    "AttentionKind",
    "BlockKind",
    "Modality",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "ScheduleConfig",
    "get_config",
    "list_configs",
    "register_config",
    "smoke_variant",
]
