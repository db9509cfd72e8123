"""Model configs: the ten architectures' published configs, the SD UNet's,
and the dry-run's input shapes. Counterpart of ``repro.configs``."""

from repro_torch.configs.base import (
    InputShape,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SHAPES,
    UNetConfig,
)
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config, list_archs

__all__ = [
    "ARCHS",
    "InputShape",
    "MLAConfig",
    "MoEConfig",
    "ModelConfig",
    "SHAPES",
    "UNetConfig",
    "get_config",
    "get_smoke_config",
    "list_archs",
]
