"""Core: configuration, presets, device resolution and the precision policy."""

from emox_torch.core.config import (
    AudioConfig,
    AugmentConfig,
    CLIPConfig,
    Config,
    DataConfig,
    DiffusionConfig,
    InferenceConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
    VAEConfig,
    load_config,
    save_config,
)
from emox_torch.core.device import resolve_device
from emox_torch.core.dtypes import Policy, dtype_by_name, policy_from_names
from emox_torch.core.presets import PRESETS, flagship_config, small_config, tiny_config

__all__ = [
    "AudioConfig",
    "AugmentConfig",
    "CLIPConfig",
    "Config",
    "DataConfig",
    "DiffusionConfig",
    "InferenceConfig",
    "MeshConfig",
    "ModelConfig",
    "TrainConfig",
    "VAEConfig",
    "load_config",
    "save_config",
    "resolve_device",
    "Policy",
    "dtype_by_name",
    "policy_from_names",
    "PRESETS",
    "flagship_config",
    "small_config",
    "tiny_config",
]
