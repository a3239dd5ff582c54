"""Typed configuration system.

Preserves the reference's config surface (`-cn ci/dev/stag/prod`, dotted CLI
overrides, a YAML tree with defaults-lists and `${...}` interpolation — see
reference `config/default.yaml`, `pht/config/base.py`) without depending on
Hydra/OmegaConf, which this image does not ship.

Copy of the JAX package's `pixel_heal_thyself_tpu/config/__init__.py`, so that the
port imports nothing of that package; tests/test_torch_port_host.py
holds the two equal.
"""

from pixel_heal_thyself_tpu_torch.config.loader import compose, register_resolver
from pixel_heal_thyself_tpu_torch.config.schema import (
    AFGSAModelConfig,
    BaseModelConfig,
    Config,
    ConfigRegistry,
    DataConfig,
    DiscriminatorConfig,
    ImagesConfig,
    LoggingConfig,
    LossesConfig,
    MambaModelConfig,
    ParallelConfig,
    PatchesConfig,
    PathConfig,
    SelfAttentionConfig,
    TrainerConfig,
)

__all__ = [
    "AFGSAModelConfig",
    "BaseModelConfig",
    "Config",
    "ConfigRegistry",
    "DataConfig",
    "DiscriminatorConfig",
    "ImagesConfig",
    "LoggingConfig",
    "LossesConfig",
    "MambaModelConfig",
    "ParallelConfig",
    "PatchesConfig",
    "PathConfig",
    "SelfAttentionConfig",
    "TrainerConfig",
    "compose",
    "register_resolver",
]
