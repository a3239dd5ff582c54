"""Utilities of the PyTorch port."""

from pixel_heal_thyself_tpu_torch.utils.run_once import (
    SingletonMeta,
    is_none,
    is_none_or_empty,
    is_truthy,
)

__all__ = ["SingletonMeta", "is_none", "is_none_or_empty", "is_truthy"]
