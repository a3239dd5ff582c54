"""Singleton metaclass and truthiness helpers.

Behavioral parity with the reference's `pht/utils.py:8-151`. Copy of these
helpers from the JAX package's `pixel_heal_thyself_tpu/utils/run_once.py`,
for the port's logger and config layer, so that the port imports nothing of
that package. Its run-once decorators are not copied: nothing in the port
uses them.
"""

from __future__ import annotations

import threading
from typing import Any, ClassVar


def is_truthy(value: Any) -> bool:
    """Truthiness used by config plumbing: bools, 'true/yes/y' strings, ints."""
    if isinstance(value, bool):
        return value
    if isinstance(value, str):
        return value.lower() in ("true", "yes", "y")
    if isinstance(value, int):
        return value != 0
    return False


def is_none(value: Any) -> bool:
    """True when value is None or the string 'none' (any case)."""
    return value is None or str(value).lower() == "none"


def is_none_or_empty(value: Any) -> bool:
    """True when value is None, 'none', or empty string."""
    return is_none(value) or str(value) == ""


class SingletonMeta(type):
    """Metaclass giving each class a single, lazily-created instance."""

    _instances: ClassVar[dict[type, Any]] = {}
    _lock = threading.Lock()

    def __call__(cls, *args: Any, **kwargs: Any) -> Any:
        with cls._lock:
            if cls not in cls._instances:
                cls._instances[cls] = super().__call__(*args, **kwargs)
        return cls._instances[cls]
