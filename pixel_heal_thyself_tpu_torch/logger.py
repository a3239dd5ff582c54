"""Singleton project logger.

Parity with the reference's `pht/logger.py:10-50`: a singleton wrapping
`logging.getLogger("pht_tpu")`, warning capture, and optional stderr
redirection into the logger. Unlike the reference we do NOT redirect stderr
by default (JAX/XLA emit useful diagnostics there); pass
`redirect_stderr=True` to opt in to the reference behavior.

Copy of the JAX package's `pixel_heal_thyself_tpu/logger.py`, so that the
port imports nothing of that package.
"""

from __future__ import annotations

import logging
import sys
from typing import Any

from pixel_heal_thyself_tpu_torch.utils import SingletonMeta


class _StreamToLogger:
    """File-like object that forwards writes to a logger."""

    def __init__(self, logger: logging.Logger, log_level: str | int = "ERROR") -> None:
        self.logger = logger
        self.log_level = (
            getattr(logging, log_level) if isinstance(log_level, str) else log_level
        )

    def write(self, buf: str) -> None:
        for line in buf.rstrip().splitlines():
            self.logger.log(self.log_level, line.rstrip())

    def flush(self) -> None:
        pass


class Logger(metaclass=SingletonMeta):
    """Singleton logger for the framework."""

    def __init__(self, log_level: str = "INFO") -> None:
        self._logger = logging.getLogger("pht_tpu")
        self._logger.propagate = False  # avoid duplicate lines via root
        if not self._logger.handlers:
            handler = logging.StreamHandler(sys.__stdout__)
            handler.setFormatter(
                logging.Formatter(
                    "[%(asctime)s][%(name)s][%(levelname)s] %(message)s",
                    datefmt="%Y-%m-%d %H:%M:%S",
                ),
            )
            self._logger.addHandler(handler)
        self.setup_logger(log_level)

    def setup_logger(self, log_level: str = "INFO", redirect_stderr: bool = False) -> None:
        """Set the log level; optionally redirect stderr into the logger."""
        log_level = log_level.upper()
        self._logger.setLevel(log_level)
        logging.captureWarnings(True)
        if redirect_stderr:
            sys.stderr = _StreamToLogger(self._logger, log_level)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._logger, name)


logger = Logger()
