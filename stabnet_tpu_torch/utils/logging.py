"""Singleton logger with file:line formatting (reference: utils.py:4-17;
the JAX package's stabnet_tpu/utils/logging.py).

Every module of the port logs through `get_logger()`: INFO and above go to
stderr as `time level file:line] message`, whichever command runs, and do
not propagate to the root logger (so a host application's logging setup
neither doubles nor drops them).
"""

from __future__ import annotations

import logging
import sys

_LOGGER = None


def get_logger() -> logging.Logger:
    """The port's logger, "stabnet_tpu_torch", configured at the first call."""
    global _LOGGER
    if _LOGGER is not None:
        return _LOGGER
    logger = logging.getLogger("stabnet_tpu_torch")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname)s %(filename)s:%(lineno)d] %(message)s"
            )
        )
        logger.addHandler(handler)
    logger.propagate = False
    _LOGGER = logger
    return logger
