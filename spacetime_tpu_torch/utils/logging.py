"""Minimal `[LEVEL] message` stdout logger (counterpart of
`spacetime_tpu/utils/logging.py`, after the reference's logimpl: debug
level, plain prefix format)."""

from __future__ import annotations

import logging
import sys

_FORMAT = "[%(levelname)s] %(message)s"
NAME = "spacetime_tpu_torch"


def initialize(level: int = logging.DEBUG) -> logging.Logger:
    logger = logging.getLogger(NAME)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = False
    return logger


def get() -> logging.Logger:
    return logging.getLogger(NAME)
