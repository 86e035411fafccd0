"""Coloured console logger (counterpart of the JAX ``misc/logger.py``)."""

from __future__ import annotations

import logging
import sys

_COLORS = {
    logging.DEBUG: "\x1b[36m",
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
    logging.CRITICAL: "\x1b[41m",
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelno, "")
            return f"{color}{msg}{_RESET}"
        return msg


def get_logger(name: str = "pytorch_points_tpu_torch", level=logging.INFO):
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            _ColorFormatter("%(asctime)s %(levelname).1s %(name)s: %(message)s",
                            datefmt="%H:%M:%S")
        )
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger
