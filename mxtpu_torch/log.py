"""Colored logging helper (counterpart of ``mxtpu/log.py``; ref:
python/mxnet/log.py).

``get_logger`` / ``getLogger`` configure a logger with the reference's
level-labelled format (and ANSI colors on TTYs), so training scripts that
set up logging through mx.log port unchanged.
"""
from __future__ import annotations

import logging
import sys

__all__ = ["get_logger", "getLogger",
           "DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL", "NOTSET"]

DEBUG = logging.DEBUG
INFO = logging.INFO
WARNING = logging.WARNING
ERROR = logging.ERROR
CRITICAL = logging.CRITICAL
NOTSET = logging.NOTSET

_COLORS = {logging.WARNING: "\x1b[0;33m", logging.ERROR: "\x1b[0;31m",
           logging.CRITICAL: "\x1b[0;35m", logging.DEBUG: "\x1b[0;34m"}
_LABELS = {logging.DEBUG: "D", logging.INFO: "I", logging.WARNING: "W",
           logging.ERROR: "E", logging.CRITICAL: "C"}


class _Formatter(logging.Formatter):
    """Level-labelled, optionally colored (ref: log.py:_Formatter)."""

    def __init__(self, colored):
        super().__init__(datefmt="%m%d %H:%M:%S")
        self._colored = colored

    def format(self, record):
        label = _LABELS.get(record.levelno, "U")
        if self._colored and record.levelno in _COLORS:
            head = _COLORS[record.levelno] + label + "\x1b[0m"
        else:
            head = label
        self._style._fmt = head + "%(asctime)s %(process)d %(pathname)s:%(lineno)d] %(message)s"
        return super().format(record)


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """Configured logger (ref: log.py:getLogger semantics: idempotent per
    name; file handler when filename given, else stderr with colors on
    TTYs)."""
    logger = logging.getLogger(name)
    if name is None:
        # reference behavior (log.py:80): never install handlers on or
        # re-level the ROOT logger — that would reformat every third-party
        # library's records and double-print named loggers via propagation
        return logger
    if getattr(logger, "_mxtpu_torch_init", False):
        return logger
    if filename:
        handler = logging.FileHandler(filename, filemode or "a")
        handler.setFormatter(_Formatter(colored=False))
    else:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_Formatter(colored=sys.stderr.isatty()))
    logger.addHandler(handler)
    logger.setLevel(level)
    logger._mxtpu_torch_init = True
    return logger


getLogger = get_logger  # reference spelling
