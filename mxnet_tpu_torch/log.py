"""Logging utilities (reference python/mxnet/log.py: colored, leveled
logger factory); counterpart of ``mxnet_tpu/log.py``."""
from __future__ import annotations

import logging
import sys

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
NOTSET = logging.NOTSET


class _Formatter(logging.Formatter):
    """Level-colored single-line format (TTY only)."""

    def __init__(self, color=None):
        super().__init__(datefmt="%m%d %H:%M:%S")
        self._color = sys.stderr.isatty() if color is None else color

    def format(self, record):
        base = "%(asctime)s %(levelname).1s %(name)s %(message)s"
        if self._color:
            if record.levelno >= logging.WARNING:
                base = "\x1b[31m" + base + "\x1b[0m"
            elif record.levelno >= logging.INFO:
                base = "\x1b[32m" + base + "\x1b[0m"
        self._style._fmt = base
        return super().format(record)


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """Configured logger (reference log.py getLogger): colored stream
    handler, or a plain file handler when ``filename`` is given."""
    logger = logging.getLogger(name)
    if getattr(logger, "_init_done", False):
        logger.setLevel(level)
        return logger
    logger._init_done = True
    if filename:
        hdlr = logging.FileHandler(filename, filemode or "a")
        hdlr.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s %(message)s",
            datefmt="%m%d %H:%M:%S"))
    else:
        hdlr = logging.StreamHandler()
        hdlr.setFormatter(_Formatter())
    logger.addHandler(hdlr)
    logger.setLevel(level)
    return logger


getLogger = get_logger  # reference spelling
