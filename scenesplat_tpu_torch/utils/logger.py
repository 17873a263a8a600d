"""The training logger (the port's copy of ``scenesplat_tpu/utils/logger.py``):
one named logger to the console and, once given, a log file."""

from __future__ import annotations

import logging
import os
from typing import Optional

_FORMAT = "[%(asctime)s %(levelname)s %(filename)s:%(lineno)d] %(message)s"


def get_root_logger(log_file: Optional[str] = None, log_level: int = logging.INFO,
                    name: str = "scenesplat_tpu_torch") -> logging.Logger:
    """The framework logger; the first call that names a ``log_file`` adds
    a file handler for it."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(log_level)
        logger.propagate = False
        stream = logging.StreamHandler()
        stream.setFormatter(logging.Formatter(_FORMAT, datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(stream)
    if log_file is not None and not any(
            isinstance(h, logging.FileHandler) for h in logger.handlers):
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file, mode="a")
        fh.setFormatter(logging.Formatter(_FORMAT, datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(fh)
    return logger
