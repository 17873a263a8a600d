"""The training logger (the port's copy of ``scenesplat_tpu/utils/logger.py``):
one named logger to the console and, once given, a log file (the last one
named). Under data
parallel a rank other than 0 logs warnings and errors only, to the console."""

from __future__ import annotations

import logging
import os
from typing import Optional

from scenesplat_tpu_torch.parallel.dist import rank

_FORMAT = "[%(asctime)s %(levelname)s %(filename)s:%(lineno)d] %(message)s"


def get_root_logger(log_file: Optional[str] = None, log_level: int = logging.INFO,
                    name: str = "scenesplat_tpu_torch") -> logging.Logger:
    """The framework logger; a call that names a ``log_file`` (on rank 0)
    writes to it from then on, in place of the file an earlier call named
    (each trainer of a process logs into its own ``save_path``)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(log_level)
        logger.propagate = False
        stream = logging.StreamHandler()
        stream.setFormatter(logging.Formatter(_FORMAT, datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(stream)
    if rank() != 0:
        logger.setLevel(max(log_level, logging.WARNING))
        return logger
    if log_file is None:
        return logger
    path = os.path.abspath(log_file)
    for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
        if h.baseFilename == path:
            return logger
        logger.removeHandler(h)
        h.close()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fh = logging.FileHandler(path, mode="a")
    fh.setFormatter(logging.Formatter(_FORMAT, datefmt="%Y-%m-%d %H:%M:%S"))
    logger.addHandler(fh)
    return logger
