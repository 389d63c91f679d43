"""Per-task logger (`get_logger` of internnav_tpu/utils/logging.py, copied so
that the port imports nothing of the JAX package)."""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

_loggers: Dict[str, logging.Logger] = {}


def get_logger(task_name: str = "internnav_tpu", log_dir: Optional[str] = None) -> logging.Logger:
    if task_name in _loggers:
        return _loggers[task_name]
    logger = logging.getLogger(task_name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, f"{task_name}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    _loggers[task_name] = logger
    return logger
