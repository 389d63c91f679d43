"""Executable-python config loading.

The reference loads eval configs as python files exposing `eval_cfg`
via importlib (scripts/eval/eval.py:25-30). Same mechanism here.

Copy of internnav_tpu/configs/loader.py, kept in the port so that it imports
nothing of the JAX package (held equal to it by tests/test_torch_entry_points.py).
"""

from __future__ import annotations

import importlib.util
import os
from typing import Any


def load_py_config(path: str, attr: str = "eval_cfg") -> Any:
    path = os.path.abspath(path)
    spec = importlib.util.spec_from_file_location("_internnav_tpu_torch_cfg", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, attr):
        raise AttributeError(f"config file {path} does not define {attr!r}")
    return getattr(mod, attr)
