"""Misc helpers: seeding, observation batching, host → device movement.

Copy of internnav_tpu/utils/misc.py (the reference's TensorDict batching,
internnav/agent/utils/common.py:23-48), kept in the port so that it
imports nothing of the JAX package (held equal to it by
tests/test_torch_host_copies.py): a list of per-env observation dicts
becomes one dict of stacked numpy arrays; non-array leaves (strings,
instruction text) are collected into lists. `tree_device_put` moves such
a dict's arrays onto a torch device, where JAX's puts a pytree on a JAX
device.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)


def batch_obs(
    observations: Sequence[Dict[str, Any]],
    dtype_overrides: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Stack a list of per-env observation dicts into arrays along axis 0."""
    if not observations:
        return {}
    keys = observations[0].keys()
    out: Dict[str, Any] = {}
    for k in keys:
        vals = [obs[k] for obs in observations]
        first = vals[0]
        if isinstance(first, (np.ndarray, np.generic, float, int, bool)):
            arr = np.stack([np.asarray(v) for v in vals], axis=0)
            if dtype_overrides and k in dtype_overrides:
                arr = arr.astype(dtype_overrides[k])
            out[k] = arr
        elif isinstance(first, dict):
            out[k] = batch_obs(vals, dtype_overrides)
        else:
            out[k] = list(vals)
    return out


def unbatch_obs(batched: Dict[str, Any], index: int) -> Dict[str, Any]:
    """Inverse of batch_obs for a single env index."""
    out: Dict[str, Any] = {}
    for k, v in batched.items():
        if isinstance(v, dict):
            out[k] = unbatch_obs(v, index)
        elif isinstance(v, (np.ndarray, list)):
            out[k] = v[index]
        else:
            out[k] = v
    return out


def tree_device_put(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """A (nested) dict with its numpy arrays as tensors on `device`; other
    leaves as they are."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = tree_device_put(v, device)
        elif isinstance(v, (np.ndarray, np.generic)):
            out[k] = torch.as_tensor(np.asarray(v)).to(device)
        else:
            out[k] = v
    return out
