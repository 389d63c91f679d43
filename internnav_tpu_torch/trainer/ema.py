"""Exponential moving average of the trainable parameters.

Port of internnav_tpu/trainer/ema.py: diffusion_policy's EMAModel power
decay (`update_after_step`, `inv_gamma`, `power`, `min_value`,
`max_value`) and the update e·d + p·(1 − d) in the EMA's dtype.

Differences from the JAX module: the EMA is a dict of tensors keyed by
parameter name and holds the trainable parameters only. A frozen
parameter never changes, so its EMA equals the parameter by value and no
copy is kept. The update is in place. A parameter sharded as a DTensor
(FSDP2, tensor parallel) has its EMA held as its local shard.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


@torch.no_grad()
def ema_init(params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """A copy of each (name, parameter), its local shard where sharded."""
    return {n: _local(p.detach()).clone() for n, p in params}


def ema_decay(step: int, update_after_step: int = 0, inv_gamma: float = 1.0,
              power: float = 0.75, min_value: float = 0.0, max_value: float = 0.9999) -> float:
    """diffusion_policy EMAModel.get_decay: 1 − (1 + s/γ)^(−p), clipped to
    [min_value, max_value], with s = step − update_after_step − 1; 0 while
    s <= 0."""
    s = max(step - update_after_step - 1, 0)
    if s <= 0:
        return 0.0
    value = 1.0 - (1.0 + s / inv_gamma) ** (-power)
    return min(max(value, min_value), max_value)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Iterable[Tuple[str, torch.Tensor]],
               step: int, **decay_kwargs) -> float:
    """ema[n] ← ema[n]·d + p·(1 − d) in the EMA's dtype, in place, for each
    (n, p) of params; returns the decay d."""
    d = ema_decay(step, **decay_kwargs)
    for n, p in params:
        e = ema[n]
        e.mul_(d).add_(_local(p.detach()).to(e.dtype) * (1.0 - d))
    return d
