"""Flow-matching Euler scheduler (port of internnav_tpu/ops/schedulers.py
`FlowMatchEulerScheduler`). The denoise loop takes its starting noise as an
argument, and the training noise is passed to `add_noise`, so callers draw
it from a `torch.Generator` and tests inject the same noise into both
packages."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


@dataclass(frozen=True)
class FlowMatchEulerScheduler:
    """Flow matching with discrete Euler steps (diffusers
    FlowMatchEulerDiscreteScheduler semantics)."""

    num_train_timesteps: int = 1000

    # ------------------------------------------------------------ training
    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x_t = (1 - σ)·x0 + σ·ε with σ = t / num_train_timesteps for the
        integer timesteps t (B,)."""
        sigma = (t.float() / self.num_train_timesteps).reshape((-1,) + (1,) * (x0.dim() - 1))
        return (1.0 - sigma) * x0 + sigma * noise

    @staticmethod
    def velocity_target(x0: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """The model's target: ε − x0."""
        return noise - x0

    # ----------------------------------------------------------- inference
    def inference_sigmas(self, num_inference_steps: int) -> np.ndarray:
        """σ grid linspace(1, 1/n, n) with terminal 0 appended."""
        s = np.linspace(1.0, 1.0 / num_inference_steps, num_inference_steps)
        return np.concatenate([s, [0.0]]).astype(np.float32)

    def denoise(self, predict_velocity: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                x_init: torch.Tensor, num_inference_steps: int = 10) -> torch.Tensor:
        """Euler integration x ← x + (σ_next − σ)·v from x_init.
        predict_velocity(x, t) gets t = σ·num_train_timesteps as a 0-d fp32
        tensor on x's device."""
        sig = torch.as_tensor(self.inference_sigmas(num_inference_steps),
                              device=x_init.device)
        x = x_init
        for i in range(num_inference_steps):
            s_cur, s_next = sig[i], sig[i + 1]
            v = predict_velocity(x, s_cur * self.num_train_timesteps)
            x = x + (s_next - s_cur) * v.float()
        return x
