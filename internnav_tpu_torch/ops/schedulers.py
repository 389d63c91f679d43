"""Diffusion noise schedulers (port of internnav_tpu/ops/schedulers.py
`DDPMScheduler` and `FlowMatchEulerScheduler`). The denoise loops take
their starting noise, and DDPM its per-step ancestral noise, as arguments,
and the training noise is passed to `add_noise`, so callers draw them from
a `torch.Generator` and tests inject the same noise into both packages."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch


def _squaredcos_cap_v2_betas(num_steps: int, max_beta: float = 0.999) -> np.ndarray:
    """Cosine alpha-bar schedule (Nichol & Dhariwal), diffusers-compatible:
    fp64 cosines, the betas cast to float32."""

    def alpha_bar(t):
        return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

    t1 = np.arange(num_steps) / num_steps
    t2 = (np.arange(num_steps) + 1) / num_steps
    return np.minimum(1.0 - alpha_bar(t2) / alpha_bar(t1), max_beta).astype(np.float32)


def _linear_betas(num_steps: int, beta_start=1e-4, beta_end=2e-2) -> np.ndarray:
    return np.linspace(beta_start, beta_end, num_steps, dtype=np.float32)


@dataclass(frozen=True)
class DDPMScheduler:
    """DDPM with epsilon prediction, x0 clamped to ±1 and the fixed_small
    posterior variance, every train timestep a reverse step.
    `alphas_cumprod` is the float32 cumulative product of the float32
    alphas, as numpy gives it; the step's arithmetic runs on the device in
    fp32, in the JAX module's order."""

    num_train_timesteps: int = 10
    beta_schedule: str = "squaredcos_cap_v2"
    betas: np.ndarray = field(default=None, compare=False, repr=False)
    alphas_cumprod: np.ndarray = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.beta_schedule == "squaredcos_cap_v2":
            betas = _squaredcos_cap_v2_betas(self.num_train_timesteps)
        elif self.beta_schedule == "linear":
            betas = _linear_betas(self.num_train_timesteps)
        else:
            raise ValueError(self.beta_schedule)
        object.__setattr__(self, "betas", betas)
        object.__setattr__(self, "alphas_cumprod", np.cumprod(1.0 - betas))

    # ------------------------------------------------------------ training
    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) for the integer timesteps t (B,)."""
        abar = torch.as_tensor(self.alphas_cumprod, device=x0.device)[t]
        shape = (-1,) + (1,) * (x0.dim() - 1)
        return abar.sqrt().reshape(shape) * x0 + (1.0 - abar).sqrt().reshape(shape) * noise

    # ----------------------------------------------------------- inference
    def timesteps(self) -> np.ndarray:
        """The descending timesteps (diffusers `set_timesteps` at n = T):
        19 … 0 at T = 20."""
        return np.arange(self.num_train_timesteps)[::-1].astype(np.int64)

    def step_coefficients(self, t: torch.Tensor):
        """The reverse step's fp32 scalars at the timesteps t (a 1-D int64
        tensor; one entry per step): sqrt(1 - abar_t), sqrt(abar_t), the
        posterior mean's c0 and ct, and sigma, each (len(t),). The JAX
        step's operations in its order, on t's device."""
        prev_t = t - 1
        ac = torch.as_tensor(self.alphas_cumprod, device=t.device)
        abar_t = ac[t]
        one = torch.ones((), dtype=torch.float32, device=t.device)
        abar_prev = torch.where(prev_t >= 0, ac[prev_t.clamp(min=0)], one)
        beta_t = 1.0 - abar_t / abar_prev
        alpha_t = 1.0 - beta_t
        c0 = abar_prev.sqrt() * beta_t / (1.0 - abar_t)
        ct = alpha_t.sqrt() * (1.0 - abar_prev) / (1.0 - abar_t)
        variance = (beta_t * (1.0 - abar_prev) / (1.0 - abar_t)).clamp(min=1e-20)
        sigma = torch.where(t > 0, variance.sqrt(), 0.0 * one)
        return (1.0 - abar_t).sqrt(), abar_t.sqrt(), c0, ct, sigma

    @staticmethod
    def _apply(coef, eps, sample, noise):
        sqrt_1m, sqrt_abar, c0, ct, sigma = coef
        x0 = ((sample - sqrt_1m * eps) / sqrt_abar).clamp(-1.0, 1.0)
        out = c0 * x0 + ct * sample
        return out if noise is None else out + sigma * noise

    def step(self, model_output: torch.Tensor, t: int, sample: torch.Tensor,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One reverse step x_t → x_{t-1} from the predicted ε; `noise` is
        its ancestral noise (none: the deterministic mean, as zeros would
        give)."""
        ts = torch.tensor([int(t)], dtype=torch.long, device=sample.device)
        coef = [c[0] for c in self.step_coefficients(ts)]
        return self._apply(coef, model_output.float(), sample, noise)

    def denoise(self, predict_eps: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                x_init: torch.Tensor, noises: torch.Tensor) -> torch.Tensor:
        """The reverse loop from x_init: predict_eps(x, t) → ε, with t the
        step's timestep as a 0-d int64 tensor on x's device; noises
        ((steps,) + x_init.shape) is each step's ancestral noise, drawn by
        the caller."""
        ts = torch.as_tensor(self.timesteps(), device=x_init.device)
        if noises.shape != (len(ts),) + tuple(x_init.shape):
            raise ValueError(f"noises {tuple(noises.shape)} for {len(ts)} steps of "
                             f"{tuple(x_init.shape)}")
        coefs = self.step_coefficients(ts)
        x = x_init.float()
        for i in range(len(ts)):
            eps = predict_eps(x, ts[i])
            x = self._apply([c[i] for c in coefs], eps.float(), x, noises[i].float())
        return x


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
