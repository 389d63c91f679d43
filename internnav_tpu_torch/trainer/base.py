"""Trainer: the optimizer chain and the single-device training loop.

Port of internnav_tpu/trainer/base.py. `make_optimizer` builds the optax
chain of the JAX package in torch: global-norm clip → Adam (moments updated
in fp32, stored in `il.opt_state_dtype`) → decoupled weight decay under the
decay mask → the learning-rate schedule (warmup-cosine, linear or
constant). optax's step semantics are kept: the schedule is read at the
step count *before* the increment, so with warmup from 0 the first update
is zero.

Differences from the JAX trainer:
- one device: a mesh other than a single data-parallel device raises
  "not yet ported" (FSDP and TP come later), as do grad accumulation and
  the EMA;
- frozen parameters get requires_grad=False: they have no gradient and no
  moments (the JAX package masks them with optax.multi_transform), and the
  reported grad_norm is over the trainable parameters;
- the update runs in fp32 from every storage dtype, in slices of at most
  `SLICE` elements of a tensor, so the fp32 transient of a 545M-entry
  embedding table stays about 1.5 GB; with `opt_state_dtype` None the
  moments are stored in the parameter's dtype, as optax.adamw stores them;
- checkpoints are `torch.save` files, `<output_dir>/<checkpoint_folder>/
  <step>/state.pt` with the parameters and the optimizer state, beside
  that step's `exp_config.json`; the three newest steps are kept.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from internnav_tpu_torch.configs.trainer import ExpCfg, IlCfg
from internnav_tpu_torch.model.basemodel.internvla_n1.qwen_text import RMSNorm
from internnav_tpu_torch.utils.logging import get_logger

#: elements of a tensor updated per fp32 pass of the optimizer
SLICE = 1 << 26
#: Adam's moment decays and epsilon (optax's defaults, which the JAX chain uses)
B1, B2, EPS = 0.9, 0.999, 1e-8
_STATE_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def make_schedule(il: IlCfg, total_steps: int) -> Callable[[int], float]:
    """Learning rate at a step count (optax's warmup_cosine_decay_schedule,
    join of two linear_schedules, or a constant)."""
    lr = il.lr
    warmup = max(int(total_steps * il.warmup_ratio), 1)
    if il.lr_schedule == "cosine":
        decay = max(total_steps, warmup + 1) - warmup

        def sched(count: int) -> float:
            if count < warmup:
                return lr * count / warmup
            done = min(count - warmup, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * done / decay))
    elif il.lr_schedule == "linear":
        decay = max(total_steps - warmup, 1)

        def sched(count: int) -> float:
            if count < warmup:
                return lr * count / warmup
            return lr * (1.0 - min(count - warmup, decay) / decay)
    else:
        def sched(count: int) -> float:
            return lr
    return sched


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Which parameters decay: all but biases and norm scales (the JAX
    mask exempts the leaves named bias / scale; the port's norm modules
    call their scale `weight`)."""
    out = {}
    for mod_name, mod in model.named_modules():
        for name, _ in mod.named_parameters(prefix=mod_name, recurse=False):
            leaf = name.rsplit(".", 1)[-1]
            out[name] = not (leaf == "bias" or isinstance(mod, (RMSNorm, nn.LayerNorm)))
    return out


class ClippedAdamW:
    """clip_by_global_norm → Adam → add_decayed_weights → scale by -lr, on
    the parameters of `model` that require grad (their `.grad` in place)."""

    def __init__(self, model: nn.Module, *, schedule: Callable[[int], float],
                 max_grad_norm: float, weight_decay: float,
                 state_dtype: Optional[torch.dtype] = None):
        decays = decay_mask(model)
        self.params: List[Tuple[str, nn.Parameter]] = [
            (n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.decay = {n: decays[n] for n, _ in self.params}
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.weight_decay = weight_decay
        self.count = 0
        self.mu = {n: torch.zeros_like(p, dtype=state_dtype or p.dtype) for n, p in self.params}
        self.nu = {n: torch.zeros_like(p, dtype=state_dtype or p.dtype) for n, p in self.params}

    def zero_grad(self) -> None:
        for _, p in self.params:
            p.grad = None

    @torch.no_grad()
    def global_norm(self) -> torch.Tensor:
        """fp32 norm over every trainable gradient (missing ones count 0)."""
        sq = None
        for _, p in self.params:
            if p.grad is None:
                continue
            g = p.grad.reshape(-1)
            for a in range(0, g.numel(), SLICE):
                part = torch.linalg.vector_norm(g[a:a + SLICE].float()).square()
                sq = part if sq is None else sq + part
        if sq is None:
            return torch.zeros(())
        return sq.sqrt()

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the current gradients; returns their global norm."""
        gnorm = self.global_norm()
        lr = self.schedule(self.count)  # read before the increment, as optax
        self.count += 1
        c1 = 1.0 - B1 ** self.count
        c2 = 1.0 - B2 ** self.count
        # optax: t if ||g|| < max_norm else t / ||g|| * max_norm
        clip = torch.where(gnorm < self.max_grad_norm, torch.ones_like(gnorm),
                           self.max_grad_norm / gnorm)
        for name, p in self.params:
            pf = p.detach().view(-1)
            mf, vf = self.mu[name].view(-1), self.nu[name].view(-1)
            gf = p.grad.reshape(-1) if p.grad is not None else None
            for a in range(0, pf.numel(), SLICE):
                b = a + SLICE
                if gf is None:  # a trainable parameter the loss did not reach
                    g = torch.zeros_like(pf[a:b], dtype=torch.float32)
                else:
                    g = gf[a:b].float() * clip
                m = mf[a:b].float().mul_(B1).add_(g, alpha=1.0 - B1)
                v = vf[a:b].float().mul_(B2).addcmul_(g, g, value=1.0 - B2)
                upd = (m / c1).div_((v / c2).sqrt_().add_(EPS))
                pa = pf[a:b].float()
                if self.weight_decay and self.decay[name]:
                    upd.add_(pa, alpha=self.weight_decay)
                pf[a:b].copy_(pa.add_(upd, alpha=-lr))
                mf[a:b].copy_(m)
                vf[a:b].copy_(v)
        return gnorm

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        for name in self.mu:
            self.mu[name].copy_(state["mu"][name])
            self.nu[name].copy_(state["nu"][name])


def make_optimizer(cfg: ExpCfg, total_steps: int, model: nn.Module) -> ClippedAdamW:
    """The JAX package's chain for `cfg.il` over model's trainable params."""
    il = cfg.il
    sd = il.opt_state_dtype
    if sd and sd not in _STATE_DTYPES:
        raise ValueError(f"opt_state_dtype {sd!r} not in {sorted(_STATE_DTYPES)}")
    return ClippedAdamW(model, schedule=make_schedule(il, total_steps),
                        max_grad_norm=il.max_grad_norm, weight_decay=il.weight_decay,
                        state_dtype=_STATE_DTYPES[sd] if sd else None)


def _check_single_device(cfg: ExpCfg) -> None:
    mesh = cfg.mesh
    sizes = [s for s in mesh.axes.values() if s not in (1, -1)]
    if mesh.param_sharding != "replicated" or sizes or len(mesh.axes) > 1:
        raise NotImplementedError(
            f"mesh {mesh.axes} with param_sharding={mesh.param_sharding!r}: FSDP / TP "
            "training is not yet ported (one device only)")
    if int(cfg.il.grad_accum_steps) > 1:
        raise NotImplementedError("grad_accum_steps > 1 is not yet ported")
    if cfg.il.use_ema:
        raise NotImplementedError("the parameter EMA is not yet ported")


class Trainer:
    """Single-device trainer. Subclasses provide `set_trainable` and
    `loss_fn`; a batch is whatever their loss takes."""

    def __init__(self, cfg: ExpCfg, policy, dataset: Optional[Iterable] = None,
                 total_steps: Optional[int] = None):
        _check_single_device(cfg)
        self.cfg = cfg
        self.policy = policy
        self.model: nn.Module = policy.model
        self.dataset = dataset
        self.logger = get_logger(cfg.name, cfg.log_dir)
        self.total_steps = total_steps or 1000
        self.set_trainable()
        self.optimizer = make_optimizer(cfg, self.total_steps, self.model)
        self.generator = torch.Generator(device=policy.device).manual_seed(cfg.il.seed)
        self.step = 0

    # ------------------------------------------------------------ loss api
    def set_trainable(self) -> None:
        """Set requires_grad on the model's parameters (all train here)."""

    def loss_fn(self, batch, draws=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    # ---------------------------------------------------------- train step
    def train_step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        """Forward, backward and one optimizer update; metrics stay on the
        device (no synchronisation)."""
        self.optimizer.zero_grad()
        loss, metrics = self.loss_fn(batch, draws)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = self.optimizer.step()
        self.optimizer.zero_grad()
        self.step += 1
        return metrics

    # ------------------------------------------------------------ main loop
    def train(self, resume: bool = True) -> Dict[str, float]:
        if resume:
            self.maybe_restore()
        t0 = time.time()
        start = self.step
        last: Dict[str, float] = {}
        metrics = None
        for batch in self.dataset:
            if self.step >= self.total_steps:
                break
            metrics = self.train_step(batch)
            if self.step % self.cfg.il.log_interval_steps == 0:
                last = {k: float(v) for k, v in metrics.items()}
                rate = (self.step - start) / (time.time() - t0)
                self.logger.info("step %d/%d %s (%.2f it/s)", self.step, self.total_steps,
                                 last, rate)
            if self.step % self.cfg.il.save_interval_steps == 0:
                self.save_checkpoint()
        if metrics is not None:
            last = {k: float(v) for k, v in metrics.items()}
        self.save_checkpoint()
        return last

    # --------------------------------------------------------- checkpoints
    MAX_TO_KEEP = 3

    def _ckpt_dir(self) -> str:
        return os.path.abspath(os.path.join(self.cfg.output_dir, self.cfg.checkpoint_folder))

    def _saved_steps(self) -> List[int]:
        root = self._ckpt_dir()
        if not os.path.isdir(root):
            return []
        return sorted(int(d) for d in os.listdir(root)
                      if d.isdigit() and os.path.exists(os.path.join(root, d, "state.pt")))

    def save_checkpoint(self) -> None:
        """Parameters + optimizer state of this step, and the experiment
        config beside them, so every step directory stands alone."""
        step_dir = os.path.join(self._ckpt_dir(), str(self.step))
        os.makedirs(step_dir, exist_ok=True)
        tmp = os.path.join(step_dir, "state.pt.tmp")
        torch.save({"step": self.step, "params": self.model.state_dict(),
                    "opt_state": self.optimizer.state_dict()}, tmp)
        os.replace(tmp, os.path.join(step_dir, "state.pt"))
        with open(os.path.join(step_dir, "exp_config.json"), "w") as f:
            json.dump(self.cfg.model_dump(), f, indent=2, default=str)
        for old in self._saved_steps()[:-self.MAX_TO_KEEP]:
            shutil.rmtree(os.path.join(self._ckpt_dir(), str(old)))

    def maybe_restore(self) -> bool:
        """Load the newest saved step, if any; returns whether one was."""
        steps = self._saved_steps()
        if not steps:
            return False
        path = os.path.join(self._ckpt_dir(), str(steps[-1]), "state.pt")
        state = torch.load(path, map_location=self.policy.device, weights_only=True)
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
        self.logger.info("resumed from checkpoint step %d", self.step)
        return True
