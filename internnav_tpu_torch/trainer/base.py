"""Trainer: the optimizer chain and the training loop over a device mesh.

Port of internnav_tpu/trainer/base.py. `make_optimizer` builds the optax
chain of the JAX package in torch: global-norm clip → Adam (moments updated
in fp32, stored in `il.opt_state_dtype`) → decoupled weight decay under the
decay mask → the learning-rate schedule (warmup-cosine, linear or
constant). optax's step semantics are kept: the schedule is read at the
step count *before* the increment, so with warmup from 0 the first update
is zero.

The layout follows `cfg.mesh.param_sharding`, over a `DeviceMesh` of the
process group's ranks (one process a GPU, `torchrun`): "replicated" (each
rank holds every parameter; gradients averaged over dp), "fsdp" (FSDP2,
the JAX placement rule `parallel.mesh.fsdp_param_sharding`) or "tp"
(Megatron tensor parallel on the decoder, `parallel.tp`, and with
`fsdp_rest` FSDP2 for the rest). Without a process group the trainer
runs on its one device, whatever the layout, and the mesh must resolve
to one rank.

One optimizer step takes `il.grad_accum_steps` micro-batches (the JAX
`build_train_step` and `shard_batch`): micro-batch i is rows i·mb …
(i+1)·mb − 1 where the rows divide accum × dp, else the whole batch; a
dp rank then takes its rows of it where they divide dp. `.grad`
accumulates over the backward calls and is divided by accum. A loss is a
sum of terms, each a numerator over a count (`loss_terms`,
`term_counts`): the counts of every micro-batch on every dp rank are
summed before the first backward, so a token mean is the mean over the
whole step's tokens however the rows are split. With `il.use_ema` the
EMA of the trainable parameters (`trainer/ema.py`) follows each
optimizer step.

Differences from the JAX trainer:
- frozen parameters get requires_grad=False: they have no gradient and no
  moments (the JAX package masks them with optax.multi_transform), and the
  reported grad_norm is over the trainable parameters; the EMA keeps no
  copy of them either;
- the update runs in fp32 from every storage dtype, in slices of at most
  `SLICE` elements of a tensor, so the fp32 transient of a 545M-entry
  embedding table stays about 1.5 GB; with `opt_state_dtype` None the
  moments are stored in the parameter's dtype, as optax.adamw stores them;
  on a sharded parameter it updates the local shard;
- checkpoints are `torch.save` files, `<output_dir>/<checkpoint_folder>/
  <step>/state.pt` with the full (gathered) parameters, the optimizer
  state and the EMA, written by rank 0 beside that step's
  `exp_config.json`; the three newest steps are kept. They restore into
  any layout.
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
from internnav_tpu_torch.parallel.collectives import (
    comm_device,
    grad_allreduce,
    initialized,
    is_main_process,
    mesh_group,
)
from internnav_tpu_torch.parallel.fsdp import (
    apply_fsdp,
    full_tensor,
    is_dtensor,
    local,
    local_part,
    shard_groups,
)
from internnav_tpu_torch.parallel.mesh import (
    axis_size,
    fsdp_param_sharding,
    make_mesh,
    mesh_sizes,
    rank_of,
    row_bounds,
    shard_batch,
)
from internnav_tpu_torch.parallel.tp import apply_tp, check_whole_heads, qwen_tp_sharding
from internnav_tpu_torch.trainer.ema import ema_init, ema_update
from internnav_tpu_torch.utils.logging import get_logger
from internnav_tpu_torch.utils.misc import tree_device_put

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
    """Which parameters decay: the JAX mask exempts the leaves named bias,
    b_ih, b_hh, scale, mean and var. Here: biases, a recurrent cell's
    b_ih / b_hh, and every parameter of a norm module (the port's norms
    call their scale `weight`; a frozen BatchNorm's statistics are
    parameters, as in JAX). An `nn.LSTM` / `nn.GRU` holds JAX's flat
    instruction-encoder leaves: its forward direction's biases are JAX's
    b_ih / b_hh, exempt, and the reverse direction's (`*_reverse`
    modules) are JAX's rev_b_ih / rev_b_hh, which decay."""
    from internnav_tpu_torch.model.encoder.resnet import FrozenBatchNorm

    norms = (RMSNorm, nn.LayerNorm, nn.GroupNorm, FrozenBatchNorm)
    out = {}
    for mod_name, mod in model.named_modules():
        for name, _ in mod.named_parameters(prefix=mod_name, recurse=False):
            leaf = name.rsplit(".", 1)[-1]
            rnn_bias = (isinstance(mod, nn.RNNBase) and leaf.startswith("bias_")
                        and not mod_name.endswith("_reverse"))
            out[name] = not (leaf in ("bias", "b_ih", "b_hh") or rnn_bias
                             or isinstance(mod, norms))
    return out


class ClippedAdamW:
    """clip_by_global_norm → Adam → add_decayed_weights → scale by -lr, on
    the parameters of `model` that require grad (their `.grad` in place).
    A sharded parameter (DTensor) is updated on its local shard; the global
    norm sums each shard once over the mesh, so the clip is the same on
    every rank."""

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

        self.mu = {n: torch.zeros_like(local(p), dtype=state_dtype or p.dtype)
                   for n, p in self.params}
        self.nu = {n: torch.zeros_like(local(p), dtype=state_dtype or p.dtype)
                   for n, p in self.params}

    def zero_grad(self) -> None:
        for _, p in self.params:
            p.grad = None

    @torch.no_grad()
    def global_norm(self) -> torch.Tensor:
        """fp32 norm over every trainable gradient (missing ones count 0):
        the squares of each sharded gradient's local part are summed over
        the groups it is split across, a replicated one's counted once."""
        by_groups: Dict[tuple, torch.Tensor] = {}
        for _, p in self.params:
            if p.grad is None:
                continue
            g = local(p.grad).reshape(-1)
            key = shard_groups(p)
            for a in range(0, g.numel(), SLICE):
                part = torch.linalg.vector_norm(g[a:a + SLICE].float()).square()
                by_groups[key] = part if key not in by_groups else by_groups[key] + part
        if not by_groups:
            return torch.zeros(())
        sq = None
        for groups, part in by_groups.items():
            for group in groups:
                torch.distributed.all_reduce(part, group=group)
            sq = part if sq is None else sq + part
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
            pf = local(p.detach()).view(-1)  # the shard FSDP / tensor parallel keep here
            mf, vf = self.mu[name].view(-1), self.nu[name].view(-1)
            gf = local(p.grad).reshape(-1) if p.grad is not None else None
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
        """count, and the moments as local shards."""
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


class _StepModule(nn.Module):
    """The root module under FSDP: one forward computes a micro-batch's
    loss terms (`Trainer.loss_terms`), so FSDP gathers and reduces the
    parameters that no group module holds around it; `encode` runs the
    policy's vision encode as a root forward too (it is registered with
    FSDP), for a frozen tower sharded by the layout."""

    def __init__(self, trainer: "Trainer"):
        super().__init__()
        self.model = trainer.model
        self.trainer = trainer

    def forward(self, batch, draws=None):
        return self.trainer.loss_terms(batch, draws)

    def encode(self, images):
        return self.trainer.policy._encode_images(images)


class Trainer:
    """Mesh-parallel trainer. Subclasses provide `set_trainable` and
    `loss_fn` (a mean loss and its metrics), or for losses that are token
    or sample means over a split batch, `loss_terms` and `term_counts`; a
    batch is a dict of tensors their loss takes."""

    #: the least value of each term's summed count (JAX's max(count, 1))
    TERM_FLOORS: Dict[str, float] = {}

    def __init__(self, cfg: ExpCfg, policy, dataset: Optional[Iterable] = None,
                 total_steps: Optional[int] = None):
        self.cfg = cfg
        self.policy = policy
        self.model: nn.Module = policy.model
        self.dataset = dataset
        self.logger = get_logger(cfg.name, cfg.log_dir)
        self.total_steps = total_steps or 1000
        self.accum = max(int(cfg.il.grad_accum_steps), 1)
        self.set_trainable()
        self._root: Optional[_StepModule] = None
        self._fsdp_params: set = set()
        self.mesh, self.layout = self._layout()
        m = cfg.mesh
        self.dp_axis = m.fsdp_axis
        self.dp = axis_size(self.mesh, self.dp_axis) if self.mesh is not None else 1
        self.dp_rank = rank_of(self.mesh, self.dp_axis)
        self.dp_group = mesh_group(self.mesh, self.dp_axis) if self.dp > 1 else None
        if self.mesh is not None:
            self._apply_layout()
        # the parameters as laid out (FSDP swaps a module's registered
        # parameters for gathered copies around its forward and backward)
        self.params: Dict[str, nn.Parameter] = dict(self.model.named_parameters())
        self.optimizer = make_optimizer(cfg, self.total_steps, self.model)
        self.ema = ema_init(self.optimizer.params) if cfg.il.use_ema else None
        self.generator = torch.Generator(device=policy.device).manual_seed(cfg.il.seed)
        self.step = 0

    # -------------------------------------------------------------- layout
    def _layout(self):
        """(mesh, layout): the mesh over the process group's ranks and the
        layout of `cfg.mesh.param_sharding`, or (None, None) on one device
        without a process group."""
        m = self.cfg.mesh
        kind = m.param_sharding
        if kind not in ("replicated", "fsdp", "tp"):
            raise ValueError(f"param_sharding {kind!r} not in ('replicated', 'fsdp', 'tp')")
        tp_axis = m.tp_axis or "tp"
        if kind == "tp":
            # refuse a split into fractional heads before any mesh is made
            n_tp = int(m.axes.get(tp_axis, 1))
            check_whole_heads(self.model, qwen_tp_sharding(self.model, {tp_axis: n_tp},
                                                           tp_axis=tp_axis), n_tp, tp_axis)
        if not initialized():
            mesh_sizes(m.axes, 1)  # raises unless every axis is one rank
            return None, None
        mesh = make_mesh(m.axes)
        if kind == "fsdp":
            layout = fsdp_param_sharding(self.model, mesh, m.fsdp_axis)
        elif kind == "tp":
            if tp_axis not in (mesh.mesh_dim_names or ()):
                raise ValueError(f"param_sharding='tp' needs a {tp_axis!r} axis in {m.axes}")
            layout = qwen_tp_sharding(self.model, mesh, dp_axis=m.fsdp_axis, tp_axis=tp_axis,
                                      fsdp_rest=m.fsdp_rest)
        else:
            layout = {n: {} for n, _ in self.model.named_parameters()}
        return mesh, layout

    def fsdp_groups(self) -> List[nn.Module]:
        """Modules FSDP gathers on their own, inner ones first (the root
        takes the rest)."""
        return []

    def _apply_layout(self) -> None:
        m = self.cfg.mesh
        tp_axis = m.tp_axis or "tp"
        if m.param_sharding == "tp":
            apply_tp(self.model, self.layout, self.mesh[tp_axis], tp_axis)
        if any(self.dp_axis in d for d in self.layout.values()):
            from torch.distributed.fsdp import register_fsdp_forward_method

            names = {id(p): n for n, p in self.model.named_parameters()}
            self._root = _StepModule(self)
            apply_fsdp(self._root, self.fsdp_groups(), self.layout, names,
                       self.mesh[self.dp_axis], self.dp_axis)
            register_fsdp_forward_method(self._root, "encode")
            self._fsdp_params = {n for n, d in self.layout.items() if self.dp_axis in d}

    # ------------------------------------------------------------ loss api
    def set_trainable(self) -> None:
        """Set requires_grad on the model's parameters (all train here)."""

    def loss_fn(self, batch, draws=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def loss_terms(self, batch, draws=None) -> Tuple[Dict[str, torch.Tensor],
                                                     Dict[str, torch.Tensor]]:
        """(terms, metrics) of one micro-batch on this rank: each term's
        numerator (the step's loss is the sum over terms of the numerators
        summed over micro-batches and ranks, over the counts summed so),
        and metrics already means. Here: `loss_fn`'s mean loss as one term
        counted once."""
        loss, metrics = self.loss_fn(batch, draws)
        return {"loss": loss}, {k: v for k, v in metrics.items() if k != "loss"}

    def term_counts(self, batch) -> Dict[str, torch.Tensor]:
        """Each term's count in one micro-batch on this rank (known before
        its forward)."""
        return {"loss": torch.ones((), device=self.policy.device)}

    #: the axis of a batch leaf that holds its rows: 0 for (B, ...)
    #: batches, 1 for the time-major (T, N, ...) batches of the recurrent
    #: trainers (JAX's `Trainer.batch_axis`)
    batch_axis: int = 0

    def micro_batches(self, batch) -> List[Any]:
        """This rank's part of each of the step's accum micro-batches, by
        the JAX rule for each leaf, nested dicts included: micro-batch i is
        rows i·mb … (i+1)·mb − 1 along `batch_axis` of a leaf whose rows
        accum × dp divide, else the whole leaf; a dp rank then takes its
        rows where dp divides them. numpy leaves become tensors on the
        policy's device first."""
        accum, dp, ax = self.accum, self.dp, self.batch_axis
        batch = tree_device_put(batch, self.policy.device)

        def micro(x, i):
            if isinstance(x, dict):
                return {k: micro(v, i) for k, v in x.items()}
            if torch.is_tensor(x) and x.dim() > ax and x.shape[ax] % (accum * dp) == 0:
                a, b = row_bounds(x.shape[ax], accum, i)
                return x[(slice(None),) * ax + (slice(a, b),)]
            return x

        return [shard_batch(micro(batch, i), self.mesh, self.dp_axis, ax) for i in range(accum)]

    # ---------------------------------------------------------- train step
    def _dp_sum(self, x: torch.Tensor) -> torch.Tensor:
        if self.dp_group is not None:
            x = x.to(comm_device())
            torch.distributed.all_reduce(x, group=self.dp_group)
        return x

    def train_step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        """Forward and backward of each micro-batch, then one optimizer
        update (and the EMA's). draws: None, or each micro-batch's
        System-1 draws in a list (one (t, noise) pair alone at accum 1).
        Metrics stay on the device."""
        if draws is not None and not isinstance(draws, list):
            draws = [draws]
        if draws is not None and len(draws) != self.accum:
            raise ValueError(f"{len(draws)} sets of draws for {self.accum} micro-batches")
        pieces = self.micro_batches(batch)
        counts = [self.term_counts(p) for p in pieces]
        names = list(counts[0])
        totals = self._dp_sum(torch.stack([sum(c[n] for c in counts).float().reshape(())
                                           for n in names]))
        scale = {n: self.accum * self.dp / totals[j].clamp(min=self.TERM_FLOORS.get(n, 1.0))
                 for j, n in enumerate(names)}
        forward = self._root if self._root is not None else self.loss_terms
        self.optimizer.zero_grad()
        sums: Dict[str, torch.Tensor] = {}
        for i, piece in enumerate(pieces):
            terms, extra = forward(piece, None if draws is None else draws[i])
            scaled = {n: terms[n] * scale[n].to(terms[n].device) for n in names}
            sum(scaled.values()).backward()
            for k, v in {**scaled, **extra}.items():
                sums[k] = v.detach() + sums[k] if k in sums else v.detach()
        if "loss" not in sums:
            sums["loss"] = sum(sums[n] for n in names)
        keys = list(sums)
        means = self._dp_sum(torch.stack([sums[k].float().reshape(()) for k in keys]))
        means = means / (self.accum * self.dp)
        metrics = {k: means[j] for j, k in enumerate(keys)}
        self._reduce_grads()
        metrics["grad_norm"] = self.optimizer.step()
        self.optimizer.zero_grad()
        self.step += 1
        if self.ema is not None:
            ema_update(self.ema, self.optimizer.params, self.step)
        return metrics

    @torch.no_grad()
    def _reduce_grads(self) -> None:
        """The accumulated gradients over accum, and averaged over dp where
        FSDP has not (the parameters it does not hold)."""
        for _, p in self.optimizer.params:
            # DTensor may return a gradient in other placements than its
            # parameter's (the vocab-split embedding's comes back whole)
            if p.grad is not None and is_dtensor(p) and p.grad.placements != p.placements:
                p.grad = p.grad.redistribute(p.device_mesh, p.placements)
        grads = [p.grad for _, p in self.optimizer.params if p.grad is not None]
        if self.accum > 1:
            for g in grads:
                local(g).div_(self.accum)
        if self.dp_group is not None:
            grad_allreduce([p.grad for n, p in self.optimizer.params
                            if n not in self._fsdp_params], self.mesh, self.dp_axis)

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

    def full_state(self) -> Dict[str, Any]:
        """The checkpoint's contents, every tensor full and on the host:
        collective under a layout (every rank calls it; rank 0 writes)."""
        params = self.params
        state = {n: full_tensor(p, p) for n, p in params.items()}
        state.update({n: b.detach().cpu() for n, b in self.model.named_buffers()})
        opt = self.optimizer
        out = {"step": self.step, "params": state,
               "opt_state": {"count": opt.count,
                             "mu": {n: full_tensor(t, params[n]) for n, t in opt.mu.items()},
                             "nu": {n: full_tensor(t, params[n]) for n, t in opt.nu.items()}}}
        if self.ema is not None:
            out["ema"] = {n: full_tensor(t, params[n]) for n, t in self.ema.items()}
        return out

    def save_checkpoint(self) -> None:
        """Parameters, optimizer state and EMA of this step (gathered to
        full tensors), and the experiment config beside them, so every step
        directory stands alone; written by rank 0."""
        state = self.full_state()
        if is_main_process():
            step_dir = os.path.join(self._ckpt_dir(), str(self.step))
            os.makedirs(step_dir, exist_ok=True)
            tmp = os.path.join(step_dir, "state.pt.tmp")
            torch.save(state, tmp)
            os.replace(tmp, os.path.join(step_dir, "state.pt"))
            with open(os.path.join(step_dir, "exp_config.json"), "w") as f:
                json.dump(self.cfg.model_dump(), f, indent=2, default=str)
            for old in self._saved_steps()[:-self.MAX_TO_KEEP]:
                shutil.rmtree(os.path.join(self._ckpt_dir(), str(old)))
        if initialized():
            torch.distributed.barrier()

    @torch.no_grad()
    def load_state(self, state: Dict[str, Any]) -> None:
        """Load a checkpoint's contents (`full_state`'s) into this trainer's
        layout: each rank copies its part of every full tensor. Without an
        "ema" entry the EMA is seeded from the parameters, as JAX does for
        a checkpoint written before the EMA was on."""
        params = self.params
        for n, p in params.items():
            local(p).copy_(local_part(state["params"][n], p))
        for n, b in self.model.named_buffers():
            b.copy_(state["params"][n])
        opt = self.optimizer
        opt.count = int(state["opt_state"]["count"])
        for key, table in (("mu", opt.mu), ("nu", opt.nu)):
            for n, t in table.items():
                t.copy_(local_part(state["opt_state"][key][n], params[n]))
        if self.ema is not None:
            if "ema" in state:
                for n, t in self.ema.items():
                    t.copy_(local_part(state["ema"][n], params[n]))
            else:
                self.ema = ema_init(self.optimizer.params)
        self.step = int(state["step"])

    def maybe_restore(self) -> bool:
        """Load the newest saved step, if any; returns whether one was."""
        steps = self._saved_steps()
        if not steps:
            return False
        path = os.path.join(self._ckpt_dir(), str(steps[-1]), "state.pt")
        self.load_state(torch.load(path, map_location="cpu", weights_only=True))
        self.logger.info("resumed from checkpoint step %d", self.step)
        return True
