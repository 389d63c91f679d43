"""RDP trainer: the diffusion ε-MSE and the aux losses.

Port of internnav_tpu/trainer/rdp_trainer.py (reference
internnav/trainer/rdp_trainer.py): the MSE between the predicted and the
drawn noise over the action trajectory (masked by batch["action_mask"]
when given), the progress MSE, the stop-progress MSE × `stop_loss_alpha`
(10) and the distance MSE when the net has the head and the batch the
labels. Batches are single-step (B, ...) with normalized actions. The EMA
of the parameters is on unless `il.use_ema` was set explicitly, as
diffusion_policy's EMAModel is in the reference.

A step's draws (t, ε, the CFG mask rows; `RDPNet.train_draws`) come from
the trainer's generator, or from `draws` (the parity tests pass JAX's).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from internnav_tpu_torch.trainer.base import Trainer


class RDPTrainer(Trainer):
    batch_axis = 0
    stop_loss_alpha: float = 10.0

    def __init__(self, cfg, policy, **kw):
        if "use_ema" not in cfg.il.model_fields_set:
            cfg.il.use_ema = True
        super().__init__(cfg, policy, **kw)

    def loss_fn(self, batch, draws=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        obs = batch["observations"]
        B = obs["actions"].shape[0]
        dev = obs["actions"].device
        H = self.cfg.model.state_encoder.hidden_size
        rnn_states = batch.get("rnn_states")
        if rnn_states is None:
            rnn_states = torch.zeros((B, 1, H), device=dev)
        prev_actions = batch.get("prev_actions")
        if prev_actions is None:
            prev_actions = torch.zeros((B, self.cfg.model.len_traj_act, 3), device=dev)
        masks = batch.get("masks")
        if masks is None:
            masks = torch.ones((B,), device=dev)
        if draws is None:
            draws = self.model.train_draws(B, self.generator, dev)
        eps_pred, noise, _, progress, stop_progress, distance = self.model(
            obs, rnn_states, prev_actions, masks, mode="train", draws=draws)
        mse = (eps_pred - noise) ** 2
        act_mask = batch.get("action_mask")  # (B, T) 1 = supervised
        if act_mask is not None:
            w = act_mask.float()[..., None]
            diffusion_loss = (mse * w).sum() / (w.sum() * mse.shape[-1]).clamp(min=1e-8)
        else:
            diffusion_loss = mse.mean()
        zero = torch.zeros((), device=dev)
        progress_loss = (torch.mean((progress.reshape(B) - batch["progress"].reshape(B)) ** 2)
                         if "progress" in batch else zero)
        stop_loss = (torch.mean((stop_progress.reshape(B) - batch["stop_progress"].reshape(B))
                                ** 2) * self.stop_loss_alpha if "stop_progress" in batch else zero)
        dist_loss = (torch.mean((distance.reshape(B) - batch["distance"].reshape(B)) ** 2)
                     if distance is not None and "distance" in batch else zero)
        loss = diffusion_loss + progress_loss + stop_loss + dist_loss
        return loss, {"diffusion_loss": diffusion_loss, "progress_loss": progress_loss,
                      "stop_loss": stop_loss}
