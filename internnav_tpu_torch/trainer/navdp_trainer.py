"""NavDP trainer.

Port of internnav_tpu/trainer/navdp_trainer.py (reference
internnav/trainer/navdp_trainer.py:26-123 compute_loss):
loss = 0.8 · (½ ng + ½ mg diffusion MSE)
     + 0.2 · (critic label MSE + critic augment MSE)
     + 0.5 · (½ image-goal aux + ½ pixel-goal aux MSE against the point goal),
with the four terms as metrics. The EMA of the parameters is on unless
`il.use_ema` was set explicitly, as diffusion_policy's EMAModel is in the
reference. A step's draws (`NavDPNet.train_draws`) come from the
trainer's generator, or from `draws` (the parity tests pass JAX's).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from internnav_tpu_torch.trainer.base import Trainer


class NavDPTrainer(Trainer):
    batch_axis = 0

    def __init__(self, cfg, policy, **kw):
        if "use_ema" not in cfg.il.model_fields_set:
            cfg.il.use_ema = True
        super().__init__(cfg, policy, **kw)

    def loss_fn(self, batch, draws=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        o = batch["observations"]
        if draws is None:
            draws = self.model.train_draws(o["output_actions"].shape[0], self.generator,
                                           o["output_actions"].device)
        (eps_ng, eps_mg, critic_label, critic_augment, ng_noise, mg_noise, image_aux,
         pixel_aux) = self.model(o["goal_point"], o["goal_image"], o["goal_pixel"],
                                 o["input_images"], o["input_depths"], o["output_actions"],
                                 o["augment_actions"], draws)
        ng_loss = torch.mean((eps_ng - ng_noise) ** 2)
        mg_loss = torch.mean((eps_mg - mg_noise) ** 2)
        action_loss = 0.5 * ng_loss + 0.5 * mg_loss
        critic_loss = (torch.mean((critic_label - batch["label_critic"]) ** 2)
                       + torch.mean((critic_augment - batch["augment_critic"]) ** 2))
        aux_loss = (0.5 * torch.mean((o["goal_point"] - image_aux) ** 2)
                    + 0.5 * torch.mean((o["goal_point"] - pixel_aux) ** 2))
        loss = 0.8 * action_loss + 0.2 * critic_loss + 0.5 * aux_loss
        return loss, {"ng_action_loss": ng_loss, "mg_action_loss": mg_loss,
                      "critic_loss": critic_loss, "aux_loss": aux_loss}
