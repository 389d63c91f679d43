"""CMA / Seq2Seq imitation-learning trainer.

Port of internnav_tpu/trainer/cma_trainer.py (loss parity with the
reference CMATrainer.compute_loss, internnav/trainer/cma_trainer.py:40-113):
per-step cross-entropy over the (T, N) action logits, inflection-weight
normalized per env then averaged over envs, plus the progress monitor's
MSE with the same weighting times `progress_monitor.alpha`. Every batch
starts from zero RNN states (N, 2 or 1, H): its sequences begin at
episode starts. Batches are time-major (T, N, ...): `batch_axis` 1, so
accumulation and dp split the envs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from internnav_tpu_torch.trainer.base import Trainer


def inflection_weighted_ce(logits: torch.Tensor, actions: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """logits (T, N, A), actions (T, N) int, weights (T, N) (0 at padding)
    → the mean over envs of each env's weighted CE over its steps."""
    T, N, A = logits.shape
    ce = F.cross_entropy(logits.reshape(T * N, A).float(), actions.reshape(-1).long(),
                         reduction="none").reshape(T, N)
    per_env = (weights * ce).sum(0) / weights.sum(0).clamp(min=1e-8)
    return per_env.mean()


class CMATrainer(Trainer):
    batch_axis = 1  # batches are time-major (T, N, ...)

    def __init__(self, cfg, policy, **kw):
        super().__init__(cfg, policy, **kw)
        # cuDNN's RNN backward (the instruction LSTM on the card) runs only
        # in train mode; nothing else in these nets depends on the mode
        self.model.train()

    def loss_fn(self, batch, draws=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        obs = batch["observations"]  # each (T, N, ...)
        actions = batch["corrected_actions"]
        weights = batch["weights"].float()
        T, N = actions.shape
        H = self.cfg.model.state_encoder.hidden_size
        layers = 2 if self.cfg.model.policy_name == "CMA_Policy" else 1
        rnn_states = torch.zeros((N, layers, H), device=weights.device)
        logits, _, progress = self.model(obs, rnn_states, batch["prev_actions"], batch["masks"])
        action_loss = inflection_weighted_ce(logits, actions, weights)
        aux_loss = torch.zeros((), device=weights.device)
        pm = self.cfg.model.progress_monitor
        if pm.use and "progress" in obs:
            mse = (progress.reshape(T, N) - obs["progress"].reshape(T, N).float()) ** 2
            aux_loss = ((weights * mse).sum(0) / weights.sum(0).clamp(min=1e-8)).mean() * pm.alpha
        return action_loss + aux_loss, {"action_loss": action_loss, "aux_loss": aux_loss}


class Seq2SeqTrainer(CMATrainer):
    """The same loss; the policy differs (the reference reuses CMATrainer
    for seq2seq through its trainer dispatch)."""
