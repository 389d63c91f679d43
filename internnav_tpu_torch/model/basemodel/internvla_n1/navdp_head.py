"""InternVLA-N1's embedded NavDP System-1 head (port of
internnav_tpu/model/basemodel/internvla_n1/navdp_head.py `NavDPHead`).

The System-2 latents go through `vlm_embed_mlp` (3584 → 896 → 448 → 384
at 7B) and a one-query `TokenCompressor` to a goal token; the async
variant adds the memory tokens of a [memory, current] RGBD pair
(`RGBDBackbone`: two DINOv2 ViT-S towers and a 2-layer former). The
conditioning [time, goal, rgbd] with its learned position embedding feeds
a pre-norm decoder over the `predict_size` waypoints (causal
self-attention, cross-attention to the conditioning), which predicts the
DDPM ε of a 20-step squaredcos_cap_v2 schedule. The sync variant
mean-pools the latents and reads no frames.

Differences from the JAX module:
- the head is fp32 whatever the text model's dtype: the JAX 7B init makes
  fp32 parameters, and flax promotes the bf16 latents to fp32 at the
  first Dense; here they are cast to fp32 first;
- the starting noise `x_init` and the per-step ancestral noise
  `step_noises` are arguments: the callers draw them (the policy and the
  serving cohorts from their torch.Generator; tests inject the JAX draws);
- `point_encoder` and `critic_head` are left out: the JAX init never calls
  them, so flax never creates their parameters; `forward_vlm_traj` (the
  training loss) is not ported yet.

Rows of the batched paths are laid out i·sample_num + j ↔ stream i (the
JAX module's `jnp.repeat` along axis 0, `repeat_interleave` here).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from internnav_tpu_torch.model.encoder.navdp_backbone import (
    FormerDecoder,
    RGBDBackbone,
    TokenCompressor,
)
from internnav_tpu_torch.model.encoder.transformer import SinusoidalPosEmb, causal_mask
from internnav_tpu_torch.ops.schedulers import DDPMScheduler


class NavDPHead(nn.Module):
    def __init__(self, memory_size: int = 2, predict_size: int = 32, temporal_depth: int = 16,
                 heads: int = 8, token_dim: int = 384, vlm_token_dim: int = 3584,
                 image_hw: int = 224):
        super().__init__()
        D = token_dim
        self.predict_size = predict_size
        self.rgbd_encoder = RGBDBackbone(embed_size=D, memory_size=memory_size, token_dim=384,
                                         image_hw=image_hw)
        self.decoder = FormerDecoder(D, heads, temporal_depth, norm_first=True)
        self.input_embed = nn.Linear(3, D)
        self.cond_pos_embed = nn.Parameter(torch.zeros(1, memory_size * 16 + 2, D))
        self.out_pos_embed = nn.Parameter(torch.zeros(1, predict_size, D))
        self.time_emb = SinusoidalPosEmb(D)
        self.final_ln = nn.LayerNorm(D, eps=1e-6)
        self.action_head = nn.Linear(D, 3)
        self.vlm_embed_mlp = nn.ModuleList([
            nn.Linear(vlm_token_dim, vlm_token_dim // 4),
            nn.Linear(vlm_token_dim // 4, vlm_token_dim // 8),
            nn.Linear(vlm_token_dim // 8, D)])
        self.goal_compressor = TokenCompressor(D, 8, 1)
        self.scheduler = DDPMScheduler(num_train_timesteps=20, beta_schedule="squaredcos_cap_v2")
        self._masks: Dict[torch.device, torch.Tensor] = {}

    @property
    def denoise_steps(self) -> int:
        """The reverse loop's steps: the leading size of `step_noises`."""
        return len(self.scheduler.timesteps())

    def _vlm_mlp(self, x):
        x = F.relu(self.vlm_embed_mlp[0](x.float()))
        x = F.relu(self.vlm_embed_mlp[1](x))
        return self.vlm_embed_mlp[2](x)

    def _causal(self, device) -> torch.Tensor:
        mask = self._masks.get(device)
        if mask is None:
            mask = self._masks[device] = causal_mask(self.predict_size, device)
        return mask

    def predict_noise(self, noisy_actions, t, goal_embed, rgbd_embed=None):
        """ε for noisy_actions (B, P, 3) at the timestep t (a 0-d tensor),
        conditioned on goal_embed (B or 1, 1, D) and rgbd_embed (B or 1,
        memory·16, D) or None."""
        B = noisy_actions.shape[0]
        time = self.time_emb(t.reshape(1))[:, None]
        parts = [time.expand(B, -1, -1), goal_embed.expand(B, -1, -1)]
        if rgbd_embed is not None:
            parts.append(rgbd_embed.expand(B, -1, -1))
        cond = torch.cat(parts, dim=1)
        cond = cond + self.cond_pos_embed[:, : cond.shape[1]]
        x = self.input_embed(noisy_actions.float()) + self.out_pos_embed[:, : self.predict_size]
        out = self.decoder(x, cond, tgt_mask=self._causal(x.device))
        return self.action_head(self.final_ln(out))

    # ------------------------------------------------------------ inference
    def predict_pointgoal_action_async(self, vlm_tokens, input_images, input_depths, *, x_init,
                                       step_noises):
        """The async single-stream path: the first stream's latents (1, L,
        D_vlm), frames (1, M, H, W, 3) in [0, 1] and depths (1, M, H, W, 1)
        → (sample_num, P, 3) from x_init (sample_num, P, 3) and step_noises
        (steps, sample_num, P, 3)."""
        return self.predict_pointgoal_action_async_batched(
            vlm_tokens[:1], input_images[:1], input_depths[:1],
            sample_num=x_init.shape[0], x_init=x_init, step_noises=step_noises)

    def predict_pointgoal_action(self, vlm_tokens, *, x_init, step_noises):
        """The sync single-stream path: the first stream's mean-pooled
        latents only (no frames)."""
        return self.predict_pointgoal_action_batched(
            vlm_tokens[:1], sample_num=x_init.shape[0], x_init=x_init, step_noises=step_noises)

    def predict_pointgoal_action_async_batched(self, vlm_tokens, input_images, input_depths, *,
                                               x_init, step_noises, vlm_mask=None,
                                               sample_num: int = 32):
        """B streams through one denoise: vlm_tokens (B, L, D_vlm), frames
        (B, M, H, W, 3) in [0, 1], depths (B, M, H, W, 1), vlm_mask (B, L)
        True = a real token → (B·sample_num, P, 3), row i·sample_num + j
        conditioned on stream i."""
        vlm = self._vlm_mlp(vlm_tokens)
        pad = None if vlm_mask is None else ~vlm_mask.bool()
        goal = self.goal_compressor(vlm, pad)                      # (B, 1, D)
        rgbd = self.rgbd_encoder(input_images, input_depths)       # (B, M·16, D)
        goal_r = goal.repeat_interleave(sample_num, dim=0)
        rgbd_r = rgbd.repeat_interleave(sample_num, dim=0)
        return self.scheduler.denoise(lambda x, t: self.predict_noise(x, t, goal_r, rgbd_r),
                                      x_init, step_noises)

    def predict_pointgoal_action_batched(self, vlm_tokens, *, x_init, step_noises,
                                         sample_num: int = 32):
        """The sync batched path: vlm_tokens (B, L, D_vlm) → (B·sample_num,
        P, 3), the latents mean-pooled as in the JAX module."""
        goal = self._vlm_mlp(vlm_tokens).mean(dim=1, keepdim=True)     # (B, 1, D)
        goal_r = goal.repeat_interleave(sample_num, dim=0)
        return self.scheduler.denoise(lambda x, t: self.predict_noise(x, t, goal_r, None),
                                      x_init, step_noises)
