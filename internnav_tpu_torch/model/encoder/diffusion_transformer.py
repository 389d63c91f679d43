"""Transformer denoiser of the diffusion policies, and the distance head.

Port of internnav_tpu/model/encoder/diffusion_transformer.py (the
reference's modified diffusion_policy TransformerForDiffusion,
transformer_for_diffusion_modified.py:49-145, and DistanceNetwork,
encoder/distance_encoder.py:4):

- obs-as-cond: a time token (sinusoidal) and the condition tokens
  (`cond_obs_emb`, plus per-token type embeddings when given) with learned
  positions, through `n_cond_layers` pre-norm encoder layers (or the
  two-Linear Mish MLP at 0) into the memory;
- the noisy action tokens (`input_emb` + learned positions) decode over it
  through pre-norm decoder layers: causal self-attention, and the shifted
  memory mask (action step t sees condition token s where t ≥ s − 1, the
  time token being s = 0);
- `cond_mask` (B, 1 + n_obs_steps), 1 = masked out, is the memory's key
  padding mask: classifier-free guidance masks tokens this way.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from internnav_tpu_torch.model.encoder.transformer import (
    SinusoidalPosEmb,
    TransformerDecoderLayer,
    TransformerEncoderLayer,
    causal_mask,
)


class TransformerForDiffusion(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, horizon: int, n_obs_steps: int,
                 cond_dim: int, n_emb: int = 512, n_layer: int = 6, n_cond_layers: int = 0,
                 head_dim: int = 64, causal_attn: bool = True):
        super().__init__()
        n_head = max(1, n_emb // head_dim)
        self.causal_attn = causal_attn
        self.n_cond_layers = n_cond_layers
        self.time_emb = SinusoidalPosEmb(n_emb)
        self.cond_obs_emb = nn.Linear(cond_dim, n_emb)
        self.cond_pos_emb = nn.Parameter(0.02 * torch.randn(1, 1 + n_obs_steps, n_emb))
        if n_cond_layers > 0:
            self.cond_layer = nn.ModuleList(TransformerEncoderLayer(n_emb, n_head, norm_first=True)
                                            for _ in range(n_cond_layers))
        else:
            self.cond_mlp_1 = nn.Linear(n_emb, 4 * n_emb)
            self.cond_mlp_2 = nn.Linear(4 * n_emb, n_emb)
        self.input_emb = nn.Linear(input_dim, n_emb)
        self.pos_emb = nn.Parameter(0.02 * torch.randn(1, horizon, n_emb))
        self.dec_layer = nn.ModuleList(TransformerDecoderLayer(n_emb, n_head)
                                       for _ in range(n_layer))
        self.ln_f = nn.LayerNorm(n_emb, eps=1e-5)
        self.head = nn.Linear(n_emb, output_dim)

    def forward(self, sample: torch.Tensor, timestep, cond: torch.Tensor,
                type_embeds: Optional[torch.Tensor] = None,
                cond_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sample (B, T, input_dim) noisy actions; timestep (B,) or a
        scalar; cond (B, n_obs_steps, cond_dim); type_embeds (B,
        n_obs_steps, n_emb); cond_mask (B, 1 + n_obs_steps)."""
        B, T, _ = sample.shape
        t = torch.as_tensor(timestep, device=sample.device).reshape(-1).expand(B)
        cond_obs = self.cond_obs_emb(cond)
        if type_embeds is not None:
            cond_obs = cond_obs + type_embeds
        tokens = torch.cat([self.time_emb(t)[:, None], cond_obs], dim=1)
        Tc = tokens.shape[1]
        x = tokens + self.cond_pos_emb[:, :Tc]
        if self.n_cond_layers > 0:
            for layer in self.cond_layer:
                x = layer(x)
        else:
            y = self.cond_mlp_1(x)
            x = self.cond_mlp_2(y * torch.tanh(F.softplus(y)))  # Mish
        memory = x

        x = self.input_emb(sample) + self.pos_emb[:, :T]
        tgt_mask = mem_mask = None
        if self.causal_attn:
            tgt_mask = causal_mask(T, sample.device)
            tt = torch.arange(T, device=sample.device)[:, None]
            mem_mask = tt >= (torch.arange(Tc, device=sample.device)[None] - 1)
        kpm = cond_mask.bool() if cond_mask is not None else None
        for layer in self.dec_layer:
            x = layer(x, memory, tgt_mask=tgt_mask, memory_key_padding_mask=kpm,
                      memory_mask=mem_mask)
        return self.head(self.ln_f(x))


class DistanceNetwork(nn.Module):
    """3-layer MLP head (d → d/4 → d/16 → 1), sigmoid when `normalize`:
    the distance, progress and stop-progress heads."""

    def __init__(self, in_dim: int, normalize: bool = True):
        super().__init__()
        self.normalize = normalize
        self.fc1 = nn.Linear(in_dim, in_dim // 4)
        self.fc2 = nn.Linear(in_dim // 4, in_dim // 16)
        self.fc3 = nn.Linear(in_dim // 16, 1)

    def forward(self, x):
        x = self.fc3(F.relu(self.fc2(F.relu(self.fc1(x)))))
        return torch.sigmoid(x) if self.normalize else x
