"""NextDiT trajectory decoder — the InternVLA-N1 System-1 DiT head.

Port of internnav_tpu/model/basemodel/internvla_n1/nextdit.py: 12 layers
of dim 384, RMSNorm with AdaLN-zero gates from a timestep + caption
embedding, self-attention plus tanh-gated cross-attention onto the
projected VLM latents, SwiGLU feed-forward, continuous LayerNorm output.
The linear layers run in `cfg.dtype` (each casts its input once); softmax
and norm statistics run in fp32, and the RMSNorm scales are fp32 with fp32
products, as the JAX package's parameters are, so the residual stream is
fp32 from the first gated sum on, as it is there.

Two departures in structure, none in the function: the SiLU of the
conditioning embedding, which the JAX package takes in every block and
again for the output norm, is taken once per forward and shared (one K8
launch instead of n_layers + 1); and where no gradient is recorded the
feed-forward's gate and up products run as one K8f launch with the SwiGLU
as their epilogue (`activations.swiglu_gemm`, which under grad keeps the
two products and `silu_mul`, which have a backward).
"""

from __future__ import annotations

import dataclasses
import math
import torch
import torch.nn.functional as F
from torch import nn

from internnav_tpu_torch.model.basemodel.internvla_n1.qwen_text import RMSNorm
from internnav_tpu_torch.ops.activations import silu, swiglu_gemm


@dataclasses.dataclass(frozen=True)
class NextDiTConfig:
    dim: int = 384
    n_layers: int = 12
    n_heads: int = 6
    multiple_of: int = 256
    norm_eps: float = 1e-5
    latent_embedding_size: int = 768
    time_freq_dim: int = 256
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def tiny(cls) -> "NextDiTConfig":
        return cls(dim=32, n_layers=2, n_heads=4, multiple_of=16,
                   latent_embedding_size=48, time_freq_dim=16)


def _timestep_freqs(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([ang.cos(), ang.sin()], dim=-1)


class TimeCaptionEmbed(nn.Module):
    """Timestep + pooled-caption conditioning (diffusers
    LuminaCombinedTimestepCaptionEmbedding)."""

    def __init__(self, dim: int, freq_dim: int, dtype):
        super().__init__()
        self.freq_dim = freq_dim
        self.time_fc1 = nn.Linear(freq_dim, dim, dtype=dtype)
        self.time_fc2 = nn.Linear(dim, dim, dtype=dtype)
        self.cap_ln = nn.LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.cap_fc = nn.Linear(dim, dim, dtype=dtype)

    def forward(self, timestep, captions):
        """timestep (B,); captions (B, L, dim), every token valid."""
        dt = self.time_fc1.weight.dtype
        tf = _timestep_freqs(timestep, self.freq_dim).to(dt)
        t = self.time_fc2(silu(self.time_fc1(tf)))
        pooled = captions.float().mean(1)
        return t + self.cap_fc(self.cap_ln(pooled.to(dt)))


class GQAAttention(nn.Module):
    """Lumina attention (as many KV heads as query heads here): no biases,
    layer-norm qk normalization over all heads; returns per-head outputs
    (B, T, H, D)."""

    def __init__(self, dim: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False, dtype=dtype)
        self.to_k = nn.Linear(dim, dim, bias=False, dtype=dtype)
        self.to_v = nn.Linear(dim, dim, bias=False, dtype=dtype)
        self.norm_q = nn.LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.norm_k = nn.LayerNorm(dim, eps=1e-5, dtype=dtype)

    def forward(self, x, kv):
        H = self.heads
        dt = self.to_q.weight.dtype
        x, kv = x.to(dt), kv.to(dt)
        B, T, E = x.shape
        S = kv.shape[1]
        D = E // H
        q = self.norm_q(self.to_q(x)).reshape(B, T, H, D)
        k = self.norm_k(self.to_k(kv)).reshape(B, S, H, D)
        v = self.to_v(kv).reshape(B, S, H, D)
        # batched attention over many short rows: fp32 scores and softmax
        scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / math.sqrt(D)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhts,bshd->bthd", probs.float(), v.float())
        return out.to(x.dtype)


class LuminaFeedForward(nn.Module):
    def __init__(self, dim: int, multiple_of: int, dtype):
        super().__init__()
        inner = int(2 * (4 * dim) / 3)
        inner = multiple_of * ((inner + multiple_of - 1) // multiple_of)
        self.linear_1 = nn.Linear(dim, inner, bias=False, dtype=dtype)
        self.linear_3 = nn.Linear(dim, inner, bias=False, dtype=dtype)
        self.linear_2 = nn.Linear(inner, dim, bias=False, dtype=dtype)

    def forward(self, x):
        w1, w3 = self.linear_1.weight, self.linear_3.weight
        return self.linear_2(swiglu_gemm(x.to(w1.dtype), w1, w3))


class NextDiTBlock(nn.Module):
    def __init__(self, cfg: NextDiTConfig):
        super().__init__()
        c, dt = cfg, cfg.dtype
        self.cfg = cfg
        self.norm1_linear = nn.Linear(c.dim, 4 * c.dim, dtype=dt)
        self.norm1_rms = RMSNorm(c.dim, c.norm_eps)
        self.attn1 = GQAAttention(c.dim, c.n_heads, dt)
        self.norm1_context = RMSNorm(c.dim, c.norm_eps)
        self.attn2 = GQAAttention(c.dim, c.n_heads, dt)
        self.gate = nn.Parameter(torch.zeros(c.n_heads, dtype=dt))
        self.to_out = nn.Linear(c.dim, c.dim, bias=False, dtype=dt)
        self.norm2 = RMSNorm(c.dim, c.norm_eps)
        self.feed_forward = LuminaFeedForward(c.dim, c.multiple_of, dt)
        self.ffn_norm1 = RMSNorm(c.dim, c.norm_eps)
        self.ffn_norm2 = RMSNorm(c.dim, c.norm_eps)

    def forward(self, x, cond, temb_act, num_samples: int = 1):
        """x (B*num_samples, T, dim); cond and temb_act (silu of the
        conditioning embedding, shared by every block) at batch B (sample
        i*num_samples+j conditions on row i)."""
        c = self.cfg
        ns = num_samples
        B, T = temb_act.shape[0], x.shape[1]

        def bc(g):  # (B, dim) → (B*ns, 1, dim)
            return g.repeat_interleave(ns, dim=0)[:, None] if ns > 1 else g[:, None]

        scale_msa, gate_msa, scale_mlp, gate_mlp = self.norm1_linear(temb_act).chunk(4, -1)
        xn = self.norm1_rms(x) * (1 + bc(scale_msa))
        self_out = self.attn1(xn, xn)
        cond_n = self.norm1_context(cond)
        # cross K/V are per condition: fold the samples into the query rows
        xq = xn.reshape(B, ns * T, c.dim) if ns > 1 else xn
        cross_out = self.attn2(xq, cond_n)
        if ns > 1:
            cross_out = cross_out.reshape(B * ns, T, c.n_heads, -1)
        cross_out = cross_out * torch.tanh(self.gate)[None, None, :, None]
        mixed = self.to_out((self_out + cross_out).reshape(x.shape[0], T, c.dim))
        x = x + torch.tanh(bc(gate_msa)) * self.norm2(mixed)
        y = self.feed_forward(self.ffn_norm1(x) * (1 + bc(scale_mlp)))
        return x + torch.tanh(bc(gate_mlp)) * self.ffn_norm2(y)


class NextDiT(nn.Module):
    """x: pre-embedded action features (B*num_samples, T, dim); timestep
    (B,); z_latents (B, L, latent_embedding_size) → (B*num_samples, T, dim).
    num_samples > 1 keeps the conditioning path at batch B."""

    def __init__(self, cfg: NextDiTConfig):
        super().__init__()
        c, dt = cfg, cfg.dtype
        self.cfg = cfg
        self.caption_fc1 = nn.Linear(c.latent_embedding_size, c.dim, dtype=dt)
        self.caption_fc2 = nn.Linear(c.dim, c.dim, dtype=dt)
        self.time_caption_embed = TimeCaptionEmbed(c.dim, c.time_freq_dim, dt)
        self.layers = nn.ModuleList(NextDiTBlock(c) for _ in range(c.n_layers))
        self.norm_out_linear = nn.Linear(c.dim, c.dim, dtype=dt)
        self.norm_out_ln = nn.LayerNorm(c.dim, eps=1e-6, elementwise_affine=False, dtype=dt)
        self.norm_out_linear2 = nn.Linear(c.dim, c.dim, dtype=dt)

    def forward(self, x, timestep, z_latents, num_samples: int = 1):
        dt = self.cfg.dtype
        x = x.to(dt)
        cond = self.caption_fc2(F.gelu(self.caption_fc1(z_latents.to(dt)), approximate="tanh"))
        temb = self.time_caption_embed(timestep, cond).to(dt)
        temb_act = silu(temb)  # every block's AdaLN and the output norm take it
        for layer in self.layers:
            x = layer(x, cond, temb_act, num_samples)
        scale = self.norm_out_linear(temb_act)
        if num_samples > 1:
            scale = scale.repeat_interleave(num_samples, dim=0)
        return self.norm_out_linear2((self.norm_out_ln(x) * (1 + scale[:, None])).to(dt))
