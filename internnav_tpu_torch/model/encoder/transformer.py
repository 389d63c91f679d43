"""Transformer building blocks (port of internnav_tpu/model/encoder/
transformer.py: `MultiHeadAttention`, `TransformerEncoderLayer`,
`TransformerDecoderLayer`, `SinusoidalPosEmb`, `causal_mask`)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class MultiHeadAttention(nn.Module):
    """torch nn.MultiheadAttention-style: q/k/v/out projections with bias.

    key_padding_mask (B, S): True = masked OUT (torch convention);
    attn_mask (T, S) boolean: True = keep."""

    def __init__(self, embed_dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim, dtype=dtype)
        self.k_proj = nn.Linear(embed_dim, embed_dim, dtype=dtype)
        self.v_proj = nn.Linear(embed_dim, embed_dim, dtype=dtype)
        self.out_proj = nn.Linear(embed_dim, embed_dim, dtype=dtype)

    def forward(self, query, key, value, key_padding_mask=None, attn_mask=None):
        B, T, _ = query.shape
        S = key.shape[1]
        H = self.num_heads
        D = self.embed_dim // H
        q = self.q_proj(query).reshape(B, T, H, D).transpose(1, 2)
        k = self.k_proj(key).reshape(B, S, H, D).transpose(1, 2)
        v = self.v_proj(value).reshape(B, S, H, D).transpose(1, 2)
        scores = torch.einsum("bhtd,bhsd->bhts", q, k) / math.sqrt(D)
        if attn_mask is not None:
            scores = scores.masked_fill(~attn_mask[None, None], -1e9)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :], -1e9)
        probs = torch.softmax(scores, dim=-1)
        if attn_mask is not None:
            # rows with every key masked give 0, as torch SDPA does
            probs = probs.masked_fill(~attn_mask.any(-1)[None, None, :, None], 0.0)
        out = torch.einsum("bhts,bhsd->bhtd", probs, v)
        out = out.transpose(1, 2).reshape(B, T, self.embed_dim)
        return self.out_proj(out)


_ACTIVATIONS = {
    "gelu": lambda y: F.gelu(y),  # exact erf form (flax approximate=False)
    "relu": F.relu,
    "mish": lambda y: y * torch.tanh(F.softplus(y)),
}


class TransformerEncoderLayer(nn.Module):
    """Pre- or post-norm encoder layer (torch TransformerEncoderLayer)."""

    def __init__(self, d_model: int, n_head: int, dim_feedforward: Optional[int] = None,
                 norm_first: bool = True, activation: str = "gelu", dtype=torch.float32):
        super().__init__()
        ff = dim_feedforward or 4 * d_model
        self.norm_first = norm_first
        self.act = _ACTIVATIONS[activation]
        self.self_attn = MultiHeadAttention(d_model, n_head, dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, dtype=dtype)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, dtype=dtype)
        self.linear1 = nn.Linear(d_model, ff, dtype=dtype)
        self.linear2 = nn.Linear(ff, d_model, dtype=dtype)

    def forward(self, x, key_padding_mask=None, attn_mask=None):
        if self.norm_first:
            xn = self.norm1(x)
            x = x + self.self_attn(xn, xn, xn, key_padding_mask, attn_mask)
            return x + self.linear2(self.act(self.linear1(self.norm2(x))))
        x = self.norm1(x + self.self_attn(x, x, x, key_padding_mask, attn_mask))
        return self.norm2(x + self.linear2(self.act(self.linear1(x))))


class TransformerDecoderLayer(nn.Module):
    """Pre-norm decoder layer (torch TransformerDecoderLayer, norm_first):
    LayerNorm eps 1e-5, exact-erf GELU, FF 4 x d_model."""

    def __init__(self, d_model: int, n_head: int, dim_feedforward: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        ff = dim_feedforward or 4 * d_model
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, dtype=dtype)
        self.self_attn = MultiHeadAttention(d_model, n_head, dtype)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, dtype=dtype)
        self.cross_attn = MultiHeadAttention(d_model, n_head, dtype)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5, dtype=dtype)
        self.linear1 = nn.Linear(d_model, ff, dtype=dtype)
        self.linear2 = nn.Linear(ff, d_model, dtype=dtype)

    def forward(self, tgt, memory, tgt_mask=None, memory_key_padding_mask=None,
                memory_mask=None):
        tn = self.norm1(tgt)
        x = tgt + self.self_attn(tn, tn, tn, None, tgt_mask)
        mn = self.norm2(x)
        x = x + self.cross_attn(mn, memory, memory, memory_key_padding_mask, memory_mask)
        return x + self.linear2(F.gelu(self.linear1(self.norm3(x))))


class SinusoidalPosEmb(nn.Module):
    """Diffusion timestep embedding: (B,) timesteps → (B, dim), sin before
    cos, frequencies exp(-log(10000) · i / (dim/2 - 1))."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        half = self.dim // 2
        freqs = torch.exp(-math.log(10000) * torch.arange(half, device=t.device) / (half - 1))
        ang = t.float()[:, None] * freqs[None]
        return torch.cat([ang.sin(), ang.cos()], dim=-1)


def causal_mask(T: int, device=None) -> torch.Tensor:
    """(T, T) boolean, True = attend (the lower triangle)."""
    return torch.ones((T, T), dtype=torch.bool, device=device).tril()
