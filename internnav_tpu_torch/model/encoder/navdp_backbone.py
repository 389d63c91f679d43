"""NavDP backbone parts (port of internnav_tpu/model/encoder/navdp_backbone.py:
`FormerDecoder`, pre- and post-norm; `RGBDBackbone`; `TokenCompressor`).

Inputs are NHWC like the JAX modules: images (B, T, H, W, 3) in [0, 1],
depths (B, T, H, W, 1) in metres, pre-clamped; depth goes in un-normalized
and repeated to 3 channels."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from internnav_tpu_torch.model.encoder.transformer import (
    MultiHeadAttention,
    TransformerDecoderLayer,
)
from internnav_tpu_torch.model.encoder.vit import DinoViT, imagenet_normalize


class FormerDecoder(nn.Module):
    """N-layer torch TransformerDecoder (batch_first). Post-norm by default,
    its LayerNorms at flax's default eps 1e-6, as the JAX module has them;
    norm_first=True stacks pre-norm `TransformerDecoderLayer`s (eps 1e-5),
    named layer_{i}."""

    def __init__(self, dim: int, heads: int, layers: int, dim_feedforward: int = 0,
                 dtype=torch.float32, norm_first: bool = False):
        super().__init__()
        self.layers = layers
        self.norm_first = norm_first
        ff = dim_feedforward or 4 * dim
        for i in range(layers):
            if norm_first:
                self.add_module(f"layer_{i}", TransformerDecoderLayer(
                    dim, heads, dim_feedforward or None, dtype=dtype))
                continue
            self.add_module(f"layer_{i}_self", MultiHeadAttention(dim, heads, dtype))
            self.add_module(f"layer_{i}_ln1", nn.LayerNorm(dim, eps=1e-6, dtype=dtype))
            self.add_module(f"layer_{i}_cross", MultiHeadAttention(dim, heads, dtype))
            self.add_module(f"layer_{i}_ln2", nn.LayerNorm(dim, eps=1e-6, dtype=dtype))
            self.add_module(f"layer_{i}_ff1", nn.Linear(dim, ff, dtype=dtype))
            self.add_module(f"layer_{i}_ff2", nn.Linear(ff, dim, dtype=dtype))
            self.add_module(f"layer_{i}_ln3", nn.LayerNorm(dim, eps=1e-6, dtype=dtype))

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        x = tgt
        for i in range(self.layers):
            if self.norm_first:
                x = getattr(self, f"layer_{i}")(x, memory, tgt_mask=tgt_mask,
                                                memory_mask=memory_mask)
                continue
            m = lambda name: getattr(self, f"layer_{i}_{name}")  # noqa: E731
            x = m("ln1")(x + m("self")(x, x, x, None, tgt_mask))
            x = m("ln2")(x + m("cross")(x, memory, memory, None, memory_mask))
            x = m("ln3")(x + m("ff2")(F.relu(m("ff1")(x))))
        return x


@contextlib.contextmanager
def _fp32_convolutions():
    """cuDNN convolutions in full fp32 (its TF32 default off) while the
    towers run: the head's arithmetic is fp32, as in the JAX module."""
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = allow


class RGBDBackbone(nn.Module):
    """Two DINOv2 ViT-S towers (rgb, and depth as 3 channels) over a
    memory_size frame stack → 2·memory·(image_hw/14)² tokens + a learned PE
    (2·memory·256 rows) → a 2-layer post-norm former queried by memory·16
    learned queries → a linear projection to embed_size. `image_hw` sizes
    the towers' position embeddings."""

    def __init__(self, embed_size: int = 512, memory_size: int = 8, token_dim: int = 384,
                 image_hw: int = 224):
        super().__init__()
        self.memory_size = memory_size
        self.token_dim = token_dim
        self.rgb_model = DinoViT(image_hw=image_hw)
        self.depth_model = DinoViT(image_hw=image_hw)
        self.former_pe = nn.Embedding(2 * memory_size * 256, token_dim)
        self.former_query = nn.Embedding(memory_size * 16, token_dim)
        self.former_net = FormerDecoder(token_dim, 8, 2)
        self.project_layer = nn.Linear(token_dim, embed_size)

    def forward(self, images, depths):
        """images (B, T, H, W, 3) in [0, 1]; depths (B, T, H, W, 1) →
        memory tokens (B, memory·16, embed_size)."""
        B = images.shape[0]
        rgb = imagenet_normalize(images.reshape((-1,) + images.shape[2:]).float())
        d = depths.reshape((-1,) + depths.shape[2:]).float()
        with _fp32_convolutions():
            rgb_tokens = self.rgb_model(rgb).reshape(B, -1, self.token_dim)
            depth_tokens = self.depth_model(d.repeat_interleave(3, dim=-1)).reshape(
                B, -1, self.token_dim)
        tokens = torch.cat([rgb_tokens, depth_tokens], dim=1)
        tokens = tokens + self.former_pe.weight[: tokens.shape[1]][None]
        queries = self.former_query.weight[None].expand(B, -1, -1)
        return self.project_layer(self.former_net(queries, tokens))


class TokenCompressor(nn.Module):
    """Cross-attention pooling of (B, L, embed_dim) tokens onto
    target_length learned queries; padding_mask (B, L) True = masked out."""

    def __init__(self, embed_dim: int, num_heads: int, target_length: int):
        super().__init__()
        self.target_length = target_length
        self.token_pe = nn.Embedding(5000, embed_dim)
        self.target_embedding = nn.Embedding(target_length, embed_dim)
        self.query_pe = nn.Embedding(5000, embed_dim)
        self.cross_attention = MultiHeadAttention(embed_dim, num_heads)

    def forward(self, x, padding_mask=None):
        B = x.shape[0]
        x = x + self.token_pe.weight[: x.shape[1]][None]
        q = self.target_embedding.weight + self.query_pe.weight[: self.target_length]
        q = q[None].expand(B, -1, -1)
        return self.cross_attention(q, x, x, padding_mask)
