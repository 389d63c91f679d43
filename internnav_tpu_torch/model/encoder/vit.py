"""DINOv2-style ViT trunk (port of internnav_tpu/model/encoder/vit.py
`DinoViT`, `DinoBlock`, `imagenet_normalize`). Input is NHWC like the JAX module; the patch
embed pads SAME, as flax `nn.Conv` does."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from internnav_tpu_torch.model.encoder.transformer import MultiHeadAttention

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class DinoBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.ls1 = nn.Parameter(torch.zeros(dim, dtype=dtype))  # LayerScale
        self.ls2 = nn.Parameter(torch.zeros(dim, dtype=dtype))
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.attn = MultiHeadAttention(dim, heads, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.mlp_fc1 = nn.Linear(dim, 4 * dim, dtype=dtype)
        self.mlp_fc2 = nn.Linear(4 * dim, dim, dtype=dtype)

    def forward(self, x):
        xn = self.norm1(x)
        x = x + self.ls1 * self.attn(xn, xn, xn)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + self.ls2 * y


class DinoViT(nn.Module):
    """(B, H, W, 3) → final-block patch tokens (B, P, dim). `image_hw` sizes
    the learned position embedding (1 + ceil(hw / 14)^2 tokens)."""

    patch_size = 14

    def __init__(self, dim: int = 384, depth: int = 12, heads: int = 6, image_hw: int = 224,
                 dtype=torch.float32):
        super().__init__()
        self.dim = dim
        p = self.patch_size
        grid = math.ceil(image_hw / p)
        self.patch_embed = nn.Conv2d(3, dim, p, stride=p, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim, dtype=dtype))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid * grid, dim, dtype=dtype))
        self.block = nn.ModuleList(DinoBlock(dim, heads, dtype=dtype) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6, dtype=dtype)

    def forward(self, pixels):
        B, H, W, _ = pixels.shape
        p = self.patch_size
        pad_h = max((-(-H // p) - 1) * p + p - H, 0)
        pad_w = max((-(-W // p) - 1) * p + p - W, 0)
        x = pixels.permute(0, 3, 1, 2)
        x = F.pad(x, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
        x = self.patch_embed(x)  # (B, dim, Ph, Pw)
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(B, 1, self.dim), x], dim=1)
        x = x + self.pos_embed
        for blk in self.block:
            x = blk(x)
        return self.norm(x)[:, 1:]


_IMAGENET_STATS = {}  # device → (mean, std), uploaded once


def imagenet_normalize(images: torch.Tensor) -> torch.Tensor:
    """(..., 3) float images in [0, 1] → ImageNet-normalized (fp32 mean and
    std, a division as in the JAX module)."""
    stats = _IMAGENET_STATS.get(images.device)
    if stats is None:
        stats = _IMAGENET_STATS[images.device] = tuple(
            torch.tensor(v, dtype=torch.float32, device=images.device)
            for v in (IMAGENET_MEAN, IMAGENET_STD))
    return (images - stats[0]) / stats[1]
