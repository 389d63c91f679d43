"""CLIP-style ViT image encoder and the RGB-D fusion of RDP.

Port of internnav_tpu/model/encoder/clip_vit.py (reference
internnav/model/encoder/image_clip_encoder.py):

- `CLIPVisionTower`: OpenAI CLIP ViT-B/16 structure (patch conv without
  bias, class token, learned positions, ln_pre, pre-norm blocks with
  QuickGELU; no ln_post), normalized pixels (B, H, W, 3) → (B, 1 + P,
  width);
- `CLIPImageEncoder` (the reference's ImageEncoder): raw 0-255 RGB through
  CLIP's pixel normalization and the tower; depth through the DD-PPO
  `VlnResnetDepthEncoder` (spatial tokens, `model.encoder.resnet.HabitatResNetEncoder`),
  flattened token-major into `depth_linear` (no activation, as in JAX);
  mode 'multi_patches_avg_pooling' (encode_image_multi_patches:218-259):
  the class token and the patch grid's four quadrant means, 5 tokens
  through `img_learnable_linear`, the depth projection added onto token 0;
  mode 'cls': the class token's projection plus the depth's, `fuse_ln`.

`depth_hw` is the depth frame's side: the depth tower's token count and
so `depth_linear`'s width depend on it (JAX infers it at init; the
reference's frames are 256).
"""

from __future__ import annotations

import torch
from torch import nn

from internnav_tpu_torch.model.encoder.longclip import quick_gelu
from internnav_tpu_torch.model.encoder.resnet import VlnResnetDepthEncoder
from internnav_tpu_torch.model.encoder.transformer import MultiHeadAttention

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_pixels(rgb: torch.Tensor) -> torch.Tensor:
    """Raw 0-255 RGB (B, H, W, 3) → CLIP-normalized fp32 pixels."""
    mean = torch.tensor(CLIP_MEAN, device=rgb.device)
    std = torch.tensor(CLIP_STD, device=rgb.device)
    return (rgb.float() / 255.0 - mean) / std


class CLIPVitBlock(nn.Module):
    def __init__(self, width: int = 768, heads: int = 12):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = MultiHeadAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x):
        xn = self.ln_1(x)
        x = x + self.attn(xn, xn, xn)
        return x + self.c_proj(quick_gelu(self.c_fc(self.ln_2(x))))


class CLIPVisionTower(nn.Module):
    """(B, H, W, 3) normalized pixels → (B, 1 + P, width) token features
    at `image_hw` (the positional table's length is fixed by it)."""

    def __init__(self, width: int = 768, layers: int = 12, heads: int = 12,
                 patch_size: int = 16, image_hw: int = 224):
        super().__init__()
        self.width = width
        self.conv1 = nn.Conv2d(3, width, patch_size, patch_size, bias=False)
        self.class_embedding = nn.Parameter(0.02 * torch.randn(width))
        n_tokens = (image_hw // patch_size) ** 2 + 1
        self.positional_embedding = nn.Parameter(0.01 * torch.randn(n_tokens, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.block = nn.ModuleList(CLIPVitBlock(width, heads) for _ in range(layers))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        B = pixels.shape[0]
        x = self.conv1(pixels.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)  # (B, P, W)
        cls = self.class_embedding.expand(B, 1, self.width)
        x = self.ln_pre(torch.cat([cls, x], dim=1) + self.positional_embedding[None])
        for blk in self.block:
            x = blk(x)
        return x  # no ln_post: the multi-patch path uses the raw tokens


class CLIPImageEncoder(nn.Module):
    """rgb (B, H, W, 3) raw 0-255, depth (B, depth_hw, depth_hw, 1) →
    (B, 5, projection_dim) in multi-patch mode, (B, 1, projection_dim) in
    cls mode."""

    def __init__(self, projection_dim: int = 512, img_mod: str = "multi_patches_avg_pooling",
                 vit_width: int = 768, vit_layers: int = 12, vit_heads: int = 12,
                 image_hw: int = 224, depth_hw: int = 256):
        super().__init__()
        self.img_mod = img_mod
        self.visual = CLIPVisionTower(vit_width, vit_layers, vit_heads, image_hw=image_hw)
        self.depth_encoder = VlnResnetDepthEncoder(spatial_output=True, input_hw=depth_hw)
        depth_flat = self.depth_encoder.n_tokens * self.depth_encoder.out_channels
        self.depth_linear = nn.Linear(depth_flat, vit_width)
        self.img_learnable_linear = nn.Linear(vit_width, projection_dim)
        self.depth_learnable_linear = nn.Linear(vit_width, projection_dim)
        if img_mod == "cls":
            self.fuse_ln = nn.LayerNorm(projection_dim, eps=1e-5)

    def forward(self, rgb: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        tokens = self.visual(clip_pixels(rgb))  # (B, 1 + P, W)
        d = self.depth_encoder(depth)
        d = self.depth_linear(d.reshape(d.shape[0], -1))
        if self.img_mod == "cls":
            fused = self.img_learnable_linear(tokens[:, 0]) + self.depth_learnable_linear(d)
            return self.fuse_ln(fused)[:, None]
        B, P1, W = tokens.shape
        grid = int(round((P1 - 1) ** 0.5))
        half = grid // 2
        patches = tokens[:, 1:].reshape(B, grid, grid, W)[:, : 2 * half, : 2 * half]
        pooled = patches.reshape(B, 2, half, 2, half, W).mean(dim=(2, 4)).reshape(B, 4, W)
        out = self.img_learnable_linear(torch.cat([tokens[:, :1], pooled], dim=1))
        return torch.cat([out[:, :1] + self.depth_learnable_linear(d)[:, None], out[:, 1:]],
                         dim=1)
