"""DepthAnythingV2's DPT depth head over a DINOv2 ViT-S trunk.

Port of internnav_tpu/model/encoder/dpt.py (reference
internnav/model/encoder/depth_anything/depth_anything_v2/dpt.py:38-185 and
util/blocks.py): `DPTHead` over the trunk's intermediate blocks
(2, 5, 8, 11), out channels (48, 96, 192, 384), 64 features, refinenet
fusion with align_corners=True bilinear upsampling, and a sigmoid metric
depth scaled by max_depth. Input is NHWC like the JAX module; the convs
run NCHW inside, fp32 with TF32 off.

The JAX module writes its align_corners resize as two interpolation
matrices (`_interp_matrix`); here it is `F.interpolate(mode="bilinear",
align_corners=True)`, the same weights in another summation order.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from internnav_tpu_torch.model.encoder.navdp_backbone import _fp32_convolutions
from internnav_tpu_torch.model.encoder.vit import DinoViT

VITS_INTERMEDIATE_IDX = (2, 5, 8, 11)  # dpt.py:165
VITS_OUT_CHANNELS = (48, 96, 192, 384)
VITS_FEATURES = 64


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """NCHW bilinear resize with align_corners=True."""
    if tuple(out_hw) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=True)


def _conv(cin, cout, k, stride=1, padding=0, bias=True):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias)


class ResidualConvUnit(nn.Module):
    """util/blocks.py:29-80, bn=False: relu → conv → relu → conv, + skip."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = _conv(features, features, 3, padding=1)
        self.conv2 = _conv(features, features, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """util/blocks.py:83-146 (deconv=False, expand=False,
    align_corners=True). The first fusion block (refinenet4) has no skip
    input and so no res1 (JAX creates it only when called with a skip)."""

    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.res1 = ResidualConvUnit(features)
        self.res2 = ResidualConvUnit(features)
        self.out_conv = _conv(features, features, 1)

    def forward(self, x, skip=None, size: Optional[Tuple[int, int]] = None):
        out = x if skip is None else x + self.res1(skip)
        out = self.res2(out)
        if size is None:
            size = (2 * out.shape[-2], 2 * out.shape[-1])  # scale_factor=2
        return self.out_conv(resize_bilinear_align_corners(out, size))


class DPTHead(nn.Module):
    """dpt.py:38-149 (use_bn=False, use_clstoken=False)."""

    def __init__(self, in_channels: int = 384, features: int = VITS_FEATURES,
                 out_channels: Sequence[int] = VITS_OUT_CHANNELS, patch_size: int = 14):
        super().__init__()
        oc = list(out_channels)
        self.patch_size = patch_size
        for i in range(4):
            self.add_module(f"project_{i}", _conv(in_channels, oc[i], 1))
        self.resize_0 = nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4)
        self.resize_1 = nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2)
        self.resize_3 = _conv(oc[3], oc[3], 3, stride=2, padding=1)
        for i in range(4):
            self.add_module(f"layer{i + 1}_rn", _conv(oc[i], features, 3, padding=1, bias=False))
        self.refinenet4 = FeatureFusionBlock(features, with_skip=False)
        for i in (3, 2, 1):
            self.add_module(f"refinenet{i}", FeatureFusionBlock(features))
        self.output_conv1 = _conv(features, features // 2, 3, padding=1)
        self.output_conv2_0 = _conv(features // 2, 32, 3, padding=1)
        self.output_conv2_2 = _conv(32, 1, 1)

    def forward(self, features, patch_h: int, patch_w: int):
        """features: 4 (patch_tokens (B, P, C), cls) pairs → (B, 1, H, W)
        in [0, 1]."""
        outs = []
        for i, feat in enumerate(features):
            tok = feat[0] if isinstance(feat, (tuple, list)) else feat
            B = tok.shape[0]
            x = tok.transpose(1, 2).reshape(B, tok.shape[-1], patch_h, patch_w)
            x = getattr(self, f"project_{i}")(x)
            if i in (0, 1, 3):
                x = getattr(self, f"resize_{i}")(x)
            outs.append(x)
        rn = [getattr(self, f"layer{i + 1}_rn")(outs[i]) for i in range(4)]
        path4 = self.refinenet4(rn[3], size=rn[2].shape[-2:])
        path3 = self.refinenet3(path4, rn[2], size=rn[1].shape[-2:])
        path2 = self.refinenet2(path3, rn[1], size=rn[0].shape[-2:])
        path1 = self.refinenet1(path2, rn[0])
        out = self.output_conv1(path1)
        out = resize_bilinear_align_corners(
            out, (patch_h * self.patch_size, patch_w * self.patch_size))
        out = self.output_conv2_2(F.relu(self.output_conv2_0(out)))
        return torch.sigmoid(out)


class DepthAnythingV2(nn.Module):
    """dpt.py:152-195, the vits metric-depth variant: (B, H, W, 3)
    ImageNet-normalized pixels → (B, H, W) metric depth in [0, max_depth].
    `image_hw` sizes the trunk's position embedding."""

    def __init__(self, features: int = VITS_FEATURES,
                 out_channels: Sequence[int] = VITS_OUT_CHANNELS, max_depth: float = 20.0,
                 image_hw: int = 518):
        super().__init__()
        self.max_depth = max_depth
        self.pretrained = DinoViT(image_hw=image_hw)
        self.depth_head = DPTHead(384, features, out_channels, DinoViT.patch_size)

    def forward(self, pixels):
        p = DinoViT.patch_size
        patch_h, patch_w = pixels.shape[1] // p, pixels.shape[2] // p
        with _fp32_convolutions():
            feats = self.pretrained(pixels.float(), intermediates=VITS_INTERMEDIATE_IDX)
            depth = self.depth_head(feats, patch_h, patch_w)
        return depth[:, 0] * self.max_depth
