"""ResNet visual encoders of the recurrent VLN policies.

Port of internnav_tpu/model/encoder/resnet.py, NCHW with `nn.Conv2d`
inside; inputs and outputs keep the JAX package's layouts (frames
(B, H, W, C), token-major features (B, H·W, C)), so a depth tower's
flattened features are token-major as in JAX (the reference flattens
channel-major; `model/weights/convert.py` reorders its Linear for that).

- `HabitatResNetEncoder`: the DD-PPO GroupNorm ResNet with its 3x3
  compression head (reference resnet.py:190-478); ResNet-50 by default
  (bottleneck (3, 4, 6, 3), base 32, 16 groups). GroupNorm takes the JAX
  package's epsilon, Flax's default 1e-6 (torch's default is 1e-5).
- `TorchVisionResNet`: the BatchNorm ResNet-18/34/50 RGB tower with
  frozen statistics (eps 1e-5), a 4x4 adaptive average pool (torch's,
  which JAX's `_adaptive_avg_pool` reproduces, also where the grid is
  smaller than 4x4) and spatial embeddings, or a global pool and `fc`
  (reference resnet_encoders.py:123-236).
- `VlnResnetDepthEncoder`: the depth tower, spatial tokens or `visual_fc`.

Convolutions pad by k // 2 on each side, max-pool pads with -inf (torch's
padding), the depth stem average-pools 2x2 before the trunk. A module's
parameter names are the JAX tree's with `layer<s>_<b>` as the ModuleList
entry `layer<s>.<b>`. Shapes that depend on the input frame (the depth
tower's token count and compression width) are fixed at construction
from `input_hw`, as the JAX package fixes them at init.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

#: Flax nn.GroupNorm's default epsilon, which the JAX towers use
GN_EPS = 1e-6
BN_EPS = 1e-5


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm: y = x * inv + (bias - mean * inv),
    inv = weight / sqrt(var + eps), over NCHW channels. Its four tensors
    are parameters, as in JAX (where they are params, which the
    recurrent trainers update with the rest)."""

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight / torch.sqrt(self.var + self.eps)
        return x * inv[:, None, None] + (self.bias - self.mean * inv)[:, None, None]


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, padding=kernel // 2, bias=False)


def _gn(groups: int, channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=GN_EPS)


def _conv_out(n: int, kernel: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - kernel) // stride + 1


class _Block(nn.Module):
    """A basic (two 3x3) or bottleneck (1x1, 3x3, 1x1) residual block with
    GroupNorm (`norm="gn"`) or frozen BatchNorm (`norm="bn"`)."""

    def __init__(self, cin: int, planes: int, stride: int, bottleneck: bool, norm: str,
                 ngroups: int = 0):
        super().__init__()
        self.norm_name = norm
        out = planes * (4 if bottleneck else 1)

        def norm_layer(c):
            return _gn(ngroups, c) if norm == "gn" else FrozenBatchNorm(c)

        if bottleneck:
            convs = [_conv(cin, planes, 1), _conv(planes, planes, 3, stride), _conv(planes, out, 1)]
        else:
            convs = [_conv(cin, planes, 3, stride), _conv(planes, planes, 3)]
        for i, conv in enumerate(convs, start=1):
            setattr(self, f"conv{i}", conv)
            setattr(self, f"{self.norm_name}{i}", norm_layer(conv.out_channels))
        self.n_convs = len(convs)
        self.use_downsample = stride != 1 or cin != out
        if self.use_downsample:
            self.ds_conv = _conv(cin, out, 1, stride)
            setattr(self, f"ds_{self.norm_name}", norm_layer(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(1, self.n_convs + 1):
            y = getattr(self, f"{self.norm_name}{i}")(getattr(self, f"conv{i}")(y))
            if i < self.n_convs:
                y = F.relu(y)
        residual = x
        if self.use_downsample:
            residual = getattr(self, f"ds_{self.norm_name}")(self.ds_conv(x))
        return F.relu(y + residual)


def _stages(cin: int, base: int, layers: Sequence[int], bottleneck: bool, norm: str,
            ngroups: int = 0) -> Tuple[List[nn.ModuleList], int]:
    """layer1..layer4 as ModuleLists (set by the caller) and the trunk's
    output channels."""
    stages, inplanes, planes = [], cin, base
    for s, blocks in enumerate(layers):
        mods = []
        for b in range(blocks):
            stride = (1 if s == 0 else 2) if b == 0 else 1
            mods.append(_Block(inplanes, planes, stride, bottleneck, norm, ngroups))
            inplanes = planes * (4 if bottleneck else 1)
        stages.append(nn.ModuleList(mods))
        planes *= 2
    return stages, inplanes


def _trunk_hw(n: int, stages: int) -> int:
    """Side of the trunk's output: the 7x7 stride-2 stem, the 3x3 stride-2
    max-pool, then stride 2 from the second stage on."""
    n = _conv_out(_conv_out(n, 7, 2, 3), 3, 2, 1)
    for _ in range(stages - 1):
        n = _conv_out(n, 3, 2, 1)
    return n


class GroupNormResNet(nn.Module):
    """Habitat-style GN ResNet trunk (reference resnet.py:190-290)."""

    def __init__(self, in_channels: int = 1, base_planes: int = 32, ngroups: int = 16,
                 layers: Sequence[int] = (3, 4, 6, 3), block: str = "bottleneck"):
        super().__init__()
        self.stem_conv = nn.Conv2d(in_channels, base_planes, 7, 2, 3, bias=False)
        self.stem_gn = _gn(ngroups, base_planes)
        stages, self.out_channels = _stages(base_planes, base_planes, layers,
                                            block == "bottleneck", "gn", ngroups)
        for s, stage in enumerate(stages, start=1):
            setattr(self, f"layer{s}", stage)
        self.n_stages = len(stages)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_gn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for s in range(1, self.n_stages + 1):
            for blk in getattr(self, f"layer{s}"):
                x = blk(x)
        return x


class HabitatResNetEncoder(nn.Module):
    """GN ResNet trunk + 3x3 compression head (reference resnet.py:380-478).

    Input (B, C, H, W) at `input_hw`; output NCHW (B, Cc, S, S) with
    S = the trunk's side after the 2x2 stem pool and Cc = round(2048 / S²).
    """

    def __init__(self, in_channels: int = 1, base_planes: int = 32, ngroups: int = 16,
                 layers: Sequence[int] = (3, 4, 6, 3), block: str = "bottleneck",
                 input_hw: int = 256):
        super().__init__()
        self.backbone = GroupNormResNet(in_channels, base_planes, ngroups, layers, block)
        self.side = _trunk_hw(input_hw // 2, len(layers))
        self.out_channels = int(round(2048 / (self.side * self.side)))
        self.compress_conv = _conv(self.backbone.out_channels, self.out_channels, 3)
        self.compress_gn = _gn(1, self.out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.backbone(F.avg_pool2d(x, 2, 2))
        return F.relu(self.compress_gn(self.compress_conv(x)))


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW → token-major (B, H·W, C)."""
    return x.flatten(2).transpose(1, 2)


_TV_CONFIGS = {
    "resnet18": (False, (2, 2, 2, 2), 512),
    "resnet34": (False, (3, 4, 6, 3), 512),
    "resnet50": (True, (3, 4, 6, 3), 2048),
}


class TorchVisionResNet(nn.Module):
    """BN ResNet RGB tower (reference resnet_encoders.py:123-225).

    Input rgb (B, H, W, 3), raw pixel values 0-255. Output (B, 16,
    final_channels + 64) tokens (a 4x4 adaptive average pool and spatial
    embeddings), or (B, output_size) with spatial_output=False (global
    average pool, `fc`, ReLU).
    """

    def __init__(self, version: str = "resnet50", output_size: int = 256,
                 normalize_visual_inputs: bool = False, spatial_output: bool = True,
                 spatial_embed_dim: int = 64):
        super().__init__()
        bottleneck, layers, self.final_channels = _TV_CONFIGS[version]
        self.normalize_visual_inputs = normalize_visual_inputs
        self.spatial_output = spatial_output
        self.stem_conv = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.stem_bn = FrozenBatchNorm(64)
        stages, _ = _stages(64, 64, layers, bottleneck, "bn")
        for s, stage in enumerate(stages, start=1):
            setattr(self, f"layer{s}", stage)
        self.n_stages = len(stages)
        if spatial_output:
            self.spatial_embeddings = nn.Parameter(torch.randn(16, spatial_embed_dim))
        else:
            self.fc = nn.Linear(self.final_channels, output_size)

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        x = rgb.float().permute(0, 3, 1, 2) / 255.0
        if self.normalize_visual_inputs:
            mean = x.new_tensor([0.485, 0.456, 0.406])[:, None, None]
            std = x.new_tensor([0.229, 0.224, 0.225])[:, None, None]
            x = (x - mean) / std
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for s in range(1, self.n_stages + 1):
            for blk in getattr(self, f"layer{s}"):
                x = blk(x)
        if not self.spatial_output:
            return F.relu(self.fc(x.mean(dim=(2, 3))))
        tokens = _tokens(F.adaptive_avg_pool2d(x, 4))
        spatial = self.spatial_embeddings.to(tokens.dtype).expand(tokens.shape[0], -1, -1)
        return torch.cat([tokens, spatial], dim=-1)


class VlnResnetDepthEncoder(nn.Module):
    """Depth tower = HabitatResNetEncoder + spatial embeddings, or
    `visual_fc` (reference resnet_encoders.py:16-120).

    Input depth (B, H, W, 1) in [0, 1] at `input_hw`. Output (B, S·S,
    C + 64) tokens (at 256x256: (B, 16, 128 + 64)), or (B, output_size)
    with spatial_output=False (ReLU(visual_fc) of the token-major flatten).
    """

    def __init__(self, output_size: int = 128, spatial_output: bool = True,
                 spatial_embed_dim: int = 64, input_hw: int = 256):
        super().__init__()
        self.visual_encoder = HabitatResNetEncoder(input_hw=input_hw)
        self.spatial_output = spatial_output
        side, c = self.visual_encoder.side, self.visual_encoder.out_channels
        self.n_tokens = side * side
        if spatial_output:
            self.spatial_embeddings = nn.Parameter(torch.randn(self.n_tokens, spatial_embed_dim))
            self.out_channels = c + spatial_embed_dim
        else:
            self.visual_fc = nn.Linear(self.n_tokens * c, output_size)

    def forward(self, depth: torch.Tensor) -> torch.Tensor:
        x = _tokens(self.visual_encoder(depth.float().permute(0, 3, 1, 2)))
        if not self.spatial_output:
            return F.relu(self.visual_fc(x.reshape(x.shape[0], -1)))
        spatial = self.spatial_embeddings.to(x.dtype).expand(x.shape[0], -1, -1)
        return torch.cat([x, spatial], dim=-1)
