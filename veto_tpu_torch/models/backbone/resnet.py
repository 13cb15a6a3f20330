"""ResNet / ResNeXt body with frozen BatchNorm, and the FPN backbone.

Port of ``veto_tpu/models/backbone/resnet.py`` (maskrcnn-benchmark R-101-FPN
32x8d).  Two TPU devices of the JAX package become their plain equivalents
with the same math: ``GroupedConv3x3``'s block-diagonal dense expansion is
a native ``groups=32`` convolution, and ``stem_conv_s2d``'s space-to-depth
rewrite is the plain 7x7/2 pad-3 convolution.

Modules compute in NCHW on tensors in ``channels_last`` memory: the public
boundary is NHWC (the JAX package's layout), and ``permute(0, 3, 1, 2)`` of
an NHWC tensor is exactly a channels-last NCHW view, so no copy is made in
either direction.  Module and parameter names follow the flax tree, so
``utils/jax_weights.py`` maps one onto the other by name.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d


class FrozenBatchNorm(nn.Module):
    """Per-channel affine ``y = x * scale + bias`` — inference BatchNorm
    folded (``scale = gamma / sqrt(var + eps)``, ``bias = beta - mean *
    scale``); the detector is frozen, so the fold is exact."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x * self.weight.to(x.dtype)[:, None, None]
                + self.bias.to(x.dtype)[:, None, None])


class Bottleneck(nn.Module):
    """1x1 → grouped 3x3 → 1x1 bottleneck.  With ``fold_bn`` every conv
    carries the folded BN as its bias and no FrozenBatchNorm is built."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, stride: int = 1, groups: int = 1,
                 stride_in_1x1: bool = False, fold_bn: bool = True):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.fold_bn = fold_bn
        self.has_downsample = in_channels != out_channels or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(in_channels, out_channels, 1,
                                          stride=stride, bias=fold_bn)
        self.conv1 = Conv2d(in_channels, bottleneck_channels, 1, stride=s1,
                            bias=fold_bn)
        self.conv2 = Conv2d(bottleneck_channels, bottleneck_channels, 3,
                            stride=s3, padding=1, groups=groups, bias=fold_bn)
        self.conv3 = Conv2d(bottleneck_channels, out_channels, 1, bias=fold_bn)
        if not fold_bn:
            if self.has_downsample:
                self.downsample_bn = FrozenBatchNorm(out_channels)
            self.bn1 = FrozenBatchNorm(bottleneck_channels)
            self.bn2 = FrozenBatchNorm(bottleneck_channels)
            self.bn3 = FrozenBatchNorm(out_channels)

    def _bn(self, name: str, y: torch.Tensor) -> torch.Tensor:
        return y if self.fold_bn else getattr(self, name)(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.has_downsample:
            shortcut = self._bn("downsample_bn", self.downsample_conv(x))
        y = F.relu(self._bn("bn1", self.conv1(x)))
        y = F.relu(self._bn("bn2", self.conv2(y)))
        y = self._bn("bn3", self.conv3(y))
        return F.relu(y + shortcut)


class ResNetBody(nn.Module):
    """Stem + residual stages → C2..C5 (NCHW).  Defaults: ResNeXt-101 32x8d
    with the stride in the 3x3 (``STRIDE_IN_1X1=False``)."""

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 23, 3),
                 groups: int = 32, width_per_group: int = 8,
                 stride_in_1x1: bool = False, fold_bn: bool = True):
        super().__init__()
        self.fold_bn = fold_bn
        self.stem_conv = Conv2d(3, 64, 7, stride=2, padding=3, bias=fold_bn)
        if not fold_bn:
            self.stem_bn = FrozenBatchNorm(64)
        self.block_names = []
        bottleneck, in_ch, out_ch = groups * width_per_group, 64, 256
        self.stage_ends = []
        for stage_idx, num_blocks in enumerate(stage_blocks):
            for block_idx in range(num_blocks):
                name = f"layer{stage_idx + 1}_block{block_idx}"
                stride = 2 if (block_idx == 0 and stage_idx > 0) else 1
                self.add_module(name, Bottleneck(
                    in_ch, bottleneck, out_ch, stride, groups, stride_in_1x1,
                    fold_bn))
                self.block_names.append(name)
                in_ch = out_ch
            self.stage_ends.append(self.block_names[-1])
            bottleneck *= 2
            out_ch *= 2
        self.out_channels = tuple(256 * 2 ** i for i in range(len(stage_blocks)))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.stem_conv(x)
        if not self.fold_bn:
            x = self.stem_bn(x)
        x = F.max_pool2d(F.relu(x), 3, stride=2, padding=1)
        outs = []
        for name in self.block_names:
            x = getattr(self, name)(x)
            if name in self.stage_ends:
                outs.append(x)
        return tuple(outs)


class ResNetFPNBackbone(nn.Module):
    """ResNet body + FPN: NHWC images (B, H, W, 3) → NHWC (P2..P6)."""

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 23, 3),
                 groups: int = 32, width_per_group: int = 8,
                 fpn_channels: int = 256, fold_bn: bool = True,
                 stride_in_1x1: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        from .fpn import FPN

        self.dtype = dtype
        self.body = ResNetBody(stage_blocks, groups, width_per_group,
                               stride_in_1x1, fold_bn)
        self.fpn = FPN(self.body.out_channels, fpn_channels)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = images.to(self.dtype).permute(0, 3, 1, 2)  # channels-last NCHW
        feats = self.fpn(self.body(x))
        return tuple(f.permute(0, 2, 3, 1) for f in feats)
