"""Depth backbone: ResNet-18 truncated after layer3, 1-channel input.

Port of ``veto_tpu/models/backbone/depth_resnet.py``: (B, H, W, 1) depth →
(B, H/16, W/16, 256), NHWC at the boundary, channels-last NCHW inside.
BatchNorm runs from its running statistics (eps 1e-5); training it comes
with the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import BatchNorm2d, Conv2d


class BasicBlock(nn.Module):
    """torchvision BasicBlock: two 3x3 convs + BN, identity/projection skip."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.has_downsample = in_features != features or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(in_features, features, 1,
                                          stride=stride, bias=False)
            self.downsample_bn = BatchNorm2d(features)
        self.conv1 = Conv2d(in_features, features, 3, stride=stride, padding=1,
                            bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.has_downsample:
            shortcut = self.downsample_bn(self.downsample_conv(x))
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + shortcut)


class DepthResNet18(nn.Module):
    """(B, H, W, 1) depth image → (B, H/16, W/16, 256) NHWC feature map."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(1, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.block_names = []
        in_f = 64
        for stage, (feats, stride) in enumerate(((64, 1), (128, 2), (256, 2))):
            for block in range(2):
                name = f"layer{stage + 1}_block{block}"
                self.add_module(name, BasicBlock(in_f, feats,
                                                 stride if block == 0 else 1))
                self.block_names.append(name)
                in_f = feats

    def forward(self, depth: torch.Tensor) -> torch.Tensor:
        x = depth.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x.permute(0, 2, 3, 1)
