"""Union-box features of the legacy relation predictors
(``veto_tpu/models/relation/union_features.py``, the reference's
``RelationFeatureExtractor``).

For each pair the union of the subject and object boxes is pooled 7x7 from
P2-P5 (kernel B3 on the card: a union box is at least as large as either
box, so most of these rois map to P4 and P5), the two boxes are rasterised
as a 2-channel 27x27 rectangle mask and run through a small conv stack
(conv 7x7 s2 → ReLU → BN → max-pool 3 s2 → conv 3x3 → ReLU → BN, BN
momentum 0.99 in flax's terms), the two are summed and pushed through
fc6 / fc7 with ReLU: (B, P) pairs → (B, P, mlp_dim).

Layout: the pooled map is NHWC (B, P, 7, 7, C) and fc6 flattens it in that
(h, w, c) order, as in the JAX package.  The conv stack runs on NCHW
tensors in the channels-last memory format, so its output's permute back
to NHWC before the sum is a view, and fc6's rows need no permutation.
The rect BatchNorms take their training statistics over every pair, the
padded ones included, as flax's do.

The JAX module's ``pooler_fallback_budget`` sizes the exact fallback of the
TPU's windowed pooler (a roi whose taps leave its VMEM window); the card's
kernel reads the assigned level directly and has no window, so the port
has no such budget.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.box_ops import box_union, resize_boxes
from ...ops.roi_align_windowed import multilevel_roi_align_batched
from ..layers import BatchNorm2d, Conv2d, Dense
from .legacy.lstm import gather_rows


def union_boxes(boxes: torch.Tensor, pair_idx: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per pair the (union, head, tail) boxes, each (B, P, 4), of (B, N, 4)
    boxes and (B, P, 2) pairs."""
    head = gather_rows(boxes, pair_idx[..., 0])
    tail = gather_rows(boxes, pair_idx[..., 1])
    return box_union(head, tail), head, tail


def rect_masks(head: torch.Tensor, tail: torch.Tensor, image_size: torch.Tensor,
               rect_size: int = 27) -> torch.Tensor:
    """(..., P, rect_size, rect_size, 2) f32 rectangles of the subject and
    object boxes (..., P, 4) of an image of ``image_size`` (..., 2) = (w, h):
    each box is resized onto the grid, and cell (y, x) is inside iff
    ``floor(x1) <= x <= ceil(x2)`` and ``floor(y1) <= y <= ceil(y2)``."""
    dev = head.device
    size = torch.tensor([rect_size, rect_size], dtype=torch.float32, device=dev)
    grid = torch.arange(rect_size, dtype=torch.float32, device=dev)
    xs, ys = grid[None, None, :], grid[None, :, None]

    def one(b):
        b = resize_boxes(b, image_size.float(), size)
        x1, y1 = torch.floor(b[..., 0])[..., None, None], torch.floor(b[..., 1])[..., None, None]
        x2, y2 = torch.ceil(b[..., 2])[..., None, None], torch.ceil(b[..., 3])[..., None, None]
        return ((xs >= x1) & (xs <= x2) & (ys >= y1) & (ys <= y2)).float()

    return torch.stack([one(head), one(tail)], dim=-1)


class UnionFeatureExtractor(nn.Module):
    """Union pooling, the rect conv stack and fc6 / fc7 → (B, P, mlp_dim) in
    the model's dtype."""

    def __init__(self, pooler_resolution: int = 7,
                 pooler_scales: Sequence[float] = (0.25, 0.125, 0.0625, 0.03125),
                 pooler_sampling_ratio: int = 2, mlp_dim: int = 4096,
                 in_channels: int = 256, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.resolution = pooler_resolution
        self.scales = tuple(pooler_scales)
        self.sampling = pooler_sampling_ratio
        self.dtype = dtype
        half = in_channels // 2
        self.rect_conv1 = Conv2d(2, half, 7, stride=2, padding=3)
        self.rect_bn1 = BatchNorm2d(half, momentum=0.99)
        self.rect_conv2 = Conv2d(half, in_channels, 3, padding=1)
        self.rect_bn2 = BatchNorm2d(in_channels, momentum=0.99)
        self.fc6 = Dense(pooler_resolution ** 2 * in_channels, mlp_dim, dtype=dtype)
        self.fc7 = Dense(mlp_dim, mlp_dim, dtype=dtype)

    def rect_features(self, head: torch.Tensor, tail: torch.Tensor,
                      image_sizes: torch.Tensor) -> torch.Tensor:
        """The conv stack on the pairs' rectangles: (B, P, R, R, C) NHWC."""
        rs = self.resolution * 4 - 1
        rects = rect_masks(head, tail, image_sizes, rs)  # (B, P, rs, rs, 2)
        b, p = rects.shape[:2]
        x = rects.reshape(b * p, rs, rs, 2).permute(0, 3, 1, 2).to(self.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        x = self.rect_bn1(F.relu(self.rect_conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf
        x = self.rect_bn2(F.relu(self.rect_conv2(x)))
        return x.permute(0, 2, 3, 1).reshape(b, p, *x.shape[2:], x.shape[1])

    def forward(self, feats, boxes: torch.Tensor, pair_idx: torch.Tensor,
                image_sizes: torch.Tensor) -> torch.Tensor:
        ub, head, tail = union_boxes(boxes, pair_idx)
        levels = [f.contiguous() for f in tuple(feats)[: len(self.scales)]]
        pooled = multilevel_roi_align_batched(levels, ub, self.scales,
                                              self.resolution, self.sampling)
        x = pooled.to(self.dtype) + self.rect_features(head, tail, image_sizes)
        y = F.relu(self.fc6(x.reshape(x.shape[:2] + (-1,))))
        return F.relu(self.fc7(y))
