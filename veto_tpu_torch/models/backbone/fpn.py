"""Feature Pyramid Network (``veto_tpu/models/backbone/fpn.py``), NCHW.

Lateral 1x1 convs, nearest x2 top-down merge (cropped to the lateral's
size), 3x3 output convs, and LastLevelMaxPool: P6 is P5 subsampled by 2
(a 1x1 max-pool with stride 2 is ``x[..., ::2, ::2]``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        self.num_levels = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"fpn_inner{i + 1}", Conv2d(c, out_channels, 1))
            self.add_module(f"fpn_layer{i + 1}",
                            Conv2d(out_channels, out_channels, 3, padding=1))

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """inputs: (C2..C5) finest first → (P2..P6)."""
        laterals = [getattr(self, f"fpn_inner{i + 1}")(c)
                    for i, c in enumerate(inputs)]
        merged = [laterals[-1]]
        for lat in reversed(laterals[:-1]):
            top = F.interpolate(merged[0], scale_factor=2, mode="nearest")
            merged.insert(0, lat + top[..., :lat.shape[2], :lat.shape[3]])
        outs = [getattr(self, f"fpn_layer{i + 1}")(m) for i, m in enumerate(merged)]
        return tuple(outs) + (outs[-1][..., ::2, ::2],)
