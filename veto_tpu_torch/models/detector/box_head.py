"""The frozen detector's box head (``veto_tpu/models/detector/box_head.py``
``BoxFeatureExtractor`` and ``BoxPredictor``; the reference's
FPN2MLPFeatureExtractor and FPNPredictor).

The pooled map arrives NHWC, (..., P, P, C), and is flattened in that
order, as in the JAX package: a reference ``fc6`` (which flattens NCHW)
is permuted to it on import (``utils/torch_import.py``).  fc6 and fc7 run
in the model's dtype; ``cls_score`` and ``bbox_pred`` in f32 on the
features cast to f32, as flax's ``Dense(dtype=float32)`` promotes them.
Label assignment to proposals and the box post-processing come with SGDet
(slice A10).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Dense


class BoxFeatureExtractor(nn.Module):
    """fc6 / fc7 with ReLU over the flattened pooled map: (..., P, P, C) →
    (..., mlp_dim)."""

    def __init__(self, in_features: int, mlp_dim: int = 4096,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.fc6 = Dense(in_features, mlp_dim, dtype=dtype)
        self.fc7 = Dense(mlp_dim, mlp_dim, dtype=dtype)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = pooled.reshape(pooled.shape[:-3] + (-1,))
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class BoxPredictor(nn.Module):
    """Class logits and per-class box deltas, both f32."""

    def __init__(self, in_features: int = 4096, num_classes: int = 151):
        super().__init__()
        self.cls_score = Dense(in_features, num_classes, dtype=torch.float32)
        self.bbox_pred = Dense(in_features, num_classes * 4, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cls_score(x), self.bbox_pred(x)
