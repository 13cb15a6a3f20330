"""The VGG-16 single-scale detector body (``veto_tpu/models/backbone/vgg.py``).

torchvision's ``vgg16.features`` with the last max-pool deleted and, as
the reference's ``[:-1]`` slice does, the ReLU after the last conv (index
28) dropped too: 13 3x3 convs (pad 1) and 4 2x2/2 max-pools, ending on
conv5_3's pre-activation.  Output: one NHWC (B, H/16, W/16, 512) map, the
single level of the non-FPN detector (every anchor size on one stride-16
grid, 1/16 ROIAlign; ``models/sgg.py``).

Like the ResNet body it computes in NCHW on channels-last tensors (the
NHWC boundary is a view both ways), in the model's dtype, with f32
parameters cast where used (:class:`~..layers.Conv2d`).  Its convs are
named ``conv{idx}`` after the torchvision index, as in the flax tree, so
``utils/jax_weights.py`` and ``utils/torch_import.py`` map both weight
sources by name.  The JAX package runs it with XLA, outside Pallas; the
port with cuDNN.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d

# (torchvision features index, out channels) of the 13 convs
VGG16_CONVS = ((0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256),
               (14, 256), (17, 512), (19, 512), (21, 512), (24, 512), (26, 512),
               (28, 512))
POOL_AFTER = (2, 7, 14, 21)  # a 2x2/2 max-pool follows these convs
FINAL_CONV = 28  # no ReLU after it (the reference's [:-1] slice)
OUT_CHANNELS = 512


class VGG16Body(nn.Module):
    """NHWC images (B, H, W, 3) → a 1-tuple of the NHWC (B, H/16, W/16, 512)
    map (each pool floors an odd size)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        c_in = 3
        for idx, c_out in VGG16_CONVS:
            self.add_module(f"conv{idx}", Conv2d(c_in, c_out, 3, padding=1))
            c_in = c_out

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor]:
        x = images.to(self.dtype).permute(0, 3, 1, 2)  # channels-last NCHW
        for idx, _ in VGG16_CONVS:
            x = getattr(self, f"conv{idx}")(x)
            if idx != FINAL_CONV:
                x = F.relu(x)
            if idx in POOL_AFTER:
                x = F.max_pool2d(x, 2, 2)
        return (x.permute(0, 2, 3, 1),)
