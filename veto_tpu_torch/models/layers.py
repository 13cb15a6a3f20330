"""Layers that keep f32 parameters and compute in the input's dtype.

The JAX package holds every parameter in f32 and casts it to the compute
dtype (bf16 on the main path) where it is used; these layers do the same,
so one state dict serves f32 and bf16 runs alike.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in the input's dtype (NCHW, any memory format)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class Dense(nn.Linear):
    """``nn.Linear`` computing in a fixed dtype (flax ``nn.Dense(dtype=)``):
    input, weight and bias are cast to ``dtype`` first."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class BatchNorm2d(nn.BatchNorm2d):
    """Inference BatchNorm with flax's arithmetic: ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in f32, cast to the input dtype.

    ``momentum=0.1`` is torch's name for flax's ``momentum=0.9``.  Only the
    eval form is ported in this slice (the depth backbone trains its BN in
    the training slice).
    """

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("BatchNorm training comes with the "
                                      "training slice")
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)
