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
    """BatchNorm with flax's arithmetic: ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias`` in f32, cast to the input dtype.

    Eval: the running statistics.  Training (flax
    ``use_running_average=False``): the batch statistics over (N, H, W),
    computed in f32 with flax's fast variance ``max(E[x^2] - E[x]^2, 0)``,
    gradients flowing through them; the running statistics become
    ``0.9 running + 0.1 batch``, the biased batch variance included (torch's
    own ``F.batch_norm`` would store the unbiased one).  ``momentum=0.1`` is
    torch's name for flax's ``momentum=0.9``.
    """

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            keep = 1.0 - self.momentum
            with torch.no_grad():
                self.running_mean.copy_(keep * self.running_mean
                                        + (1.0 - keep) * mean)
                self.running_var.copy_(keep * self.running_var
                                       + (1.0 - keep) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)
