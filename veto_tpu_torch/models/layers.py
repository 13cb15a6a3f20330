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


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in the input's dtype (NCHW, any
    memory format).  Its weight is (in, out, kh, kw), the true transpose of
    a convolution; flax's ``ConvTranspose`` kernel is the same map spatially
    flipped (``utils/jax_weights.py`` converts)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


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
    ``momentum * running + (1 - momentum) * batch``, the biased batch
    variance included (torch's own ``F.batch_norm`` would store the
    unbiased one).  ``momentum`` is flax's (the kept share, default 0.9);
    torch's attribute of that name holds ``1 - momentum``.

    Under data parallelism (``dp``, a ``distributed.DataParallel`` that
    ``distributed.attach`` sets) the training statistics are the global
    batch's: the f32 sums and the count are all-reduced, the gradient
    flowing back through the reduction, and flax's arithmetic is applied
    to the global sums (``nn.SyncBatchNorm``'s Welford merge and unbiased
    running variance are not flax's).
    """

    dp = None

    def __init__(self, features: int, momentum: float = 0.9):
        super().__init__(features, eps=1e-5, momentum=1.0 - momentum)
        self.keep = momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _flax_batch_norm(self, x, (0, 2, 3), (-1, 1, 1))


class BatchNorm1d(nn.BatchNorm1d):
    """:class:`BatchNorm2d`'s arithmetic over the last axis of (..., F): in
    training the statistics of every row of every leading axis, padded rows
    included, as flax's ``BatchNorm`` takes them (the global batch's under
    ``dp``)."""

    dp = None

    def __init__(self, features: int, momentum: float = 0.9):
        super().__init__(features, eps=1e-5, momentum=1.0 - momentum)
        self.keep = momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _flax_batch_norm(self, x, tuple(range(x.dim() - 1)), (-1,))


def _flax_batch_norm(bn, x: torch.Tensor, dims, view) -> torch.Tensor:
    xf = x.float()
    if bn.training:
        if bn.dp is None:
            mean = xf.mean(dim=dims)
            var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
        else:
            mean, var = _global_moments(bn.dp, xf, dims)
        keep = bn.keep
        with torch.no_grad():
            bn.running_mean.copy_(keep * bn.running_mean + (1.0 - keep) * mean)
            bn.running_var.copy_(keep * bn.running_var + (1.0 - keep) * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean.view(view)) * mul.view(view)
    return (y + bn.bias.view(view)).to(x.dtype)


def _global_moments(dp, xf: torch.Tensor, dims):
    """The mean and flax's fast variance ``max(E[x^2] - E[x]^2, 0)`` of
    ``xf`` over ``dims`` of every rank's batch: Σx, Σx² and the count in one
    all-reduce whose backward all-reduces the gradient."""
    count = 1
    for d in dims:
        count *= xf.shape[d]
    s1, s2 = xf.sum(dim=dims), (xf * xf).sum(dim=dims)
    sums = dp.sum(torch.cat([s1, s2, s1.new_full((1,), float(count))]))
    c = s1.shape[0]
    n = sums[2 * c]
    mean = sums[:c] / n
    return mean, torch.clamp(sums[c: 2 * c] / n - mean * mean, min=0.0)


class LayerNorm(nn.Module):
    """flax's ``LayerNorm`` (epsilon 1e-6) over the last axis: statistics in
    f32 with the fast variance ``max(E[x^2] - E[x]^2, 0)``, ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in f32, cast to the input dtype."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(x.dtype)
