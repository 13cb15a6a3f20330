"""ROIAlign and the FPN level mapper, plain PyTorch.

Port of ``veto_tpu/ops/roi_align.py``, which reproduces the reference CUDA
kernel (``ROIAlign_cuda.cu``) and ``Pooler`` (``poolers.py``):

  * roi coords scaled by ``spatial_scale`` with no -0.5 offset;
  * ``roi_w = max(x2 - x1, 1)`` — degenerate rois count as 1 px;
  * each P×P bin averages ``sampling_ratio²`` bilinear samples;
  * the CUDA border rule: a sample with y < -1 or y > H (x likewise)
    contributes 0, otherwise the coordinate clamps to >= 0 and snaps onto
    the last pixel when its floor reaches it.

This is the gather formulation — each sample reads its four taps — and is
the plain version the CUDA kernel (``ops/roi_align_windowed.py``) is held
against.  Feature maps are NHWC; the result is f32 whatever the map dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .box_ops import box_area


def _sample_coords(rois: torch.Tensor, scale: float, p: int, s: int):
    """Per-bin sample coordinates (R, p, s) along y and x, in the JAX
    package's arithmetic order: ``y1 + (bin + (iy + 0.5) / s) * bin_h``.

    The divisors are tensors: PyTorch's CUDA division by a Python scalar
    multiplies by its rounded reciprocal, which for p = 7 moves bin sizes
    by an ulp; a tensor divisor divides on every device, as the JAX package
    and the kernels do."""
    x1, y1, x2, y2 = (rois.float() * scale).unbind(-1)
    p_, s_ = (torch.tensor(float(v), device=rois.device) for v in (p, s))
    bin_w = torch.clamp(x2 - x1, min=1.0) / p_
    bin_h = torch.clamp(y2 - y1, min=1.0) / p_
    off = (torch.arange(s, dtype=torch.float32, device=rois.device) + 0.5) / s_
    bins = torch.arange(p, dtype=torch.float32, device=rois.device)
    grid = bins[:, None] + off[None, :]                        # (p, s)
    ys = y1[:, None, None] + grid[None] * bin_h[:, None, None]
    xs = x1[:, None, None] + grid[None] * bin_w[:, None, None]
    return ys, xs


def _bilinear_gather(feat: torch.Tensor, bidx: torch.Tensor,
                     y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of feat (B, H, W, C) at (bidx, y, x), all shaped
    (...,) → (..., C) f32, with the CUDA kernel's border rules."""
    h, w = feat.shape[1], feat.shape[2]
    oob = (y < -1.0) | (y > h) | (x < -1.0) | (x > w)
    y = y.clamp(min=0.0)
    x = x.clamp(min=0.0)
    y_low = torch.clamp(torch.floor(y), max=h - 1.0)
    x_low = torch.clamp(torch.floor(x), max=w - 1.0)
    y_high = torch.clamp(y_low + 1.0, max=h - 1.0)
    x_high = torch.clamp(x_low + 1.0, max=w - 1.0)
    y = torch.where(y_low >= h - 1.0, y_low, y)
    x = torch.where(x_low >= w - 1.0, x_low, x)
    ly = y - y_low
    lx = x - x_low
    hy, hx = 1.0 - ly, 1.0 - lx
    yl, xl, yh, xh = (t.long() for t in (y_low, x_low, y_high, x_high))

    def tap(yy, xx):
        return feat[bidx, yy, xx].float()

    out = ((hy * hx)[..., None] * tap(yl, xl)
           + (hy * lx)[..., None] * tap(yl, xh)
           + (ly * hx)[..., None] * tap(yh, xl)
           + (ly * lx)[..., None] * tap(yh, xh))
    return torch.where(oob[..., None], torch.zeros((), device=out.device), out)


def _pool(feat: torch.Tensor, bidx: torch.Tensor, rois: torch.Tensor,
          scale, p: int, s: int) -> torch.Tensor:
    """Pool rois (n, 4) of images ``bidx`` (n,) from feat (B, H, W, C) →
    (n, p, p, C) f32."""
    n = rois.shape[0]
    ys, xs = _sample_coords(rois, scale, p, s)                 # (n, p, s)
    yy = ys[:, :, :, None, None].expand(n, p, s, p, s)
    xx = xs[:, None, None, :, :].expand(n, p, s, p, s)
    bb = bidx[:, None, None, None, None].expand(n, p, s, p, s)
    vals = _bilinear_gather(feat, bb, yy, xx)                  # (n,p,s,p,s,C)
    return vals.mean(dim=(2, 4))


def fpn_level_assignment(rois: torch.Tensor, k_min: int = 2, k_max: int = 5,
                         canonical_scale: int = 224,
                         canonical_level: int = 4,
                         eps: float = 1e-6) -> torch.Tensor:
    """FPN eq. 1 level mapper (poolers.py LevelMapper): 0-based level
    indices in [0, k_max - k_min], int32."""
    s = torch.sqrt(box_area(rois.float()))
    target = torch.floor(canonical_level + torch.log2(s / canonical_scale + eps))
    return (target.clamp(k_min, k_max) - k_min).to(torch.int32)


def roi_align(features: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
              output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign one (H, W, C) map at rois (R, 4) → (R, P, P, C) f32."""
    if sampling_ratio <= 0:
        raise ValueError("adaptive sampling_ratio not supported; configs use 2")
    bidx = torch.zeros(rois.shape[0], dtype=torch.long, device=rois.device)
    return _pool(features[None], bidx, rois, spatial_scale, output_size,
                 sampling_ratio)


def pool_levels(features: Sequence[torch.Tensor], rois: torch.Tensor,
                levels: torch.Tensor, scales: Sequence[float],
                output_size: int, sampling_ratio: int) -> torch.Tensor:
    """Pool every roi from its level: features per level (B, H_l, W_l, C),
    rois (B, R, 4), levels (B, R) → (B, R, P, P, C) f32."""
    b, r = rois.shape[:2]
    p, c = output_size, features[0].shape[-1]
    flat = rois.reshape(b * r, 4).float()
    lv = levels.reshape(-1).long()
    bidx = torch.arange(b, device=rois.device).repeat_interleave(r)
    out = torch.zeros((b * r, p, p, c), dtype=torch.float32, device=rois.device)
    for lvl, (feat, scale) in enumerate(zip(features, scales)):
        sel = torch.nonzero(lv == lvl).squeeze(1)
        if sel.numel():
            out[sel] = _pool(feat, bidx[sel], flat[sel], scale, p,
                             sampling_ratio)
    return out.reshape(b, r, p, p, c)


def multilevel_roi_align(features: Sequence[torch.Tensor], rois: torch.Tensor,
                         scales: Sequence[float], output_size: int,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """Pool each roi (R, 4) from its assigned FPN level, maps (H_l, W_l, C)
    finest first → (R, P, P, C) f32."""
    if sampling_ratio <= 0:
        raise ValueError("adaptive sampling_ratio not supported; configs use 2")
    levels = fpn_level_assignment(rois)
    return pool_levels([f[None] for f in features], rois[None], levels[None],
                       scales, output_size, sampling_ratio)[0]
