"""Mask resampling (``veto_tpu/structures/masks.py``): only
:func:`bilinear_resize`, which :func:`~..models.detector.mask_head.paste_mask_in_image`
uses.  The JAX package's mask containers (``BinaryMaskList``,
``PolygonList``, ``SegmentationMask``) serve none of its paths and are not
ported yet (ROADMAP A14)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def bilinear_resize(arr: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(N, H, W) → (N, h, w) bilinear resample with half-pixel centres and
    clamped edges (torch's ``interpolate(mode="bilinear",
    align_corners=False)``), host numpy, f32 weights."""
    arr = np.asarray(arr, np.float32)
    n, h, w = arr.shape
    oh, ow = out_hw
    ys = (np.arange(oh, dtype=np.float64) + 0.5) * (h / oh) - 0.5
    xs = (np.arange(ow, dtype=np.float64) + 0.5) * (w / ow) - 0.5
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)
    wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)
    top = arr[:, y0][:, :, x0] * (1 - wx) + arr[:, y0][:, :, x1] * wx
    bot = arr[:, y1][:, :, x0] * (1 - wx) + arr[:, y1][:, :, x1] * wx
    return top * (1 - wy)[None, :, None] + bot * wy[None, :, None]
