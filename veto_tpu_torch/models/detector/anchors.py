"""FPN anchor generation (a copy of ``veto_tpu/models/detector/anchors.py``).

The port keeps its own copy so that it loads no module of the JAX package;
the functions are NumPy and identical to the original.

Re-design of the reference AnchorGenerator
(pysgg/modeling/rpn/anchor_generator.py:34-289): the classic
Faster-R-CNN/caffe2 anchor recipe — a (0,0,stride-1,stride-1) base window,
rounded ratio enumeration, scale enumeration — evaluated in NumPy once
per padded image size (the model caches them on its device), then
broadcast over the feature grid.  Per-level: one size, A aspect ratios, stride-spaced centers.

The reference builds BoxLists with a ``visibility`` field from
``straddle_thresh``; here visibility is a mask computed against the static
padded image size (straddle_thresh=0 ⇒ anchors fully inside the image).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _whctrs(anchor: np.ndarray):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    return w, h, anchor[0] + 0.5 * (w - 1), anchor[1] + 0.5 * (h - 1)


def _mkanchors(ws, hs, x_ctr, y_ctr) -> np.ndarray:
    ws, hs = ws[:, None], hs[:, None]
    return np.hstack(
        (
            x_ctr - 0.5 * (ws - 1),
            y_ctr - 0.5 * (hs - 1),
            x_ctr + 0.5 * (ws - 1),
            y_ctr + 0.5 * (hs - 1),
        )
    )


def generate_cell_anchors(
    stride: int, size, aspect_ratios: Sequence[float]
) -> np.ndarray:
    """Anchors for one level, centered on the (0, 0) cell.

    Matches reference ``generate_anchors(stride, sizes, ratios)``
    (anchor_generator.py:220-249): ratio enumeration uses the rounded
    sqrt-area rule on the (stride × stride) base window, then scale
    enumeration by size/stride.  ``size`` may be a scalar (FPN: one size
    per level) or a tuple (non-FPN single-level RPN, e.g. VGG-16: all of
    ANCHOR_SIZES on the stride-16 grid, defaults.py:152-155).  Anchor
    order is ratio-major / size-fastest, matching ``_scale_enum``.

    Returns: (len(ratios) * len(sizes), 4) float32 xyxy.
    """
    sizes = (size,) if np.isscalar(size) else tuple(size)
    base = np.array([0.0, 0.0, stride - 1.0, stride - 1.0])
    w, h, xc, yc = _whctrs(base)
    area = w * h
    ratios = np.asarray(aspect_ratios, dtype=np.float64)
    ws = np.round(np.sqrt(area / ratios))
    hs = np.round(ws * ratios)
    ratio_anchors = _mkanchors(ws, hs, xc, yc)
    scales = np.array([float(s) / float(stride) for s in sizes])
    out = []
    for a in ratio_anchors:
        w, h, xc, yc = _whctrs(a)
        out.append(_mkanchors(w * scales, h * scales, xc, yc))
    return np.vstack(out).astype(np.float32)


def grid_anchors(
    feat_hw: Tuple[int, int],
    stride: int,
    cell_anchors: np.ndarray,
) -> np.ndarray:
    """Tile cell anchors over an H×W feature grid (grid_anchors :73-96).

    Returns: (H*W*A, 4) float32 — row-major over (y, x, anchor), the same
    flattening order as the reference's permute_and_flatten(N, A, H, W) →
    (H, W, A) ... note the reference orders (H, W, A) after permute, i.e.
    anchor index fastest; we match that so objectness channels line up.
    """
    h, w = feat_hw
    shift_x = np.arange(w, dtype=np.float32) * stride
    shift_y = np.arange(h, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)  # (h, w)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)  # (h*w, 1, 4)
    anchors = shifts + cell_anchors[None]  # (h*w, A, 4)
    return anchors.reshape(-1, 4)


def anchor_visibility(
    anchors: np.ndarray, image_hw: Tuple[int, int], straddle_thresh: float = 0.0
) -> np.ndarray:
    """Anchors fully inside the (padded) image (anchor_generator.py:97-111).

    straddle_thresh < 0 marks everything visible.
    """
    if straddle_thresh < 0:
        return np.ones((anchors.shape[0],), dtype=bool)
    h, w = image_hw
    return (
        (anchors[:, 0] >= -straddle_thresh)
        & (anchors[:, 1] >= -straddle_thresh)
        & (anchors[:, 2] < w + straddle_thresh)
        & (anchors[:, 3] < h + straddle_thresh)
    )


def fpn_anchors(
    image_hw: Tuple[int, int],
    sizes: Sequence[int] = (32, 64, 128, 256, 512),
    strides: Sequence[int] = (4, 8, 16, 32, 64),
    aspect_ratios: Sequence[float] = (0.23232838, 0.63365731, 1.28478321, 3.15089189),
    straddle_thresh: float = 0.0,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """All-level anchors for a padded image size.

    Returns a list of (anchors (H_l*W_l*A, 4), visibility (H_l*W_l*A,))
    per level, with H_l = ceil(H / stride_l) matching conv feature sizes.
    """
    out = []
    h, w = image_hw
    for size, stride in zip(sizes, strides):
        fh, fw = -(-h // stride), -(-w // stride)
        a = grid_anchors((fh, fw), stride, generate_cell_anchors(stride, size, aspect_ratios))
        out.append((a, anchor_visibility(a, image_hw, straddle_thresh)))
    return out
