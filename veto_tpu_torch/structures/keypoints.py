"""Keypoint targets (``veto_tpu/structures/keypoints.py``): only
:func:`keypoints_to_heat_map`, which the keypoint loss uses.  The
``Keypoints`` / ``PersonKeypoints`` containers serve none of the JAX
package's paths and are not ported yet (ROADMAP A14)."""

from __future__ import annotations

from typing import Tuple

import torch


def keypoints_to_heat_map(keypoints: torch.Tensor, rois: torch.Tensor,
                          heatmap_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K, 3) keypoints and (..., 4) rois → the (..., K) linear index of
    each keypoint's cell on the roi's ``heatmap_size`` grid (0 where
    invalid) and its (..., K) validity (int64).

    The cell is the floor of the keypoint's offset in the roi times
    ``heatmap_size / extent``; a keypoint exactly on the roi's right (lower)
    edge snaps to the last cell; a keypoint off the grid or not visible
    (v = 0) is invalid."""
    rois = rois.float()
    offset_x = rois[..., 0:1]
    offset_y = rois[..., 1:2]
    scale_x = heatmap_size / (rois[..., 2:3] - rois[..., 0:1])
    scale_y = heatmap_size / (rois[..., 3:4] - rois[..., 1:2])
    x, y = keypoints[..., 0], keypoints[..., 1]
    x_boundary = x == rois[..., 2:3]
    y_boundary = y == rois[..., 3:4]
    xh = torch.floor((x - offset_x) * scale_x).long()
    yh = torch.floor((y - offset_y) * scale_y).long()
    xh = torch.where(x_boundary, heatmap_size - 1, xh)
    yh = torch.where(y_boundary, heatmap_size - 1, yh)
    valid_loc = (xh >= 0) & (yh >= 0) & (xh < heatmap_size) & (yh < heatmap_size)
    valid = (valid_loc & (keypoints[..., 2] > 0)).long()
    return (yh * heatmap_size + xh) * valid, valid
