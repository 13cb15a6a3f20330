"""The ROI keypoint head (``veto_tpu/models/detector/keypoint_head.py``;
``model.keypoint_on``): convolutions, the transposed-convolution
predictor, the loss and the host-side decoding, batched over images.

  * :class:`KeypointFeatureExtractor`: eight 3x3 convolutions of 512 with
    ReLU over the (R, P, P, C) pool (P = ``model.keypoint_pooler_resolution``,
    14);
  * :class:`KeypointPredictor`: ``kps_score_lowres``, a 4x4 stride-2
    transposed convolution (flax "SAME": 2 rows of padding each side of the
    dilated input, torch's ``padding=1``) to K heatmaps, then a 2x bilinear
    upsample (``align_corners=False``) in f32: (R, 4P, 4P, K);
  * :func:`keypoint_loss`: each keypoint's cell on its roi's heatmap grid
    (:func:`~...structures.keypoints.keypoints_to_heat_map`), then the
    cross-entropy of the spatial softmax over the valid (roi, keypoint)
    pairs;
  * :func:`heatmaps_to_keypoints` (host numpy): each roi's heatmaps resized
    bicubically to the roi's extent, the argmax per keypoint.  The resize
    is the port's own (:func:`cubic_resize`), written to OpenCV's
    ``INTER_CUBIC`` on f32 maps, which the JAX package calls: the port
    needs no OpenCV.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...structures.keypoints import keypoints_to_heat_map
from ..layers import Conv2d, ConvTranspose2d
from .mask_head import nchw, nhwc


class KeypointFeatureExtractor(nn.Module):
    """``conv_fcn{i}``: 3x3 convolutions with ReLU in ``dtype``:
    (R, P, P, C_in) → (R, P, P, conv_layers[-1])."""

    def __init__(self, in_channels: int,
                 conv_layers: Sequence[int] = tuple(512 for _ in range(8)),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        for i, ch in enumerate(conv_layers, 1):
            setattr(self, f"conv_fcn{i}", Conv2d(in_channels, ch, 3, padding=1))
            in_channels = ch
        self.num_layers = len(conv_layers)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = nchw(pooled.to(self.dtype))
        for i in range(1, self.num_layers + 1):
            x = F.relu(getattr(self, f"conv_fcn{i}")(x))
        return nhwc(x)


def upsample_bilinear_2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2x bilinear upsample with half-pixel centres (``align_corners=
    False``; ``jax.image.resize`` "bilinear" computes the same weights)."""
    return nhwc(F.interpolate(nchw(x), scale_factor=2, mode="bilinear",
                              align_corners=False))


class KeypointPredictor(nn.Module):
    """``kps_score_lowres`` (4x4, stride 2, transposed) in ``dtype`` to
    ``num_keypoints`` maps, then the f32 2x upsample: (R, P, P, C_in) →
    (R, 4P, 4P, K) f32."""

    def __init__(self, in_channels: int, num_keypoints: int = 17,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kps_score_lowres = ConvTranspose2d(in_channels, num_keypoints, 4,
                                                stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.kps_score_lowres(nchw(x.to(self.dtype)))
        return upsample_bilinear_2x(nhwc(x.float()))


class KeypointLossOut(NamedTuple):
    loss: torch.Tensor       # (B,) each image's mean over its valid keypoints
    num_valid: torch.Tensor  # (B,)


def keypoint_loss(kp_logits: torch.Tensor, keypoints: torch.Tensor,
                  boxes: torch.Tensor, pos: torch.Tensor) -> KeypointLossOut:
    """Per image: (B, P, S, S, K) heatmap logits, (B, P, K, 3) matched GT
    keypoints in the image frame, (B, P, 4) rois and (B, P) positive rois →
    the mean over the valid (positive roi, visible keypoint on the grid)
    pairs of the cross-entropy of the S x S softmax at the keypoint's cell
    (0 where an image has none)."""
    b, p, s, _, k = kp_logits.shape
    targets, valid = keypoints_to_heat_map(keypoints, boxes, s)
    valid = valid.bool() & pos[..., None]
    logits = kp_logits.float().reshape(b, p, s * s, k).transpose(-1, -2)
    logp = torch.log_softmax(logits, dim=-1)  # (B, P, K, S * S)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    num_valid = valid.sum((-2, -1))
    loss = torch.where(valid, nll, 0.0).sum((-2, -1)) / torch.clamp(num_valid, min=1)
    return KeypointLossOut(torch.where(num_valid > 0, loss, 0.0), num_valid)


def _cubic_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The four source indices (clamped: a replicated border) and f32
    weights of each output pixel of a cubic resize from ``in_size`` to
    ``out_size``: half-pixel centres, the source position rounded to f32,
    and the cubic convolution kernel with a = -0.75, in OpenCV's f32
    arithmetic."""
    scale = 1.0 / (out_size / in_size)
    fx = ((np.arange(out_size) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx)
    x = (fx - sx).astype(np.float32)
    a = np.float32(-0.75)
    one = np.float32(1)
    x1 = x + one
    c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + one
    y = one - x
    c2 = ((a + 2) * y - (a + 3)) * y * y + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(sx.astype(np.int64)[:, None] + np.arange(-1, 3), 0, in_size - 1)
    return idx, np.stack([c0, c1, c2, c3], 1).astype(np.float32)


def cubic_resize(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) f32 → (h, w, C) bicubic resize: rows first, each output the
    left-to-right f32 sum of its four weighted taps, then columns."""
    img = np.asarray(img, np.float32)
    oh, ow = out_hw
    ix, wx = _cubic_taps(img.shape[1], ow)
    tmp = img[:, ix[:, 0]] * wx[None, :, 0, None]
    for j in range(1, 4):
        tmp = tmp + img[:, ix[:, j]] * wx[None, :, j, None]
    iy, wy = _cubic_taps(img.shape[0], oh)
    out = tmp[iy[:, 0]] * wy[:, 0, None, None]
    for j in range(1, 4):
        out = out + tmp[iy[:, j]] * wy[:, j, None, None]
    return out


def heatmaps_to_keypoints(maps: np.ndarray,
                          rois: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(D, K, S, S) heatmaps and (D, 4) rois → ((D, K, 3) [x, y, 1] keypoints,
    (D, K) scores), host numpy: each roi's maps resized bicubically to its
    extent rounded up, the argmax of each keypoint's map, mapped back to the
    image at the cell's centre (+0.5) scaled by extent / rounded extent."""
    maps = np.asarray(maps, np.float32)
    offset_x, offset_y = rois[:, 0], rois[:, 1]
    widths = np.maximum(rois[:, 2] - rois[:, 0], 1)
    heights = np.maximum(rois[:, 3] - rois[:, 1], 1)
    widths_ceil, heights_ceil = np.ceil(widths), np.ceil(heights)

    maps = np.transpose(maps, [0, 2, 3, 1])
    num_k = maps.shape[3]
    xy_preds = np.zeros((len(rois), 3, num_k), np.float32)
    end_scores = np.zeros((len(rois), num_k), np.float32)
    for i in range(len(rois)):
        rw, rh = int(widths_ceil[i]), int(heights_ceil[i])
        roi_map = np.transpose(cubic_resize(maps[i], (rh, rw)), [2, 0, 1])
        w = roi_map.shape[2]
        pos = roi_map.reshape(num_k, -1).argmax(axis=1)
        x_int = pos % w
        y_int = (pos - x_int) // w
        xy_preds[i, 0] = (x_int + 0.5) * (widths[i] / rw) + offset_x[i]
        xy_preds[i, 1] = (y_int + 0.5) * (heights[i] / rh) + offset_y[i]
        xy_preds[i, 2] = 1
        end_scores[i] = roi_map[np.arange(num_k), y_int, x_int]
    return np.transpose(xy_preds, [0, 2, 1]), end_scores
