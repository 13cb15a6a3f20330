"""The ROI mask head (``veto_tpu/models/detector/mask_head.py``;
``model.mask_on``): the FCN extractor, the predictor, the loss and the
post-processing, batched over images with padded rois and masks.

  * :class:`MaskFeatureExtractor`: 3x3 convolutions with ReLU over the
    (R, P, P, C) pool (P = ``model.mask_pooler_resolution``, 14);
  * :class:`MaskPredictor`: ``conv5_mask``, a 2x2 stride-2 transposed
    convolution with ReLU, then the 1x1 ``mask_fcn_logits`` in f32:
    (R, 2P, 2P, num_classes) logits;
  * :func:`project_masks_on_boxes` crops each roi's matched GT mask and
    resamples it to M x M (the reference's crop, then a bilinear resize
    with ``align_corners=False``), as one gather;
  * :func:`mask_loss`: BCE with logits of the GT class's channel, averaged
    over the positive rois' M x M elements;
  * :func:`mask_postprocess` and the host-side pasting into the image
    (:func:`paste_masks_in_image`, numpy).

The modules take and return NHWC tensors, as the JAX package's; the
convolutions run on their NCHW views (channels-last memory, no copy).
The GT masks arrive as uint8 0/1 and are widened to f32 only at the
gather.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, ConvTranspose2d


def nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor's NCHW view (channels-last memory)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """An NCHW tensor's NHWC view."""
    return x.permute(0, 2, 3, 1)


class MaskFeatureExtractor(nn.Module):
    """``mask_fcn{i}``: 3x3 convolutions (dilation ``dilation``) with ReLU
    in ``dtype``: (R, P, P, C_in) → (R, P, P, conv_layers[-1])."""

    def __init__(self, in_channels: int,
                 conv_layers: Sequence[int] = (256, 256, 256, 256),
                 dilation: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        for i, ch in enumerate(conv_layers, 1):
            setattr(self, f"mask_fcn{i}", Conv2d(in_channels, ch, 3,
                                                 padding=dilation,
                                                 dilation=dilation))
            in_channels = ch
        self.num_layers = len(conv_layers)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = nchw(pooled.to(self.dtype))
        for i in range(1, self.num_layers + 1):
            x = F.relu(getattr(self, f"mask_fcn{i}")(x))
        return nhwc(x)


class MaskPredictor(nn.Module):
    """``conv5_mask`` (2x2, stride 2, transposed) with ReLU in ``dtype``,
    then ``mask_fcn_logits`` (1x1) in f32: (R, P, P, C_in) → (R, 2P, 2P,
    num_classes) f32."""

    def __init__(self, in_channels: int, num_classes: int = 151,
                 dim_reduced: int = 256, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv5_mask = ConvTranspose2d(in_channels, dim_reduced, 2, stride=2)
        self.mask_fcn_logits = Conv2d(dim_reduced, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv5_mask(nchw(x.to(self.dtype))))
        return nhwc(self.mask_fcn_logits(x.float()))


class MaskConv1x1Predictor(nn.Module):
    """Logits at the pooled resolution, no upsampling: ``mask_fcn_logits``
    (1x1) in f32, (R, P, P, C_in) → (R, P, P, num_classes)."""

    def __init__(self, in_channels: int, num_classes: int = 151):
        super().__init__()
        self.mask_fcn_logits = Conv2d(in_channels, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nhwc(self.mask_fcn_logits(nchw(x.float())))


def project_masks_on_boxes(gt_masks: torch.Tensor, matched_gt: torch.Tensor,
                           boxes: torch.Tensor, resolution: int) -> torch.Tensor:
    """(B, T, H, W) GT masks (uint8 0/1, or float), (B, P) matched GT index
    and (B, P, 4) xyxy rois → (B, P, M, M) f32 targets.

    Per roi: the crop of the reference (each coordinate rounded half to
    even, the min clamped to [0, dim - 1] and the max to [0, dim], at
    least one pixel wide), resampled to M x M at half-pixel centres
    (``align_corners=False``) with the sample positions clamped at the
    crop's edges; both as one gather of the four neighbours."""
    b, t, h, w = gt_masks.shape
    m = resolution
    box = boxes.float()
    xmin = torch.clamp(torch.round(box[..., 0]), 0, w - 1)
    ymin = torch.clamp(torch.round(box[..., 1]), 0, h - 1)
    xmax = torch.maximum(torch.clamp(torch.round(box[..., 2]), 0, w), xmin + 1)
    ymax = torch.maximum(torch.clamp(torch.round(box[..., 3]), 0, h), ymin + 1)
    cw, ch = (xmax - xmin)[..., None], (ymax - ymin)[..., None]  # (B, P, 1)
    grid = torch.arange(m, dtype=torch.float32, device=box.device) + 0.5
    ys = grid * (ch / m) - 0.5  # (B, P, M)
    xs = grid * (cw / m) - 0.5
    zero = torch.zeros((), device=box.device)
    y0 = torch.minimum(torch.maximum(torch.floor(ys), zero), ch - 1)
    x0 = torch.minimum(torch.maximum(torch.floor(xs), zero), cw - 1)
    y1 = torch.minimum(y0 + 1, ch - 1)
    x1 = torch.minimum(x0 + 1, cw - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)
    wx = torch.clamp(xs - x0, 0.0, 1.0)
    bi = torch.arange(b, device=box.device)[:, None, None, None]
    gi = torch.clamp(matched_gt.long(), 0, t - 1)[..., None, None]

    def gather(yy, xx):
        yi = torch.clamp((yy + ymin[..., None]).long(), 0, h - 1)[..., :, None]
        xi = torch.clamp((xx + xmin[..., None]).long(), 0, w - 1)[..., None, :]
        return gt_masks[bi, gi, yi, xi].float()

    wx_, wy_ = wx[..., None, :], wy[..., :, None]
    top = gather(y0, x0) * (1 - wx_) + gather(y0, x1) * wx_
    bot = gather(y1, x0) * (1 - wx_) + gather(y1, x1) * wx_
    return top * (1 - wy_) + bot * wy_


class MaskLossOut(NamedTuple):
    loss: torch.Tensor     # (B,) each image's mean over its positives
    num_pos: torch.Tensor  # (B,)


def mask_loss(mask_logits: torch.Tensor, labels: torch.Tensor,
              matched_gt: torch.Tensor, gt_masks: torch.Tensor,
              boxes: torch.Tensor, valid: torch.Tensor) -> MaskLossOut:
    """Per image: (B, P, M, M, C) logits, (B, P) matched labels (0 = bg) and
    GT index (-1 = none), (B, T, H, W) GT masks, (B, P, 4) rois, (B, P)
    live rois → the BCE with logits of each positive roi's GT-class
    channel against its projected mask, averaged over the positives'
    M x M elements (0 where an image has none)."""
    m = mask_logits.shape[2]
    pos = (labels > 0) & (matched_gt >= 0) & valid
    targets = project_masks_on_boxes(gt_masks, matched_gt, boxes, m)
    idx = labels.long()[..., None, None, None].expand(mask_logits.shape[:-1] + (1,))
    x = torch.gather(mask_logits, -1, idx)[..., 0].float()
    bce = torch.clamp(x, min=0) - x * targets + torch.log1p(torch.exp(-x.abs()))
    num_pos = pos.sum(-1)
    total = torch.where(pos[..., None, None], bce, 0.0).sum((-3, -2, -1))
    denom = torch.clamp(num_pos * m * m, min=1)
    return MaskLossOut(torch.where(num_pos > 0, total / denom, 0.0), num_pos)


def mask_postprocess(mask_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(..., M, M, C) logits and (...,) predicted labels → (..., M, M) f32
    sigmoid probabilities of each detection's class channel."""
    idx = labels.long()[..., None, None, None].expand(mask_logits.shape[:-1] + (1,))
    return torch.sigmoid(torch.gather(mask_logits.float(), -1, idx)[..., 0])


# ---------------------------------------------------- pasting, host numpy
def _expand_box(box: np.ndarray, scale: float) -> np.ndarray:
    w_half = (box[2] - box[0]) * 0.5 * scale
    h_half = (box[3] - box[1]) * 0.5 * scale
    x_c = (box[2] + box[0]) * 0.5
    y_c = (box[3] + box[1]) * 0.5
    return np.array([x_c - w_half, y_c - h_half, x_c + w_half, y_c + h_half])


def paste_mask_in_image(mask: np.ndarray, box: np.ndarray, im_h: int, im_w: int,
                        thresh: float = 0.5, padding: int = 1) -> np.ndarray:
    """One (M, M) probability map → an (im_h, im_w) uint8 image mask: padded
    by ``padding`` zeros, its box scaled by (M + 2p) / M and truncated to
    integers, resized bilinearly to the box's extent (+1 pixel), thresholded
    at ``thresh`` (or, below 0, scaled to 0-255) and pasted."""
    from ...structures.masks import bilinear_resize

    m = mask.shape[-1]
    pad2 = 2 * padding
    scale = float(m + pad2) / m
    padded = np.zeros((m + pad2, m + pad2), np.float32)
    padded[padding:-padding, padding:-padding] = mask
    box = _expand_box(np.asarray(box, np.float32), scale).astype(np.int32)

    w = max(int(box[2] - box[0] + 1), 1)
    h = max(int(box[3] - box[1] + 1), 1)
    resized = bilinear_resize(padded[None], (h, w))[0]
    if thresh >= 0:
        out = (resized > thresh).astype(np.uint8)
    else:
        out = (resized * 255).astype(np.uint8)

    im_mask = np.zeros((im_h, im_w), np.uint8)
    x0, y0 = max(int(box[0]), 0), max(int(box[1]), 0)
    x1, y1 = min(int(box[2]) + 1, im_w), min(int(box[3]) + 1, im_h)
    im_mask[y0:y1, x0:x1] = out[y0 - box[1]: y1 - box[1], x0 - box[0]: x1 - box[0]]
    return im_mask


def paste_masks_in_image(masks: np.ndarray, boxes: np.ndarray,
                         image_size: Tuple[int, int], thresh: float = 0.5,
                         padding: int = 1) -> np.ndarray:
    """(D, M, M) maps and (D, 4) boxes of one image of ``image_size`` = (w, h)
    → (D, 1, h, w) pasted uint8 masks."""
    im_w, im_h = image_size
    if len(masks) == 0:
        return np.zeros((0, 1, im_h, im_w), np.uint8)
    return np.stack([paste_mask_in_image(m, b, im_h, im_w, thresh, padding)
                     for m, b in zip(masks, boxes)])[:, None]
