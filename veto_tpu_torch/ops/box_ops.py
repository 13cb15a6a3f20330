"""Box geometry (``veto_tpu/ops/box_ops.py``).

The maskrcnn-benchmark inclusive-pixel convention is kept exactly:
``width = x2 - x1 + 1`` (``TO_REMOVE``).  It moves the FPN level
assignment, the VETO position embedding, every IoU and the box decoding.
Each function computes in the JAX package's order of operations, so on
the CPU the results are the same f32 values (``exp`` may differ from
XLA's by an ulp).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

TO_REMOVE = 1.0
BBOX_XFORM_CLIP = math.log(1000.0 / 16)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area with the inclusive-pixel convention."""
    w = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    h = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return w * h


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: (..., N, 4) x (..., M, 4) → (..., N, M), with
    ``TO_REMOVE`` (the reference's ``boxlist_iou``)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt + TO_REMOVE, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[..., :, None] + area2[..., None, :] - inter)


def xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) → (x, y, w, h) with w = x2 - x1 + 1."""
    w = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    h = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return torch.stack([boxes[..., 0], boxes[..., 1], w, h], dim=-1)


def center_xywh(xywh: torch.Tensor) -> torch.Tensor:
    """(x, y, w, h) → (cx, cy, w, h), the VETO position-embedding input."""
    return torch.cat([xywh[..., :2] + 0.5 * xywh[..., 2:], xywh[..., 2:]],
                     dim=-1)


def clip_to_image(boxes: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Clamp xyxy boxes (..., N, 4) to [0, W - 1] x [0, H - 1]; ``size`` is
    (..., 2) = (width, height), one per leading index."""
    w = size[..., None, 0:1].to(boxes.dtype)
    h = size[..., None, 1:2].to(boxes.dtype)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0:1], zero), w - TO_REMOVE)
    y1 = torch.minimum(torch.maximum(boxes[..., 1:2], zero), h - TO_REMOVE)
    x2 = torch.minimum(torch.maximum(boxes[..., 2:3], zero), w - TO_REMOVE)
    y2 = torch.minimum(torch.maximum(boxes[..., 3:4], zero), h - TO_REMOVE)
    return torch.cat([x1, y1, x2, y2], dim=-1)


def nonempty_mask(boxes: torch.Tensor, min_size: float = 0.0) -> torch.Tensor:
    """The reference's ``remove_small_boxes`` as a mask."""
    ws = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    hs = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return (ws >= min_size) & (hs >= min_size)


def encode_boxes(reference_boxes: torch.Tensor, proposals: torch.Tensor,
                 weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)
                 ) -> torch.Tensor:
    """``BoxCoder.encode``: the deltas (..., N, 4) that take ``proposals``
    (..., N, 4) to ``reference_boxes`` (..., N, 4), the inverse of
    :func:`decode_boxes` up to its clamp."""
    ex_w = proposals[..., 2] - proposals[..., 0] + TO_REMOVE
    ex_h = proposals[..., 3] - proposals[..., 1] + TO_REMOVE
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h
    gt_w = reference_boxes[..., 2] - reference_boxes[..., 0] + TO_REMOVE
    gt_h = reference_boxes[..., 3] - reference_boxes[..., 1] + TO_REMOVE
    gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
    gt_cy = reference_boxes[..., 1] + 0.5 * gt_h
    wx, wy, ww, wh = weights
    return torch.stack([wx * (gt_cx - ex_cx) / ex_w, wy * (gt_cy - ex_cy) / ex_h,
                        ww * torch.log(gt_w / ex_w), wh * torch.log(gt_h / ex_h)],
                       dim=-1)


def decode_boxes(rel_codes: torch.Tensor, boxes: torch.Tensor,
                 weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)
                 ) -> torch.Tensor:
    """``BoxCoder.decode``: ``rel_codes`` (..., N, 4K), K classes of deltas
    per box of ``boxes`` (..., N, 4) → (..., N, 4K).  ``dw``/``dh`` are
    clamped at ``BBOX_XFORM_CLIP``; x2/y2 take the inclusive ``- 1``."""
    widths = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    heights = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    codes = rel_codes.reshape(rel_codes.shape[:-1] + (-1, 4))
    # 0-d tensors filled on the device (no copy from the host, so no
    # synchronisation); tensor divisors, because a Python-scalar division
    # on a card multiplies by the rounded reciprocal, an ulp off the JAX
    # package's division
    def const(v):
        return torch.full((), v, dtype=codes.dtype, device=codes.device)

    clip = const(BBOX_XFORM_CLIP)
    dx = codes[..., 0] / const(weights[0])
    dy = codes[..., 1] / const(weights[1])
    dw = torch.minimum(codes[..., 2] / const(weights[2]), clip)
    dh = torch.minimum(codes[..., 3] / const(weights[3]), clip)

    pred_cx = dx * widths[..., None] + ctr_x[..., None]
    pred_cy = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]
    out = torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                       pred_cx + 0.5 * pred_w - 1.0,
                       pred_cy + 0.5 * pred_h - 1.0], dim=-1)
    return out.reshape(rel_codes.shape)


def box_union(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise enclosing box of two aligned sets (..., 4)."""
    return torch.cat([torch.minimum(boxes1[..., :2], boxes2[..., :2]),
                      torch.maximum(boxes1[..., 2:], boxes2[..., 2:])], dim=-1)


def encode_box_info(boxes: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """The 9-d normalized box geometry of the legacy contexts: (w/W, h/H,
    cx/W, cy/H, x1/W, y1/H, x2/W, y2/H, wh/(WH)) of (..., N, 4) boxes in an
    image of ``size`` (..., 2) = (width, height)."""
    wid = size[..., None, 0].to(boxes.dtype)
    hei = size[..., None, 1].to(boxes.dtype)
    wh = boxes[..., 2:] - boxes[..., :2] + 1.0
    xy = boxes[..., :2] + 0.5 * wh
    w, h = wh[..., 0], wh[..., 1]
    x, y = xy[..., 0], xy[..., 1]
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([w / wid, h / hei, x / wid, y / hei, x1 / wid, y1 / hei,
                        x2 / wid, y2 / hei, w * h / (wid * hei)], dim=-1)


def resize_boxes(boxes: torch.Tensor, src_size: torch.Tensor,
                 dst_size: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) boxes scaled from an image of ``src_size`` to one of
    ``dst_size`` (each (..., 2) = (width, height); ``BoxList.resize``)."""
    ratio = dst_size.to(boxes.dtype) / src_size.to(boxes.dtype)
    rw, rh = ratio[..., None, 0], ratio[..., None, 1]
    return torch.stack([boxes[..., 0] * rw, boxes[..., 1] * rh,
                        boxes[..., 2] * rw, boxes[..., 3] * rh], dim=-1)
