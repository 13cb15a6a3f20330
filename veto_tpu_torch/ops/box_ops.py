"""Box geometry the PredCls slice needs (``veto_tpu/ops/box_ops.py``).

The maskrcnn-benchmark inclusive-pixel convention is kept exactly:
``width = x2 - x1 + 1`` (``TO_REMOVE``).  It moves the FPN level
assignment and the VETO position embedding.
"""

from __future__ import annotations

import torch

TO_REMOVE = 1.0


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area with the inclusive-pixel convention."""
    w = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    h = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return w * h


def xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) → (x, y, w, h) with w = x2 - x1 + 1."""
    w = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    h = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return torch.stack([boxes[..., 0], boxes[..., 1], w, h], dim=-1)


def center_xywh(xywh: torch.Tensor) -> torch.Tensor:
    """(x, y, w, h) → (cx, cy, w, h), the VETO position-embedding input."""
    return torch.cat([xywh[..., :2] + 0.5 * xywh[..., 2:], xywh[..., 2:]],
                     dim=-1)
