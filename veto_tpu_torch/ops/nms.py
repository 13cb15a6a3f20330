"""Object-label NMS (``veto_tpu/ops/nms.py`` ``obj_prediction_nms``).

The global-argmax label assignment that SGCls runs over the frozen box
head's logits (and SGDet and MEET over their detections), batched over
images: the JAX package vmaps its per-image ``fori_loop``, the port runs
the same N trips on a (B, N, C) tensor.  Every trip is a fixed sequence of
tensor ops: no ``.item()``, no branch on the data, so the card never waits
for the host inside the loop.

It stays plain PyTorch: the JAX package has no Pallas kernel for it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .box_ops import TO_REMOVE, box_area


def first_argmax(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Index of the first maximal entry along the last axis of a NaN-free
    ``x``, as ``jnp.argmax`` defines it; ``idx`` is ``arange`` over that
    axis, expanded to ``x``'s shape.  The rule is written out, not left to
    ``torch.argmax``'s tie order on a device: the NMS picks among exact
    ties on nearly every trip."""
    top = x.amax(-1, keepdim=True)
    return torch.where(x == top, idx, x.shape[-1]).amin(-1)


def class_overlaps(boxes_per_cls: torch.Tensor,
                   nms_thresh: float) -> torch.Tensor:
    """(B, N, C, 4) boxes → (B, C, N, N) bool: the class-c IoU of boxes i
    and j, with ``TO_REMOVE``, is at least ``nms_thresh`` (``nms_overlaps``
    of the reference, in the JAX package's f32 arithmetic)."""
    bpc = boxes_per_cls.float().transpose(1, 2)            # (B, C, N, 4)
    lt = torch.maximum(bpc[:, :, :, None, :2], bpc[:, :, None, :, :2])
    rb = torch.minimum(bpc[:, :, :, None, 2:], bpc[:, :, None, :, 2:])
    wh = torch.clamp(rb - lt + TO_REMOVE, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = box_area(bpc)
    iou = inter / (area[..., :, None] + area[..., None, :] - inter)
    return iou >= nms_thresh


def obj_prediction_nms(boxes_per_cls: torch.Tensor, pred_logits: torch.Tensor,
                       nms_thresh: float = 0.3,
                       valid_mask: Optional[torch.Tensor] = None,
                       overwrite: bool = False,
                       bg_init: Optional[float] = None) -> torch.Tensor:
    """Per-box labels (B, N) int32 from (B, N, C, 4) boxes and (B, N, C)
    logits; 0 is background or never assigned.

    ``prob = softmax(logits)``, the background column set to ``bg_init``
    (default 0, or -1 with ``overwrite``), masked boxes' rows to -1.  Then N
    trips, each in every image at once: take the first maximal (box, class)
    of the flattened box-major (N, C) table; label the box with the class
    if it has no label yet (always, with ``overwrite``); zero that class
    for every box whose class IoU with it is at least ``nms_thresh``;
    retire the box's row with -1.  A table with nothing left above -1 picks
    box 0, class 0, as ``jnp.argmax`` does, and the trip goes on with it.
    A NaN counts as the maximum, as in ``jnp.argmax``: NaNs become +inf
    once, which no probability reaches, so every pick is the same.

    A trip is 15 launches (13 with ``overwrite``), each over the whole
    batch.
    """
    b, n, c = pred_logits.shape
    dev = pred_logits.device
    prob = torch.softmax(pred_logits.float(), dim=-1)
    if bg_init is None:
        bg_init = -1.0 if overwrite else 0.0
    prob[..., 0] = bg_init
    if valid_mask is not None:
        prob = torch.where(valid_mask[..., None], prob, -1.0)
    prob = torch.where(prob.isnan(), float("inf"), prob).contiguous()
    flat = prob.view(b, n * c)
    # the overlap of every box with a picked (box, class): row box * C + cls
    # of a (B, N * C, N) table, so the flat pick indexes it directly
    overlap = (class_overlaps(boxes_per_cls, nms_thresh).transpose(1, 2)
               .reshape(b, n * c, n))
    labels = torch.zeros((b, n), dtype=torch.long, device=dev)
    flat_ar = torch.arange(n * c, device=dev).expand(b, n * c)
    boxes_ar = torch.arange(n, device=dev)
    cls_ar = torch.arange(c, device=dev)
    for _ in range(n):
        pick = first_argmax(flat, flat_ar)
        box, cls = pick // c, pick % c
        row = boxes_ar == box[:, None]                       # (B, N)
        take = row if overwrite else row & (labels <= 0)
        labels = torch.where(take, cls[:, None], labels)
        suppress = overlap.gather(1, pick[:, None, None].expand(b, 1, n))
        prob.masked_fill_(suppress.view(b, n, 1)
                          & (cls_ar == cls[:, None])[:, None, :], 0.0)
        prob.masked_fill_(row[:, :, None], -1.0)
    return labels.to(torch.int32)
