"""The frozen detector's box head (``veto_tpu/models/detector/box_head.py``):
``BoxFeatureExtractor`` and ``BoxPredictor`` (the reference's
FPN2MLPFeatureExtractor and FPNPredictor), the label assignment of
proposals (``assign_labels_to_proposals``) and the SGDet box
post-processing (``box_postprocess``: ``decode_candidates``, then
``filter_decoded_boxes``, the reference's ``filter_results`` with
``NMS_FILTER_DUPLICATES`` and the ``boxes_per_cls`` bookkeeping), batched
over images with static budgets and masks.

The pooled map arrives NHWC, (..., P, P, C), and is flattened in that
order, as in the JAX package: a reference ``fc6`` (which flattens NCHW)
is permuted to it on import (``utils/torch_import.py``).  fc6 and fc7 run
in the model's dtype; ``cls_score`` and ``bbox_pred`` in f32 on the
features cast to f32, as flax's ``Dense(dtype=float32)`` promotes them.

Every top-k and argmax takes the lower index first among ties, as
``jax.lax.top_k`` and ``jnp.argmax`` do (:func:`..rpn.topk_first`,
:func:`veto_tpu_torch.ops.nms.first_argmax`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.box_ops import box_iou, clip_to_image, decode_boxes
from ...ops.nms import first_argmax, multiclass_nms_mask
from ..layers import Dense
from .rpn import topk_first


class BoxFeatureExtractor(nn.Module):
    """fc6 / fc7 with ReLU over the flattened pooled map: (..., P, P, C) →
    (..., mlp_dim)."""

    def __init__(self, in_features: int, mlp_dim: int = 4096,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.fc6 = Dense(in_features, mlp_dim, dtype=dtype)
        self.fc7 = Dense(mlp_dim, mlp_dim, dtype=dtype)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = pooled.reshape(pooled.shape[:-3] + (-1,))
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class BoxPredictor(nn.Module):
    """Class logits and per-class box deltas, both f32."""

    def __init__(self, in_features: int = 4096, num_classes: int = 151):
        super().__init__()
        self.cls_score = Dense(in_features, num_classes, dtype=torch.float32)
        self.bbox_pred = Dense(in_features, num_classes * 4, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cls_score(x), self.bbox_pred(x)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x`` (B, P, ...) at ``idx`` (B, K) along axis 1 → (B, K, ...)."""
    idx = idx.long().reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def _arange_like(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[-1], device=x.device).expand(x.shape)


def assign_labels_to_proposals(prop_boxes: torch.Tensor, prop_mask: torch.Tensor,
                               gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                               gt_mask: torch.Tensor,
                               fg_iou_threshold: float = 0.5
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each proposal's class for the SGDet relation path: the label of its
    best-IoU GT box (the first among equal IoUs) when that IoU reaches
    ``fg_iou_threshold``, else 0.  (B, P, 4), (B, P), (B, T, 4), (B, T),
    (B, T) → labels (B, P) int32 and the matched GT index (-1 if bg)."""
    iou = box_iou(gt_boxes.float(), prop_boxes.float())            # (B, T, P)
    iou = torch.where(gt_mask[..., None], iou, -1.0).transpose(1, 2)
    best_gt = first_argmax(iou, _arange_like(iou))                 # (B, P)
    best_iou = iou.amax(-1)
    fg = (best_iou >= fg_iou_threshold) & prop_mask
    labels = torch.where(fg, torch.gather(gt_labels.long(), 1, best_gt), 0)
    return labels.to(torch.int32), torch.where(fg, best_gt, -1).to(torch.int32)


class Detections(NamedTuple):
    boxes: torch.Tensor          # (B, D, 4) final per-label decoded boxes
    scores: torch.Tensor         # (B, D)
    labels: torch.Tensor         # (B, D) int32
    mask: torch.Tensor           # (B, D) bool
    orig_idx: torch.Tensor       # (B, D) int32 index into the proposal axis
    boxes_per_cls: torch.Tensor  # (B, D, C, 4) per-class decoded boxes


def box_postprocess(class_logits: torch.Tensor, box_regression: torch.Tensor,
                    proposals: torch.Tensor, prop_mask: torch.Tensor,
                    image_size: torch.Tensor, score_thresh: float = 0.01,
                    nms_thresh: float = 0.3, post_nms_per_cls_topn: int = 300,
                    nms_filter_duplicates: bool = True,
                    detections_per_img: int = 80,
                    reg_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)
                    ) -> Detections:
    """``filter_results`` on static shapes: :func:`decode_candidates`, then
    :func:`filter_decoded_boxes`.  (B, P, C) logits, (B, P, 4C) deltas,
    (B, P, 4) proposals, (B, P) mask, (B, 2) = (w, h) sizes."""
    prob, boxes_per_cls = decode_candidates(class_logits, box_regression,
                                            proposals, image_size, reg_weights)
    return filter_decoded_boxes(
        prob, boxes_per_cls, prop_mask, score_thresh=score_thresh,
        nms_thresh=nms_thresh, post_nms_per_cls_topn=post_nms_per_cls_topn,
        nms_filter_duplicates=nms_filter_duplicates,
        detections_per_img=detections_per_img)


def decode_candidates(class_logits: torch.Tensor, box_regression: torch.Tensor,
                      proposals: torch.Tensor, image_size: torch.Tensor,
                      reg_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The candidates of ``filter_results``: f32 softmax scores (B, P, C)
    and every class's decoded box clipped to the image (B, P, C, 4)."""
    b, p, c = class_logits.shape
    prob = torch.softmax(class_logits.float(), dim=-1)
    boxes_per_cls = decode_boxes(box_regression.float(), proposals.float(),
                                 weights=reg_weights).reshape(b, p * c, 4)
    boxes_per_cls = clip_to_image(boxes_per_cls, image_size).reshape(b, p, c, 4)
    return prob, boxes_per_cls


def filter_decoded_boxes(prob: torch.Tensor, boxes_per_cls: torch.Tensor,
                         prop_mask: torch.Tensor, score_thresh: float = 0.01,
                         nms_thresh: float = 0.3,
                         post_nms_per_cls_topn: int = 300,
                         nms_filter_duplicates: bool = True,
                         detections_per_img: int = 80) -> Detections:
    """The post-decode half of ``filter_results``: per-class NMS over the
    foreground classes (scores above ``score_thresh``, IoU ``nms_thresh``,
    at most ``post_nms_per_cls_topn`` a class), then either the
    one-label-per-box reduction (``nms_filter_duplicates``: each box keeps
    its best surviving class; the top ``detections_per_img`` boxes are
    emitted in ascending box order, as the reference's ``nonzero()``) or
    every surviving (box, class) pair competing for the budget in score
    order.  Padded entries carry mask False, zero boxes, scores and labels,
    and the ``boxes_per_cls`` row of the proposal the top-k picked there:
    the lowest-index entries left, as ``jax.lax.top_k`` picks them."""
    b, p, c = prob.shape
    keep_fg = multiclass_nms_mask(boxes_per_cls[:, :, 1:], prob[:, :, 1:],
                                  score_thresh, nms_thresh,
                                  post_nms_per_cls_topn, valid_mask=prop_mask)
    ninf = -float("inf")

    def pick_label_boxes(sel_bpc, labels):
        idx = labels.long()[..., None, None].expand(labels.shape + (1, 4))
        return torch.gather(sel_bpc, 2, idx)[:, :, 0]

    if nms_filter_duplicates:
        dist = prob[:, :, 1:] * keep_fg
        scores_pre = dist.amax(-1)
        labels_pre = first_argmax(dist, _arange_like(dist)) + 1
        cand = torch.where(scores_pre > 0.0, scores_pre, ninf)
        top, top_idx = topk_first(cand, min(detections_per_img, p))
        mask = top > ninf
        # survivors in ascending box order; the padding keeps its top-k order
        order = torch.sort(torch.where(mask, top_idx, p), dim=1, stable=True)[1]
        top_idx, mask = torch.gather(top_idx, 1, order), torch.gather(mask, 1, order)
        labels = torch.where(mask, torch.gather(labels_pre, 1, top_idx), 0)
        sel_bpc = _take(boxes_per_cls, top_idx)
        boxes = pick_label_boxes(sel_bpc, labels)
        return Detections(
            boxes=torch.where(mask[..., None], boxes, 0.0),
            scores=torch.where(mask, torch.gather(scores_pre, 1, top_idx), 0.0),
            labels=labels.to(torch.int32), mask=mask,
            orig_idx=torch.where(mask, top_idx, 0).to(torch.int32),
            boxes_per_cls=sel_bpc)

    flat = torch.where(keep_fg, prob[:, :, 1:], ninf).reshape(b, -1)
    top, flat_idx = topk_first(flat, min(detections_per_img, flat.shape[1]))
    mask = top > ninf
    box_idx = flat_idx // (c - 1)
    labels = flat_idx % (c - 1) + 1
    sel_bpc = _take(boxes_per_cls, box_idx)
    boxes = pick_label_boxes(sel_bpc, labels)
    return Detections(
        boxes=torch.where(mask[..., None], boxes, 0.0),
        scores=torch.where(mask, top, 0.0),
        labels=torch.where(mask, labels, 0).to(torch.int32), mask=mask,
        orig_idx=torch.where(mask, box_idx, 0).to(torch.int32),
        boxes_per_cls=sel_bpc)
