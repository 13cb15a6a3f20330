"""Region Proposal Network (``veto_tpu/models/detector/rpn.py``): the head
and the fixed-budget proposal selection, batched over images.

Per image and FPN level: the top ``pre_nms_top_n`` anchors by objectness,
decoded and clipped to the image, NMS at ``nms_thresh`` down to
``post_nms_top_n``; then the top ``fpn_post_nms_top_n`` over all levels.
Every stage has a static budget and a mask, as in the JAX package, so the
card never waits for the host.  The NMS walks of all levels and images go
to one call of :func:`veto_tpu_torch.ops.nms.nms` (``RPN_BATCH_LEVELS``,
two launches of kernel N1 on the card); with it off, one call per level.

Every top-k here takes the lower index first among equal scores, as
``jax.lax.top_k`` does: the head runs in bf16, so its objectness logits
tie often across the 268,800 anchors of P2, and ``torch.topk`` promises no
order among ties.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.box_ops import clip_to_image, decode_boxes, nonempty_mask
from ...ops.nms import nms
from ..layers import Conv2d

# Batch the per-level NMS walks into one call (True) or run one call per
# level (False); the selection is the same either way.
RPN_BATCH_LEVELS = True


def topk_first(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries along the last axis and their indices,
    the lower index first among equal values (``jax.lax.top_k``'s rule):
    a stable descending sort, cut at ``k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class RPNHead(nn.Module):
    """Shared 3x3 conv (ReLU) with the objectness and box-delta 1x1 heads,
    applied to every FPN level in the input's dtype: NHWC (B, H, W, C)
    levels → NHWC (B, H, W, A) logits and (B, H, W, 4A) deltas."""

    def __init__(self, in_channels: int = 256, mid_channels: int = 256,
                 num_anchors: int = 4):
        super().__init__()
        self.conv = Conv2d(in_channels, mid_channels, 3, padding=1)
        self.cls_logits = Conv2d(mid_channels, num_anchors, 1)
        self.bbox_pred = Conv2d(mid_channels, 4 * num_anchors, 1)

    def forward(self, features: Sequence[torch.Tensor]):
        logits, bbox = [], []
        for f in features:
            t = F.relu(self.conv(f.permute(0, 3, 1, 2)))  # channels-last NCHW
            logits.append(self.cls_logits(t).permute(0, 2, 3, 1))
            bbox.append(self.bbox_pred(t).permute(0, 2, 3, 1))
        return tuple(logits), tuple(bbox)


class Proposals(NamedTuple):
    boxes: torch.Tensor       # (B, P, 4) xyxy, clipped to the image
    objectness: torch.Tensor  # (B, P) sigmoid scores, descending
    mask: torch.Tensor        # (B, P) bool


def flatten_level(objectness_map: torch.Tensor, bbox_map: torch.Tensor):
    """(B, H, W, A) and (B, H, W, 4A) maps → (B, H*W*A) and (B, H*W*A, 4):
    the anchor index fastest over row-major (y, x), as ``grid_anchors``
    lays the anchors out."""
    b = objectness_map.shape[0]
    return objectness_map.reshape(b, -1), bbox_map.reshape(b, -1, 4)


def _level_candidates(o, r, a, image_sizes, pre_nms_top_n, min_size):
    """One level's pre-NMS candidates: sigmoid scores, top ``pre_nms_top_n``,
    decoded (weights 1), clipped, with the non-empty mask."""
    k = min(pre_nms_top_n, o.shape[1])
    scores, idx = topk_first(torch.sigmoid(o.float()), k)
    deltas = torch.gather(r.float(), 1, idx[..., None].expand(-1, -1, 4))
    props = decode_boxes(deltas, a[idx], weights=(1.0, 1.0, 1.0, 1.0))
    props = clip_to_image(props, image_sizes)
    return props, scores, nonempty_mask(props, min_size)


def _gather_keeps(boxes, scores, idx, ok):
    """The kept candidates: (..., K, 4) boxes and (..., K) scores at the
    NMS indices (..., M), scores 0 where not kept."""
    idx = idx.long()
    kb = torch.gather(boxes, -2, idx[..., None].expand(idx.shape + (4,)))
    ks = torch.where(ok, torch.gather(scores, -1, idx), 0.0)
    return kb, ks


def rpn_select_proposals(objectness: Sequence[torch.Tensor],
                         box_regression: Sequence[torch.Tensor],
                         anchors: Sequence[torch.Tensor],
                         image_sizes: torch.Tensor,
                         pre_nms_top_n: int = 6000, post_nms_top_n: int = 1000,
                         nms_thresh: float = 0.7, fpn_post_nms_top_n: int = 1000,
                         min_size: float = 0.0) -> Proposals:
    """Every image's RPN selection (``RPNPostProcessor.forward``): per level
    (B, H*W*A) logits and (B, H*W*A, 4) deltas, per level (H*W*A, 4)
    anchors, (B, 2) = (w, h) image sizes → :class:`Proposals`."""
    b = image_sizes.shape[0]
    if not RPN_BATCH_LEVELS:
        boxes, scores, masks = [], [], []
        for o, r, a in zip(objectness, box_regression, anchors):
            props, sc, valid = _level_candidates(o, r, a, image_sizes,
                                                 pre_nms_top_n, min_size)
            idx, ok = nms(props, sc, nms_thresh, post_nms_top_n,
                          valid_mask=valid, early_exit=True)
            kb, ks = _gather_keeps(props, sc, idx, ok)
            boxes.append(kb)
            scores.append(ks)
            masks.append(ok)
        return _final_topk(torch.cat(boxes, 1), torch.cat(scores, 1),
                           torch.cat(masks, 1), fpn_post_nms_top_n)

    kmax = max(min(pre_nms_top_n, o.shape[1]) for o in objectness)
    boxes_l, scores_l, valid_l = [], [], []
    for o, r, a in zip(objectness, box_regression, anchors):
        props, sc, valid = _level_candidates(o, r, a, image_sizes,
                                             pre_nms_top_n, min_size)
        pad = kmax - sc.shape[1]
        boxes_l.append(F.pad(props, (0, 0, 0, pad)))
        scores_l.append(F.pad(sc, (0, pad), value=-1.0))
        valid_l.append(F.pad(valid, (0, pad)))
    boxes_l = torch.stack(boxes_l, 1)                      # (B, L, kmax, 4)
    scores_l = torch.stack(scores_l, 1)
    idx, ok = nms(boxes_l, scores_l, nms_thresh, post_nms_top_n,
                  valid_mask=torch.stack(valid_l, 1), early_exit=True)
    kb, ks = _gather_keeps(boxes_l, scores_l, idx, ok)
    return _final_topk(kb.reshape(b, -1, 4), ks.reshape(b, -1),
                       ok.reshape(b, -1), fpn_post_nms_top_n)


def _final_topk(boxes, scores, mask, fpn_post_nms_top_n) -> Proposals:
    """``select_over_all_levels``, per image: the top ``fpn_post_nms_top_n``
    kept candidates by objectness."""
    k = min(fpn_post_nms_top_n, boxes.shape[1])
    top, idx = topk_first(torch.where(mask, scores, -float("inf")), k)
    keep = top > -float("inf")
    sel = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    return Proposals(boxes=torch.where(keep[..., None], sel, 0.0),
                     objectness=torch.where(keep, torch.gather(scores, 1, idx), 0.0),
                     mask=keep)


def level_anchors(map_sizes, sizes, strides, aspect_ratios,
                  device) -> List[torch.Tensor]:
    """Per-level (H_l*W_l*A, 4) f32 anchors over feature maps of
    ``map_sizes`` (H_l, W_l): ``fpn_anchors``' grids, which take
    ``ceil(H / stride_l)`` of the padded image, as the FPN's maps have."""
    from .anchors import generate_cell_anchors, grid_anchors

    return [torch.from_numpy(grid_anchors(
                tuple(hw), stride, generate_cell_anchors(stride, size, aspect_ratios)))
            .to(device) for hw, size, stride in zip(map_sizes, sizes, strides)]
