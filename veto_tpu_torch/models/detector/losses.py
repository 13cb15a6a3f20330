"""Detector pretraining losses (``veto_tpu/models/detector/losses.py``): the
RPN's and the Fast R-CNN head's, as masked fixed-shape ops batched over
images.

The matcher (``match_boxes``, with the low-quality restore), the balanced
sampler, the RPN losses and the box head's sampler and losses compute what
the JAX package's vmapped functions compute, with its normalisations: the
RPN's BCE is the mean over the sampled anchors and its smooth-L1 (beta
1/9) the sum over the sampled positives over the sampled count; the box
head's CE is the mean over the sampled proposals and its smooth-L1 (beta
1) the sum over the positives' class columns over the sampled count.

The smooth-L1 terms mask the residual before the loss, not the loss
after it (the JAX package's ``where(pos, smooth_l1(r - t), 0)``): the same
values and, for finite targets, the same gradients, but a sampled
negative proposal of zero width (x2 = x1 - 1, which decoding gives when
the RPN's ``dw`` runs far below 0) has infinite targets, and masking the
loss after it sends ``0 * nan`` into that slot's gradient, and through the
global norm into every update.  The reference gathers the positives
first and never sees them.

The samplers take their uniform draws as arguments (``(B, A)`` for the
positives and ``(B, A)`` for the negatives), so that a test can pass the
JAX package's own ``jax.random`` draws; :mod:`..engine.pretrain` draws
them from the train state's ``torch.Generator``.  Every argmax and rank
takes the lower index first among ties, as ``jnp.argmax`` and the stable
``jnp.argsort`` do.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ...ops.box_ops import box_iou, encode_boxes
from ...ops.nms import first_argmax

BELOW_LOW = -1
BETWEEN = -2


def smooth_l1(x: torch.Tensor, beta: float) -> torch.Tensor:
    """Elementwise smooth-L1 (the reference's ``smooth_l1_loss``, no
    reduction)."""
    n = torch.abs(x)
    return torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x`` (B, T, ...) at ``idx`` (B, N) along axis 1 → (B, N, ...)."""
    idx = idx.long().reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def match_boxes(candidates: torch.Tensor, cand_mask: torch.Tensor,
                gt_boxes: torch.Tensor, gt_mask: torch.Tensor, high: float,
                low: float, allow_low_quality: bool) -> torch.Tensor:
    """The reference's ``Matcher``: each candidate's best GT index (the
    first among equal IoUs) when its IoU reaches ``high``, else
    ``BELOW_LOW`` (below ``low``) or ``BETWEEN``.  With
    ``allow_low_quality`` every candidate that is some GT's best match
    (ties included) keeps its best GT.  (B, A, 4), (B, A), (B, T, 4), (B, T)
    → (B, A) int64; masked candidates are ``BELOW_LOW``."""
    iou = box_iou(gt_boxes, candidates)                           # (B, T, A)
    iou = torch.where(gt_mask[:, :, None] & cand_mask[:, None, :], iou, -1.0)
    by_cand = iou.transpose(1, 2)                                 # (B, A, T)
    best_gt = first_argmax(by_cand, torch.arange(
        iou.shape[1], device=iou.device).expand(by_cand.shape))
    best_val = by_cand.amax(-1)
    matches = torch.where(best_val >= high, best_gt,
                          torch.where(best_val < low, BELOW_LOW, BETWEEN))
    if allow_low_quality:
        gt_best = iou.amax(2, keepdim=True)                       # (B, T, 1)
        is_best = (iou == gt_best) & (gt_best > 0) & gt_mask[:, :, None]
        matches = torch.where(is_best.any(1) & cand_mask, best_gt, matches)
    return torch.where(cand_mask, matches, BELOW_LOW)


def _rank(x: torch.Tensor) -> torch.Tensor:
    """Each entry's position in the stable ascending order of its row
    (``argsort(argsort(x))``)."""
    order = torch.argsort(x, dim=-1, stable=True)
    ar = torch.arange(x.shape[-1], device=x.device).expand(x.shape)
    return torch.empty_like(order).scatter_(-1, order, ar)


def balanced_sample(labels: torch.Tensor, pos_draw: torch.Tensor,
                    neg_draw: torch.Tensor, batch_size: int,
                    positive_fraction: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``BalancedPositiveNegativeSampler``: of ``labels`` (B, A) (1 fg, 0 bg,
    -1 discarded), at most ``batch_size * positive_fraction`` positives,
    those with the smallest ``pos_draw``, and the rest of ``batch_size``
    negatives, those with the smallest ``neg_draw`` (both (B, A) uniforms).
    Returns the (pos, neg) masks."""
    budget = int(batch_size * positive_fraction)
    pos, neg = labels == 1, labels == 0
    inf = torch.full((), float("inf"), device=labels.device)
    num_pos = pos.sum(-1, keepdim=True).clamp(max=budget)
    pos_sel = pos & (_rank(torch.where(pos, pos_draw, inf)) < num_pos)
    num_neg = torch.minimum(neg.sum(-1, keepdim=True), batch_size - num_pos)
    neg_sel = neg & (_rank(torch.where(neg, neg_draw, inf)) < num_neg)
    return pos_sel, neg_sel


def _fg_bg(matches: torch.Tensor) -> torch.Tensor:
    """1 matched, 0 below ``low``, -1 between the thresholds."""
    return torch.where(matches >= 0, 1, torch.where(matches == BELOW_LOW, 0, -1))


class RPNLoss(NamedTuple):
    objectness: torch.Tensor  # (B,)
    box: torch.Tensor         # (B,)


def rpn_losses(objectness: torch.Tensor, box_regression: torch.Tensor,
               anchors: torch.Tensor, visibility: torch.Tensor,
               gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
               pos_draw: torch.Tensor, neg_draw: torch.Tensor,
               batch_size: int = 256, positive_fraction: float = 0.5,
               high: float = 0.7, low: float = 0.3) -> RPNLoss:
    """Each image's RPN losses (``RPNLossComputation``): (B, A) logits of
    every level, (B, A, 4) deltas, (A, 4) anchors and their (A,)
    visibility, (B, T, 4) GT boxes and (B, T) mask, the sampler's (B, A)
    draws → per-image objectness BCE and box smooth-L1.  The matching runs
    an image at a time: the (T, A) IoU of all images at once would hold
    gigabytes at the VG shapes (80 GT boxes, 358,092 anchors)."""
    b = objectness.shape[0]
    with torch.no_grad():
        matches = torch.cat([
            match_boxes(anchors[None], visibility[None], gt_boxes[i:i + 1],
                        gt_mask[i:i + 1], high, low, allow_low_quality=True)
            for i in range(b)])
        labels = torch.where(visibility, _fg_bg(matches), -1)  # the invisible
        pos_sel, neg_sel = balanced_sample(labels, pos_draw, neg_draw,
                                           batch_size, positive_fraction)
        sampled = pos_sel | neg_sel
        n_sampled = sampled.sum(-1).clamp(min=1)
        targets = encode_boxes(_gather_rows(gt_boxes, matches.clamp(min=0)),
                               anchors.expand(b, -1, -1),
                               weights=(1.0, 1.0, 1.0, 1.0))
    box = smooth_l1(torch.where(pos_sel[..., None], box_regression - targets, 0.0),
                    beta=1.0 / 9)
    logits = objectness.float()
    y = labels.float()
    bce = (logits.clamp(min=0) - logits * y
           + torch.log1p(torch.exp(-torch.abs(logits))))
    obj = torch.where(sampled, bce, 0.0).sum(-1) / n_sampled
    return RPNLoss(objectness=obj, box=box.sum((1, 2)) / n_sampled)


class BoxSample(NamedTuple):
    idx: torch.Tensor      # (B, S) indices into the proposal axis
    mask: torch.Tensor     # (B, S) bool
    labels: torch.Tensor   # (B, S) int64 class labels (0 = bg)
    targets: torch.Tensor  # (B, S, 4) regression targets


def fastrcnn_sample(proposals: torch.Tensor, prop_mask: torch.Tensor,
                    gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                    gt_mask: torch.Tensor, pos_draw: torch.Tensor,
                    neg_draw: torch.Tensor, batch_size: int = 512,
                    positive_fraction: float = 0.25, high: float = 0.5,
                    low: float = 0.3,
                    reg_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)
                    ) -> BoxSample:
    """``FastRCNNSampling.subsample`` of each image: match (no low-quality
    restore; between the thresholds discarded), the balanced sample of
    ``batch_size`` at ``positive_fraction`` from the (B, P) draws, class
    labels and encoded targets, compacted into ``S = min(batch_size, P)``
    slots in proposal order; the empty slots point at proposal 0 with
    label 0 and zero targets."""
    matches = match_boxes(proposals, prop_mask, gt_boxes, gt_mask, high, low,
                          allow_low_quality=False)
    matched = matches.clamp(min=0)
    cls = torch.where(matches >= 0, torch.gather(gt_labels.long(), 1, matched), 0)
    pos_sel, neg_sel = balanced_sample(_fg_bg(matches), pos_draw, neg_draw,
                                       batch_size, positive_fraction)
    sel = pos_sel | neg_sel
    order = torch.argsort((~sel).to(torch.uint8), dim=-1, stable=True)
    order = order[:, :batch_size]
    mask = torch.gather(sel, 1, order)
    targets = encode_boxes(_gather_rows(gt_boxes, matched), proposals,
                           weights=reg_weights)
    return BoxSample(
        idx=torch.where(mask, order, 0),
        mask=mask,
        labels=torch.where(mask, torch.gather(cls, 1, order), 0),
        targets=torch.where(mask[..., None], _gather_rows(targets, order), 0.0))


class BoxLoss(NamedTuple):
    classifier: torch.Tensor  # (B,)
    box_reg: torch.Tensor     # (B,)


def fastrcnn_losses(class_logits: torch.Tensor, box_regression: torch.Tensor,
                    sample: BoxSample) -> BoxLoss:
    """``FastRCNNLossComputation`` of each image: (B, S, C) logits and
    (B, S, 4C) deltas of the sampled rois → per-image CE and smooth-L1 of
    the positives' own class columns."""
    b, s, c = class_logits.shape
    n_sampled = sample.mask.sum(-1).clamp(min=1)
    logp = F.log_softmax(class_logits.float(), dim=-1)
    nll = -torch.gather(logp, 2, sample.labels[..., None])[..., 0]
    cls_loss = torch.where(sample.mask, nll, 0.0).sum(-1) / n_sampled
    pos = sample.mask & (sample.labels > 0)
    reg = box_regression.reshape(b, s, c, 4)
    reg_cls = torch.gather(reg, 2, sample.labels[..., None, None].expand(b, s, 1, 4))
    box = smooth_l1(torch.where(pos[..., None], reg_cls[:, :, 0] - sample.targets, 0.0),
                    beta=1.0)
    return BoxLoss(classifier=cls_loss, box_reg=box.sum((1, 2)) / n_sampled)
