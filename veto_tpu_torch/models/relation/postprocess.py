"""Relation post-processing (``veto_tpu/models/relation/postprocess.py``
``postprocess_relations`` and ``postprocess_relations_sgdet``), batched:
logits → triplets ranked by score."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...ops.nms import first_argmax, obj_prediction_nms


class RelPrediction(NamedTuple):
    pair_idx: torch.Tensor    # (B, P, 2) sorted by triple score desc
    rel_scores: torch.Tensor  # (B, P, C) softmax over predicates (bg at 0)
    rel_labels: torch.Tensor  # (B, P) argmax fg predicate
    pair_mask: torch.Tensor   # (B, P)
    obj_labels: torch.Tensor  # (B, N) predicted object classes
    obj_scores: torch.Tensor  # (B, N) predicted object scores
    # (B, P, C) pair relness (the sigmoid of BGNN's pre-classifier logits)
    # in the pairs' order, the reference's "relness" field; else None
    relness: Optional[torch.Tensor] = None


def postprocess_relations(rel_logits: torch.Tensor, obj_dists: torch.Tensor,
                          pair_idx: torch.Tensor, pair_mask: torch.Tensor,
                          relness: Optional[torch.Tensor] = None) -> RelPrediction:
    """(B, P, C) logits, (B, N, num_obj) object logits → RelPrediction.

    Object softmax with background zeroed (:func:`object_predictions`),
    fg-predicate argmax per pair,
    triple score = rel · subj · obj, and a stable descending sort (the
    JAX package's ``jnp.argsort`` is stable too).  ``relness`` (B, P, ...)
    is reordered with the pairs.
    """
    obj_labels, obj_scores = object_predictions(obj_dists)
    rel_prob, rel_fg, rel_labels = _rel_scores(rel_logits)
    take = _triple_order(rel_fg, obj_scores, pair_idx, pair_mask)
    return RelPrediction(
        pair_idx=take(pair_idx), rel_scores=take(rel_prob),
        rel_labels=take(rel_labels), pair_mask=take(pair_mask),
        obj_labels=obj_labels, obj_scores=obj_scores,
        relness=None if relness is None else take(relness))


def object_predictions(obj_dists: torch.Tensor):
    """Object labels (int32) and scores from the proposals' logits
    (B, N, C): the softmax with the background zeroed, its first maximum
    over the classes from 1 (``jnp.argmax``'s rule)."""
    prob = torch.softmax(obj_dists.float(), dim=-1)[..., 1:]
    idx = torch.arange(prob.shape[-1], device=prob.device).expand(prob.shape)
    return (first_argmax(prob, idx) + 1).to(torch.int32), prob.amax(-1)


def _rel_scores(rel_logits: torch.Tensor):
    """Predicate softmax, and each pair's best foreground score and label."""
    rel_prob = torch.softmax(rel_logits.float(), dim=-1)
    rel_fg, rel_labels = rel_prob[..., 1:].max(dim=-1)
    return rel_prob, rel_fg, rel_labels + 1


def _triple_order(rel_fg, obj_scores, pair_idx, pair_mask):
    """The pairs sorted by triple score rel · subj · obj, descending and
    stable (``jnp.argsort`` is stable too), masked pairs last: returns a
    function that reorders a (B, P, ...) tensor so."""
    si, oi = pair_idx[..., 0].long(), pair_idx[..., 1].long()
    triple = (rel_fg * torch.gather(obj_scores, 1, si)
              * torch.gather(obj_scores, 1, oi))
    triple = torch.where(pair_mask, triple,
                         torch.full((), -float("inf"), device=triple.device))
    order = torch.argsort(-triple, dim=1, stable=True)

    def take(x):
        idx = order.reshape(order.shape + (1,) * (x.dim() - 2))
        return torch.gather(x, 1, idx.expand(order.shape + x.shape[2:]))

    return take


class SGDetPrediction(NamedTuple):
    boxes: torch.Tensor       # (B, N, 4) boxes_per_cls[i, label]
    obj_labels: torch.Tensor  # (B, N) re-NMS'd object classes
    obj_scores: torch.Tensor  # (B, N)
    det_mask: torch.Tensor    # (B, N)
    pair_idx: torch.Tensor    # (B, P, 2) sorted by triple score desc
    rel_scores: torch.Tensor  # (B, P, C)
    rel_labels: torch.Tensor  # (B, P)
    pair_mask: torch.Tensor   # (B, P)


def sgdet_objects(obj_dists: torch.Tensor, boxes_per_cls: torch.Tensor,
                  det_mask: torch.Tensor, later_nms_thres: float = 0.3):
    """SGDet's final objects: the late ``obj_prediction_nms`` at
    ``later_nms_thres`` re-picks each detection's class from the
    detector's logits (B, N, C); its score is that class's softmax
    probability (the background's zeroed) and its box that class's
    ``boxes_per_cls`` (B, N, C, 4) row.  Returns (labels int64, scores,
    boxes)."""
    obj_pred = obj_prediction_nms(boxes_per_cls, obj_dists, later_nms_thres,
                                  valid_mask=det_mask).long()
    obj_prob = torch.softmax(obj_dists.float(), dim=-1)
    obj_prob[..., 0] = 0.0
    obj_scores = torch.gather(obj_prob, 2, obj_pred[..., None])[..., 0]
    idx = obj_pred[..., None, None].expand(obj_pred.shape + (1, 4))
    return obj_pred, obj_scores, torch.gather(boxes_per_cls, 2, idx)[:, :, 0]


def postprocess_relations_sgdet(rel_logits: torch.Tensor, obj_dists: torch.Tensor,
                                pair_idx: torch.Tensor, pair_mask: torch.Tensor,
                                boxes_per_cls: torch.Tensor, det_mask: torch.Tensor,
                                later_nms_thres: float = 0.3) -> SGDetPrediction:
    """The SGDet post-processor: the final objects of :func:`sgdet_objects`
    (the late NMS on the detector's logits ``obj_dists``), and the
    triplets sorted by rel · subj · obj score (stable)."""
    obj_pred, obj_scores, boxes = sgdet_objects(obj_dists, boxes_per_cls,
                                                det_mask, later_nms_thres)
    rel_prob, rel_fg, rel_labels = _rel_scores(rel_logits)
    take = _triple_order(rel_fg, obj_scores, pair_idx, pair_mask)
    return SGDetPrediction(
        boxes=boxes, obj_labels=obj_pred.to(torch.int32), obj_scores=obj_scores,
        det_mask=det_mask, pair_idx=take(pair_idx), rel_scores=take(rel_prob),
        rel_labels=take(rel_labels), pair_mask=take(pair_mask))
