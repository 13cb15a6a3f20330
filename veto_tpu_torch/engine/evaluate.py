"""The evaluation steps (``veto_tpu/engine/train.py`` ``make_eval_step`` and
``make_sgdet_eval_step``) and their feed into the evaluators.

PredCls and SGCls: ``eval_step(batch)`` builds every candidate pair of the
GT boxes (``prepare_test_pairs``, capped at ``max_pairs``), runs the model,
and ranks the triplets (``postprocess_relations``).  SGDet: the model's
detection cascade gives the boxes (``SGGModel.detect``), the pairs are
those of the detections by score product (optionally only overlapping
ones), the relation head runs on them, and ``postprocess_relations_sgdet``
re-picks the classes (the late object NMS) and ranks the triplets.
MEET (``make_meet_eval_step``, every mode): the same pairs and model,
each group's best member of each pair as a candidate, ranked over the G·P
candidates of an image (voting with 3 experts a group); the object labels
and scores come from the proposals' logits (in SGDet from the late NMS).
Results stay padded and masked, one shape per batch.  Every step runs
under ``torch.inference_mode``.

The legacy predictors take the same steps: their relation output is
post-processed with the proposals' ``predict_logits``, and their refined
``obj_dists`` are dropped, as the JAX package drops them
(``OBJECT_CLASSIFICATION_REFINE`` is off in every shipped config).  In
SGDet their ``relate`` gets the true image sizes and the detections'
``boxes_per_cls`` (the Motifs and Transformer late NMS of their refined
labels); in SGDet MEET it gets neither, as the JAX package's MEET step
calls it (ROADMAP queue C).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.relation.postprocess import (
    RelPrediction, SGDetPrediction, object_predictions, postprocess_relations,
    postprocess_relations_sgdet, sgdet_objects,
)
from ..models.relation.predictor_meet import (
    MeetConfig, MeetPrediction, postprocess_meet,
)
from ..models.relation.sampling import prepare_test_pairs
from ..models.sgg import check_mode


def make_eval_step(model, max_pairs: int = 2048, mode: str = "predcls",
                   later_nms_thres: float = 0.3, require_overlap: bool = False):
    """(SGGBatch of tensors) → RelPrediction (SGDetPrediction in SGDet),
    batched.  ``later_nms_thres`` (``relation.later_nms_prediction_thres``)
    and ``require_overlap`` (``test.relation_require_overlap``) are SGDet's:
    the JAX package's PredCls / SGCls step takes neither."""
    check_mode(mode)
    if mode != model.mode:
        raise ValueError(f"mode {mode!r} for a model built for {model.mode!r}")
    if mode == "sgdet":
        return _sgdet_eval_step(model, max_pairs, later_nms_thres,
                                require_overlap)

    @torch.inference_mode()
    def eval_step(batch) -> RelPrediction:
        scores = batch.box_mask.float()
        pair_idx, pair_mask = prepare_test_pairs(batch.box_mask, scores,
                                                 max_pairs=max_pairs)
        out = model(batch.images, batch.depth, batch.boxes, batch.box_mask,
                    batch.labels, batch.obj_logits, pair_idx, pair_mask)
        # the post-processor reads the proposals' predict_logits (the ±1000
        # GT injection in PredCls, the frozen box head's logits in SGCls),
        # not the predictor's obj_dists
        return postprocess_relations(out.rel_logits, out.predict_logits,
                                     pair_idx, pair_mask)

    return eval_step


def _sgdet_eval_step(model, max_pairs, later_nms_thres, require_overlap):
    @torch.inference_mode()
    def eval_step(batch) -> SGDetPrediction:
        det = model.detect(batch.images, batch.sizes)
        dets = det.detections
        pair_idx, pair_mask = prepare_test_pairs(
            dets.mask, dets.scores, max_pairs=max_pairs, boxes=dets.boxes,
            require_overlap=require_overlap)
        out = model.relate(det.features, batch.depth, dets.boxes, dets.mask,
                           dets.labels, pair_idx, det.predict_logits,
                           image_sizes=batch.sizes,
                           boxes_per_cls=dets.boxes_per_cls)
        # the late NMS reads the detector's logits on the kept detections,
        # not the predictor's one-hot obj_dists (OBJECT_CLASSIFICATION_REFINE
        # is off in every shipped config)
        return postprocess_relations_sgdet(
            out.rel_logits, det.predict_logits, pair_idx, pair_mask,
            dets.boxes_per_cls, dets.mask, later_nms_thres=later_nms_thres)

    return eval_step


class MeetEval(NamedTuple):
    """The MEET eval step's output."""
    prediction: MeetPrediction  # (B, G*P, ...) candidates, (B, N) objects
    boxes: torch.Tensor         # (B, N, 4): the GT boxes, in SGDet the picks
    det_mask: torch.Tensor      # (B, N)


def make_meet_eval_step(model, meet: MeetConfig, max_pairs: int = 2048,
                        mode: str = "predcls", later_nms_thres: float = 0.3,
                        require_overlap: bool = False):
    """(SGGBatch of tensors) → :class:`MeetEval` (a ``MeetPrediction``, the
    boxes and their mask), for a model built with ``meet``'s groups."""
    check_mode(mode)
    if mode != model.mode:
        raise ValueError(f"mode {mode!r} for a model built for {model.mode!r}")
    num_rel = len(meet.incre_idx)

    @torch.inference_mode()
    def eval_step(batch) -> MeetEval:
        if mode == "sgdet":
            det = model.detect(batch.images, batch.sizes)
            dets = det.detections
            pair_idx, pair_mask = prepare_test_pairs(
                dets.mask, dets.scores, max_pairs=max_pairs, boxes=dets.boxes,
                require_overlap=require_overlap)
            # the true sizes and per-class boxes, as the plain SGDet step
            # passes them (the JAX MEET step passes neither: ROADMAP queue C)
            glogits = model.relate(det.features, batch.depth, dets.boxes,
                                   dets.mask, dets.labels, pair_idx,
                                   det.predict_logits, image_sizes=batch.sizes,
                                   boxes_per_cls=dets.boxes_per_cls).group_logits
            # the late NMS on the frozen box head's logits
            obj_labels, obj_scores, boxes = sgdet_objects(
                det.predict_logits, dets.boxes_per_cls, dets.mask,
                later_nms_thres)
            obj_labels, det_mask = obj_labels.to(torch.int32), dets.mask
        else:
            pair_idx, pair_mask = prepare_test_pairs(
                batch.box_mask, batch.box_mask.float(), max_pairs=max_pairs)
            out = model(batch.images, batch.depth, batch.boxes, batch.box_mask,
                        batch.labels, batch.obj_logits, pair_idx, pair_mask)
            glogits = out.rel_logits
            # predict_logits, not the predictor's obj_dists
            obj_labels, obj_scores = object_predictions(out.predict_logits)
            boxes, det_mask = batch.boxes, batch.box_mask
        preds = postprocess_meet(meet, glogits, obj_labels, obj_scores,
                                 pair_idx, pair_mask, num_rel)
        return MeetEval(preds, boxes, det_mask)

    return eval_step


def to_numpy(preds):
    """A prediction tuple's tensors (nested tuples too) as numpy arrays, on
    the host."""
    if torch.is_tensor(preds):
        return preds.detach().cpu().numpy()
    return type(preds)(*[to_numpy(t) for t in preds])


def _scale(rec, input_size) -> np.ndarray:
    """(1, 4) factors from the network input's box coordinates to the
    record's original image (1 when the record names no ``orig_size``)."""
    ow, oh = rec.get("orig_size", (None, None))
    if ow is None:
        return np.ones((1, 4), np.float32)
    iw, ih = float(input_size[0]), float(input_size[1])
    return np.asarray([[ow / iw, oh / ih, ow / iw, oh / ih]], np.float32)


def accumulate_eval(preds, recs, evaluator, input_sizes=None,
                    coco_evaluator=None) -> None:
    """Feed one batch of padded predictions (numpy) into ``evaluator``, one
    image per record (the JAX tool's ``accumulate_eval``).  GT boxes: the
    record's boxes are the predictions' boxes.  SGDet: the valid
    detections, their pair indices renumbered onto them, boxes scaled back
    to the record's original size by ``input_sizes`` (B, 2); an image
    without a detection or a pair is skipped; ``coco_evaluator`` also takes
    the detections (COCO bbox mAP).  MEET (a :class:`MeetEval`), in every
    mode: the boxes of the step, scaled back so, the pairs renumbered onto
    the valid ones; an image without a surviving pair (voting can mask all
    out) or box is skipped; ``coco_evaluator`` takes the detections too
    (the JAX tool's MEET branch feeds it nothing)."""
    if isinstance(preds, MeetEval):
        p = preds.prediction
        for i, rec in enumerate(recs):
            dm = np.asarray(preds.det_mask[i], bool)
            pm = np.asarray(p.pair_mask[i], bool)
            if dm.sum() == 0 or pm.sum() == 0:
                continue
            remap = np.cumsum(dm) - 1
            boxes = preds.boxes[i][dm]
            if input_sizes is not None:
                boxes = boxes * _scale(rec, input_sizes[i])
            labels, scores = p.obj_labels[i][dm], p.obj_scores[i][dm]
            evaluator.add_image(rec["boxes"], rec["labels"], rec["rel_tuples"],
                                boxes, labels, scores, remap[p.pair_idx[i][pm]],
                                p.rel_scores[i][pm])
            if coco_evaluator is not None:
                coco_evaluator.add_image(rec["boxes"], rec["labels"], boxes,
                                         labels, scores)
        return
    if not isinstance(preds, SGDetPrediction):
        for i, rec in enumerate(recs):
            n = len(rec["boxes"])
            pm = np.asarray(preds.pair_mask[i], bool)
            evaluator.add_image(
                rec["boxes"], rec["labels"], rec["rel_tuples"], rec["boxes"],
                preds.obj_labels[i][:n], preds.obj_scores[i][:n],
                preds.pair_idx[i][pm], preds.rel_scores[i][pm])
        return
    for i, rec in enumerate(recs):
        dm = np.asarray(preds.det_mask[i], bool)
        pm = np.asarray(preds.pair_mask[i], bool)
        if dm.sum() == 0 or pm.sum() == 0:
            continue
        remap = np.cumsum(dm) - 1
        boxes = preds.boxes[i][dm]
        if input_sizes is not None:
            boxes = boxes * _scale(rec, input_sizes[i])
        labels, scores = preds.obj_labels[i][dm], preds.obj_scores[i][dm]
        evaluator.add_image(rec["boxes"], rec["labels"], rec["rel_tuples"],
                            boxes, labels, scores, remap[preds.pair_idx[i][pm]],
                            preds.rel_scores[i][pm])
        if coco_evaluator is not None:
            coco_evaluator.add_image(rec["boxes"], rec["labels"], boxes, labels,
                                     scores)
