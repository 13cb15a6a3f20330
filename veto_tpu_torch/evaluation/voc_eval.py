"""Pascal VOC detection mAP (``veto_tpu/evaluation/voc_eval.py``), host
numpy.

The VOC challenge's protocol: each class's detections matched greedily in
score order to its GT boxes, a match to a difficult box neither counted
nor penalised, IoU on integer-typed boxes (+1 on the max corners, then the
+1 of the IoU itself: ``_iou_int``, as the JAX package computes it), and
either the VOC-2007 11-point AP or the area under the every-point
interpolated precision.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np


def _iou_int(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of boxes whose max corners the caller has already moved by +1,
    with the +1 extent added again here."""
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class VOCEvaluator:
    """Accumulates per-image detections; :meth:`aggregate` returns the AP of
    each class and their nan-mean."""

    def __init__(self, iou_thresh: float = 0.5, use_07_metric: bool = True):
        self.iou_thresh = iou_thresh
        self.use_07_metric = use_07_metric
        self.reset()

    def reset(self):
        self._n_pos: Dict[int, int] = defaultdict(int)
        self._score: Dict[int, List[float]] = defaultdict(list)
        self._match: Dict[int, List[int]] = defaultdict(list)

    def add_image(self, pred_boxes: np.ndarray, pred_labels: np.ndarray,
                  pred_scores: np.ndarray, gt_boxes: np.ndarray,
                  gt_labels: np.ndarray, gt_difficult: np.ndarray = None) -> None:
        """(D, 4) xyxy, (D,), (D,) detections of one image; (G, 4), (G,) and
        (G,) bool ground truth."""
        if gt_difficult is None:
            gt_difficult = np.zeros(len(gt_boxes), bool)
        labels = np.unique(np.concatenate((pred_labels, gt_labels)).astype(int))
        for lab in labels:
            pm = pred_labels == lab
            pb = np.asarray(pred_boxes, np.float64)[pm]
            sc = np.asarray(pred_scores, np.float64)[pm]
            order = sc.argsort()[::-1]
            pb, sc = pb[order], sc[order]

            gm = gt_labels == lab
            gb = np.asarray(gt_boxes, np.float64)[gm]
            gd = gt_difficult[gm]

            self._n_pos[lab] += int(np.logical_not(gd).sum())
            self._score[lab].extend(sc.tolist())
            if len(pb) == 0:
                continue
            if len(gb) == 0:
                self._match[lab].extend([0] * len(pb))
                continue

            pb = pb.copy()
            pb[:, 2:] += 1
            gb = gb.copy()
            gb[:, 2:] += 1
            iou = _iou_int(pb, gb)
            gt_index = iou.argmax(axis=1)
            gt_index[iou.max(axis=1) < self.iou_thresh] = -1

            selec = np.zeros(len(gb), bool)
            for gi in gt_index:
                if gi >= 0:
                    if gd[gi]:
                        self._match[lab].append(-1)
                    else:
                        self._match[lab].append(1 if not selec[gi] else 0)
                    selec[gi] = True
                else:
                    self._match[lab].append(0)

    def aggregate(self) -> Dict[str, np.ndarray]:
        """``{"ap": (C,) per class (nan where a class never appeared),
        "map": their nan-mean}``."""
        if not self._n_pos:
            return {"ap": np.array([]), "map": float("nan")}
        n_cls = max(self._n_pos.keys()) + 1
        prec: List = [None] * n_cls
        rec: List = [None] * n_cls
        for lab in self._n_pos:
            score = np.asarray(self._score[lab])
            match = np.asarray(self._match[lab], np.int8)
            order = score.argsort()[::-1]
            match = match[order]
            tp = np.cumsum(match == 1)
            fp = np.cumsum(match == 0)
            with np.errstate(divide="ignore", invalid="ignore"):
                prec[lab] = tp / (fp + tp)
            if self._n_pos[lab] > 0:
                rec[lab] = tp / self._n_pos[lab]
        ap = self._ap(prec, rec)
        return {"ap": ap, "map": float(np.nanmean(ap))}

    def _ap(self, prec, rec) -> np.ndarray:
        n_cls = len(prec)
        ap = np.empty(n_cls)
        for lab in range(n_cls):
            if prec[lab] is None or rec[lab] is None:
                ap[lab] = np.nan
                continue
            if self.use_07_metric:
                a = 0.0
                for t in np.arange(0.0, 1.1, 0.1):
                    if np.sum(rec[lab] >= t) == 0:
                        p = 0.0
                    else:
                        p = np.max(np.nan_to_num(prec[lab])[rec[lab] >= t])
                    a += p / 11
                ap[lab] = a
            else:
                mpre = np.concatenate(([0], np.nan_to_num(prec[lab]), [0]))
                mrec = np.concatenate(([0], rec[lab], [1]))
                mpre = np.maximum.accumulate(mpre[::-1])[::-1]
                i = np.where(mrec[1:] != mrec[:-1])[0]
                ap[lab] = np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])
        return ap
