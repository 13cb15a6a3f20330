"""COCO-protocol bbox mAP, pure NumPy (a copy of
``veto_tpu/evaluation/coco_map.py``, kept in the port so that it loads no
module of the JAX package).

Replaces the reference's faux-COCO + pycocotools COCOeval pass for sgdet
detection quality (vg_eval.py:67-182): same protocol — IoU thresholds
0.50:0.05:0.95, 101-point interpolated precision over recall 0:0.01:1,
per-class AP averaged over classes with ground truth, maxDets=100, area
'all'.  pycocotools is not available in this environment; this module
reimplements the exact evaluation math (greedy per-image matching by
descending score to the highest-IoU unmatched GT).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)
RECALL_THRESHOLDS = np.linspace(0.0, 1.0, 101)


def _iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Plain (exclusive) IoU — COCO boxes are xywh-continuous; the reference
    converts xyxy→xywh with w = x2 - x1 (vg_eval.py:151-160), i.e. NO +1."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-12)


class CocoMapEvaluator:
    """Accumulate per-image detections; compute COCO mAP at the end."""

    def __init__(self, num_classes: int, max_dets: int = 100):
        self.num_classes = num_classes
        self.max_dets = max_dets
        self.reset()

    def reset(self):
        # per class: list of (scores, tp-flags per iou threshold) and GT count
        self._scores: List[List[np.ndarray]] = [[] for _ in range(self.num_classes)]
        self._matches: List[List[np.ndarray]] = [[] for _ in range(self.num_classes)]
        self._num_gt = np.zeros(self.num_classes, np.int64)

    def add_image(
        self,
        gt_boxes: np.ndarray,     # (G, 4) xyxy
        gt_labels: np.ndarray,    # (G,)
        pred_boxes: np.ndarray,   # (D, 4) xyxy
        pred_labels: np.ndarray,  # (D,)
        pred_scores: np.ndarray,  # (D,)
    ):
        gt_boxes = np.asarray(gt_boxes, np.float64)
        pred_boxes = np.asarray(pred_boxes, np.float64)
        order = np.argsort(-np.asarray(pred_scores))[: self.max_dets]
        pred_boxes, pred_labels = pred_boxes[order], np.asarray(pred_labels)[order]
        pred_scores = np.asarray(pred_scores)[order]

        for c in np.unique(np.concatenate([gt_labels, pred_labels])).astype(int):
            if c <= 0:
                continue
            g = gt_boxes[np.asarray(gt_labels) == c]
            d_idx = np.where(pred_labels == c)[0]
            self._num_gt[c] += len(g)
            if len(d_idx) == 0:
                continue
            d = pred_boxes[d_idx]
            s = pred_scores[d_idx]
            iou = _iou_xyxy(d, g)  # (D, G), dets already score-sorted
            t = len(IOU_THRESHOLDS)
            tp = np.zeros((t, len(d)), bool)
            for ti, thr in enumerate(IOU_THRESHOLDS):
                taken = np.zeros(len(g), bool)
                for di in range(len(d)):
                    if len(g) == 0:
                        break
                    cand = np.where(~taken & (iou[di] >= thr))[0]
                    if len(cand) == 0:
                        continue
                    best = cand[np.argmax(iou[di][cand])]
                    taken[best] = True
                    tp[ti, di] = True
            self._scores[c].append(s)
            self._matches[c].append(tp)

    def aggregate(self) -> Dict[str, float]:
        t = len(IOU_THRESHOLDS)
        ap = np.full((t, self.num_classes), np.nan)
        for c in range(1, self.num_classes):
            if self._num_gt[c] == 0:
                continue
            if not self._scores[c]:
                ap[:, c] = 0.0
                continue
            scores = np.concatenate(self._scores[c])
            tps = np.concatenate(self._matches[c], axis=1)  # (T, total_dets)
            order = np.argsort(-scores, kind="mergesort")
            tps = tps[:, order]
            for ti in range(t):
                tp_cum = np.cumsum(tps[ti])
                fp_cum = np.cumsum(~tps[ti])
                recall = tp_cum / self._num_gt[c]
                precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
                # monotone non-increasing precision envelope (COCOeval)
                for i in range(len(precision) - 1, 0, -1):
                    precision[i - 1] = max(precision[i - 1], precision[i])
                # 101-point interpolation
                idx = np.searchsorted(recall, RECALL_THRESHOLDS, side="left")
                p = np.zeros(len(RECALL_THRESHOLDS))
                ok = idx < len(precision)
                p[ok] = precision[idx[ok]]
                ap[ti, c] = p.mean()
        valid = ~np.isnan(ap)
        mean_ap = float(ap[valid].mean()) if valid.any() else 0.0
        ap50 = ap[0][~np.isnan(ap[0])]
        ap75 = ap[5][~np.isnan(ap[5])]
        return {
            "mAP": mean_ap,
            "AP50": float(ap50.mean()) if len(ap50) else 0.0,
            "AP75": float(ap75.mean()) if len(ap75) else 0.0,
        }
