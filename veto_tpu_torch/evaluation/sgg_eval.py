"""Scene-graph-generation metrics (host-side NumPy).

The port's own copy of ``veto_tpu/evaluation/sgg_eval.py``
(``SGGEvaluator`` and its helpers): the same metric math — R@K, mR@K,
ngR@K, ng-mR@K, zR@K, aR@K, A@K and the VG head/body/tail split — on
numpy arrays, so the port never imports the JAX package, and the
zero-shot triplet set (from a reference ``zeroshot_triplet.pytorch`` file,
or derived from a train and an eval split).  The stage-wise diagnostics
(``StagewiseEvaluator``) are not ported in this slice.

Matching semantics:
  * predictions must arrive sorted by triple score (the relation
    post-processor's job) — R@K truncates that order
  * triplet equality + per-part IoU >= iou_thres (inclusive-pixel IoU)
  * phrdet mode matches on the union box instead
  * predcls overrides pred boxes/classes with GT and obj_scores with ones
"""

from __future__ import annotations

from functools import reduce
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ----------------------------------------------------------------------
# numpy helpers (reference pysgg/utils/miscellaneous.py:47-86)
# ----------------------------------------------------------------------
def intersect_2d(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """Row-wise equality matrix: (m1, n) × (m2, n) → (m1, m2) bool."""
    if x1.shape[1] != x2.shape[1]:
        raise ValueError("inputs must share the column count")
    return (x1[:, None, :] == x2[None, :, :]).all(-1)


def argsort_desc(scores: np.ndarray) -> np.ndarray:
    """Indices of a descending flat sort, unraveled to per-dim columns."""
    return np.column_stack(np.unravel_index(np.argsort(-scores.ravel()), scores.shape))


def np_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise IoU with the inclusive-pixel (+1) convention."""
    area1 = (boxes1[:, 2] - boxes1[:, 0] + 1) * (boxes1[:, 3] - boxes1[:, 1] + 1)
    area2 = (boxes2[:, 2] - boxes2[:, 0] + 1) * (boxes2[:, 3] - boxes2[:, 1] + 1)
    lt = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = np.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = np.clip(rb - lt + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None, :] - inter)


# ----------------------------------------------------------------------
# triplet matching kernel (reference sgg_eval.py:44-116)
# ----------------------------------------------------------------------
def make_triplets(
    relations: np.ndarray,
    classes: np.ndarray,
    boxes: np.ndarray,
    predicate_scores: Optional[np.ndarray] = None,
    class_scores: Optional[np.ndarray] = None,
):
    """(s_idx, o_idx, p) relations → (s_cls, p, o_cls) triplets + box pairs."""
    sub, obj, pred = relations[:, 0], relations[:, 1], relations[:, 2]
    triplets = np.column_stack((classes[sub], pred, classes[obj]))
    triplet_boxes = np.column_stack((boxes[sub], boxes[obj]))
    scores = None
    if predicate_scores is not None and class_scores is not None:
        scores = np.column_stack(
            (class_scores[sub], predicate_scores, class_scores[obj])
        )
    return triplets, triplet_boxes, scores


def match_triplets(
    gt_triplets: np.ndarray,
    pred_triplets: np.ndarray,
    gt_boxes: np.ndarray,
    pred_boxes: np.ndarray,
    iou_thres: float,
    phrdet: bool = False,
) -> List[List[int]]:
    """For each prediction, the list of GT relation indices it matches.

    A match requires label-triplet equality and subject & object IoU >=
    ``iou_thres`` (or union-box IoU in phrdet mode).
    """
    keeps = intersect_2d(gt_triplets, pred_triplets)
    pred_to_gt: List[List[int]] = [[] for _ in range(pred_boxes.shape[0])]
    for gt_ind in np.where(keeps.any(1))[0]:
        gt_box = gt_boxes[gt_ind]
        keep_inds = keeps[gt_ind]
        boxes = pred_boxes[keep_inds]
        if phrdet:
            gt_u = np.concatenate(
                (gt_box.reshape(2, 4).min(0)[:2], gt_box.reshape(2, 4).max(0)[2:])
            )
            pred_u = np.concatenate(
                (
                    boxes.reshape(-1, 2, 4).min(1)[:, :2],
                    boxes.reshape(-1, 2, 4).max(1)[:, 2:],
                ),
                axis=1,
            )
            ok = np_iou(gt_u[None], pred_u)[0] >= iou_thres
        else:
            sub_iou = np_iou(gt_box[None, :4], boxes[:, :4])[0]
            obj_iou = np_iou(gt_box[None, 4:], boxes[:, 4:])[0]
            ok = (sub_iou >= iou_thres) & (obj_iou >= iou_thres)
        for i in np.where(keep_inds)[0][ok]:
            pred_to_gt[i].append(int(gt_ind))
    return pred_to_gt


def _union_upto(pred_to_gt: Sequence[Sequence[int]], k: int) -> np.ndarray:
    if len(pred_to_gt) == 0 or k <= 0:
        return np.array([], dtype=np.int64)
    # reduce() with a single element returns it untouched (a plain list)
    return np.asarray(reduce(np.union1d, pred_to_gt[:k]), dtype=np.int64)


# Head/body/tail split of the VG-50 predicate vocabulary in ORIGINAL
# (alphabetical) predicate order; index 0 is background
# (reference defaults.py:545-548 LONGTAIL_PART_DICT).
VG_LONGTAIL_PART_DICT: Tuple[Optional[str], ...] = (
    None, "b", "t", "t", "t", "t", "t", "t", "b", "t", "t", "t", "t", "t",
    "t", "t", "t", "t", "t", "t", "h", "b", "b", "b", "t", "t", "t", "t",
    "t", "b", "h", "h", "t", "t", "t", "t", "t", "t", "b", "t", "b", "b",
    "t", "b", "t", "t", "t", "t", "h", "b", "b",
)


def vg_longtail_parts(reordered: bool = True) -> List[Optional[str]]:
    """The VG part dict permuted for the active predicate id space.

    With REORDER_FREQ_BASED (the VETO default) predicate ids are frequency
    ranks; the static dict above is in original order, so remap via
    predicate_new_order (the reference applies the dict un-permuted — a
    sloppiness we do not reproduce)."""
    if not reordered:
        return list(VG_LONGTAIL_PART_DICT)
    from ..data.predicate_stats import VG_PREDICATE_NEW_ORDER

    out: List[Optional[str]] = [None] * len(VG_LONGTAIL_PART_DICT)
    for old_id, part in enumerate(VG_LONGTAIL_PART_DICT):
        out[VG_PREDICATE_NEW_ORDER[old_id]] = part
    return out


# ----------------------------------------------------------------------
# the evaluator
# ----------------------------------------------------------------------
class SGGEvaluator:
    """Accumulates per-image SGG statistics and aggregates them.

    Args:
      mode: 'predcls' | 'sgcls' | 'sgdet' | 'phrdet'.
      num_rel_classes: predicate vocabulary size including background.
      rel_names: optional names (index 0 = background) for reports.
      ks: recall cutoffs.
      iou_thres: box-match threshold (TEST default 0.5).
      zeroshot_triplets: (Z, 3) array of unseen (s_cls, o_cls, p) label
        triples (note the reference's column order, sgg_eval.py:283-289).
    """

    def __init__(
        self,
        mode: str,
        num_rel_classes: int,
        rel_names: Optional[Sequence[str]] = None,
        ks: Sequence[int] = (20, 50, 100),
        iou_thres: float = 0.5,
        zeroshot_triplets: Optional[np.ndarray] = None,
        nogc_top: int = 100,
        longtail_parts: Optional[Sequence[Optional[str]]] = None,
    ):
        if mode not in ("predcls", "sgcls", "sgdet", "phrdet"):
            raise ValueError(f"invalid mode {mode}")
        self.mode = mode
        self.num_rel = num_rel_classes
        self.rel_names = list(rel_names) if rel_names else [str(i) for i in range(num_rel_classes)]
        self.ks = tuple(ks)
        self.iou_thres = iou_thres
        self.zeroshot_triplets = zeroshot_triplets
        self.nogc_top = nogc_top
        # 'h'/'b'/'t' per predicate id (index 0 = background, ignored) —
        # reference LONGTAIL_PART_DICT (defaults.py:545-548)
        self.longtail_parts = (
            list(longtail_parts) if longtail_parts is not None else None
        )
        self.reset()

    def reset(self):
        ks = self.ks
        self.recall = {k: [] for k in ks}
        self.recall_nogc = {k: [] for k in ks}
        self.zeroshot_recall = {k: [] for k in ks}
        self.accuracy_hit = {k: [] for k in ks}
        self.accuracy_count = {k: [] for k in ks}
        # accumulate recall aR@K = dataset-level sum(hits)/sum(gt)
        # (reference SGAccumulateRecall, sgg_eval.py:557-581 — note its
        # _recall_hit containers are never registered there [:388-389
        # commented out]; this is the working rebuild of the intent)
        self.acc_recall_hit = {k: [] for k in ks}
        self.acc_recall_count = {k: [] for k in ks}
        # per-class recall collections; index 0 doubles as the "all" bucket
        self.mean_recall_collect = {k: [[] for _ in range(self.num_rel)] for k in ks}
        self.ng_mean_recall_collect = {k: [[] for _ in range(self.num_rel)] for k in ks}
        self.num_images = 0

    # ------------------------------------------------------------------
    def add_image(
        self,
        gt_boxes: np.ndarray,
        gt_classes: np.ndarray,
        gt_rels: np.ndarray,
        pred_boxes: np.ndarray,
        pred_classes: np.ndarray,
        obj_scores: np.ndarray,
        pred_rel_inds: np.ndarray,
        rel_scores: np.ndarray,
    ) -> None:
        """Evaluate one image.

        ``pred_rel_inds`` (P, 2) must already be sorted by triple score
        descending; ``rel_scores`` is the (P, C) per-predicate softmax with
        background at column 0.
        """
        gt_rels = np.asarray(gt_rels)
        if gt_rels.shape[0] == 0:
            return  # reference skips relation-less images (vg_eval.py:472)
        self.num_images += 1

        if self.mode == "predcls":
            pred_boxes = gt_boxes
            pred_classes = gt_classes
            obj_scores = np.ones(gt_classes.shape[0])

        # ---------------- pair accuracy bookkeeping (predcls/sgcls)
        if self.mode != "sgdet" and self.mode != "phrdet":
            pred_pair_key = pred_rel_inds[:, 0] * 1024 + pred_rel_inds[:, 1]
            gt_pair_key = gt_rels[:, 0] * 1024 + gt_rels[:, 1]
            pred_pair_in_gt = np.isin(pred_pair_key, gt_pair_key)
        else:
            pred_pair_in_gt = None

        # ---------------- zero-shot bookkeeping
        zs_idx: List[int] = []
        if self.zeroshot_triplets is not None:
            gt_zs = np.column_stack(
                (gt_classes[gt_rels[:, 0]], gt_classes[gt_rels[:, 1]], gt_rels[:, 2])
            )
            zs_idx = np.where(intersect_2d(gt_zs, self.zeroshot_triplets).any(-1))[0].tolist()

        if pred_rel_inds.shape[0] == 0:
            return

        # ---------------- graph-constraint recall
        pred_rels = np.column_stack((pred_rel_inds, 1 + rel_scores[:, 1:].argmax(1)))
        pred_scores = rel_scores[:, 1:].max(1)

        gt_triplets, gt_triplet_boxes, _ = make_triplets(gt_rels, gt_classes, gt_boxes)
        pred_triplets, pred_triplet_boxes, _ = make_triplets(
            pred_rels, pred_classes, pred_boxes, pred_scores, obj_scores
        )
        pred_to_gt = match_triplets(
            gt_triplets,
            pred_triplets,
            gt_triplet_boxes,
            pred_triplet_boxes,
            self.iou_thres,
            phrdet=self.mode == "phrdet",
        )

        # ---------------- no-graph-constraint recall: top-N over P×(C-1)
        overall = (
            obj_scores[pred_rel_inds].prod(1)[:, None] * rel_scores[:, 1:]
        )
        nogc_inds = argsort_desc(overall)[: self.nogc_top]
        nogc_pred_rels = np.column_stack(
            (pred_rel_inds[nogc_inds[:, 0]], nogc_inds[:, 1] + 1)
        )
        nogc_triplets, nogc_triplet_boxes, _ = make_triplets(
            nogc_pred_rels, pred_classes, pred_boxes
        )
        nogc_pred_to_gt = match_triplets(
            gt_triplets,
            nogc_triplets,
            gt_triplet_boxes,
            nogc_triplet_boxes,
            self.iou_thres,
            phrdet=self.mode == "phrdet",
        )

        num_gt = float(gt_rels.shape[0])
        gt_labels = gt_rels[:, 2].astype(np.int64)

        for k in self.ks:
            match = _union_upto(pred_to_gt, k)
            self.recall[k].append(len(match) / num_gt)
            self.acc_recall_hit[k].append(float(len(match)))
            self.acc_recall_count[k].append(num_gt)
            self._collect_per_class(self.mean_recall_collect[k], gt_labels, match)

            ng_match = _union_upto(nogc_pred_to_gt, k)
            self.recall_nogc[k].append(len(ng_match) / num_gt)
            self._collect_per_class(self.ng_mean_recall_collect[k], gt_labels, ng_match)

            if zs_idx:
                match_list = match.tolist()
                hit = len(zs_idx) + len(match_list) - len(set(zs_idx + match_list))
                self.zeroshot_recall[k].append(hit / len(zs_idx))

            if pred_pair_in_gt is not None:
                gt_pair_p2g = [p for p, f in zip(pred_to_gt, pred_pair_in_gt) if f]
                gm = _union_upto(gt_pair_p2g, k) if gt_pair_p2g else []
                self.accuracy_hit[k].append(float(len(gm)))
                self.accuracy_count[k].append(num_gt)

    def _collect_per_class(self, collect, gt_labels: np.ndarray, match: np.ndarray):
        hit = np.zeros(self.num_rel, dtype=np.int64)
        count = np.zeros(self.num_rel, dtype=np.int64)
        np.add.at(count, gt_labels, 1)
        count[0] = len(gt_labels)
        if len(match):
            matched_labels = gt_labels[np.asarray(match, dtype=np.int64)]
            np.add.at(hit, matched_labels, 1)
            hit[0] = len(match)
        for c in range(self.num_rel):
            if count[c] > 0:
                collect[c].append(hit[c] / count[c])

    # ------------------------------------------------------------------
    def aggregate(self) -> Dict[str, Dict[int, float]]:
        """Final metric dict; mR is per-class mean over images then classes
        (zero for never-seen classes, reference sgg_eval.py:445-465)."""

        def mean_or_zero(vals):
            return float(np.mean(vals)) if len(vals) else 0.0

        def mean_recall(collect):
            per_class = [
                mean_or_zero(collect[c]) for c in range(1, self.num_rel)
            ]
            return float(np.mean(per_class)) if per_class else 0.0, per_class

        out: Dict[str, Dict[int, float]] = {
            "R": {k: mean_or_zero(v) for k, v in self.recall.items()},
            "ngR": {k: mean_or_zero(v) for k, v in self.recall_nogc.items()},
            "zR": {k: mean_or_zero(v) for k, v in self.zeroshot_recall.items()},
            "aR": {
                k: float(np.sum(self.acc_recall_hit[k]))
                / (float(np.sum(self.acc_recall_count[k])) + 1e-10)
                for k in self.ks
            },
            "mR": {},
            "ngmR": {},
            "A": {},
            "mR_per_class": {},
        }
        for k in self.ks:
            mr, per_class = mean_recall(self.mean_recall_collect[k])
            out["mR"][k] = mr
            out["mR_per_class"][k] = per_class
            out["ngmR"][k] = mean_recall(self.ng_mean_recall_collect[k])[0]
            if self.accuracy_count[k]:
                out["A"][k] = float(
                    np.mean(self.accuracy_hit[k]) / np.mean(self.accuracy_count[k])
                )
        if self.longtail_parts is not None:
            # head/body/tail split of the per-class mR list
            # (reference vg_eval.py longtail_part_eval:190-206: cate_rec_list
            # index idx maps to predicate id idx + 1)
            out["longtail"] = {}
            for k in self.ks:
                buckets: Dict[str, List[float]] = {"h": [], "b": [], "t": []}
                for idx, rec in enumerate(out["mR_per_class"][k]):
                    part = self.longtail_parts[idx + 1]
                    if part in buckets:
                        buckets[part].append(rec)
                out["longtail"][k] = {
                    part: (float(np.mean(v)) if v else 0.0)
                    for part, v in buckets.items()
                }
        return out

    def summary_string(self) -> str:
        agg = self.aggregate()
        lines = [f"SGG eval ({self.mode}, {self.num_images} images):"]
        for name in ("R", "mR", "ngR", "ngmR", "zR", "aR", "A"):
            vals = agg.get(name) or {}
            if vals:
                body = "; ".join(f"{name}@{k}: {v:.4f}" for k, v in sorted(vals.items()))
                lines.append("  " + body)
        if "longtail" in agg:
            lines.append("longtail part recall:")
            for k, parts in sorted(agg["longtail"].items()):
                lines.append(
                    f"  Top{k:4}: head: {parts['h']:.4f} body: {parts['b']:.4f} "
                    f"tail: {parts['t']:.4f}"
                )
        return "\n".join(lines)


def load_zeroshot_triplets_file(path: str) -> np.ndarray:
    """The reference's serialized zero-shot triplets
    (``zeroshot_triplet.pytorch``, rows (s_cls, o_cls, predicate) in the
    ORIGINAL VG predicate order: usable only with
    ``data.reorder_freq_based`` off; with it on, derive them with
    :func:`compute_zeroshot_triplets`)."""
    import torch

    t = torch.load(path, map_location="cpu", weights_only=False)
    return np.asarray(t, dtype=np.int64).reshape(-1, 3)


def compute_zeroshot_triplets(train_dataset, eval_dataset) -> np.ndarray:
    """The unseen-triplet set for zero-shot recall: the (subject class,
    object class, predicate) triples of the eval split's ground truth that
    never occur in the train split's, sorted.  Each dataset exposes
    ``img_info``, ``gt_classes`` and ``relationships``."""

    def triplet_set(ds):
        out = set()
        for i in range(len(ds.img_info)):
            cls = ds.gt_classes[i]
            for s, o, p in ds.relationships[i]:
                out.add((int(cls[int(s)]), int(cls[int(o)]), int(p)))
        return out

    unseen = sorted(triplet_set(eval_dataset) - triplet_set(train_dataset))
    return np.asarray(unseen, dtype=np.int64).reshape(-1, 3)
