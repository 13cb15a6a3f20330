"""Host-side batch assembly (``veto_tpu/data/batching.py``): ragged
per-image records → a fixed-shape numpy :class:`SGGBatch`.  Images
zero-pad to the bucket shape, boxes and labels to the box budget, and
relations arrive as a dense (N, N) predicate matrix."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..engine.batch import SGGBatch


def make_sgg_batch(records: Sequence[Dict], image_shape: tuple, max_boxes: int,
                   num_obj_classes: int = 151) -> SGGBatch:
    """Each record: image (H, W, 3), depth (H, W, 1) or None, boxes (n, 4),
    labels (n,), rel_matrix (n, n), size (2,) = (w, h)."""
    b = len(records)
    h, w = image_shape
    images = np.zeros((b, h, w, 3), np.float32)
    depth = np.zeros((b, h, w, 1), np.float32)
    boxes = np.zeros((b, max_boxes, 4), np.float32)
    box_mask = np.zeros((b, max_boxes), bool)
    labels = np.zeros((b, max_boxes), np.int32)
    rel_matrix = np.zeros((b, max_boxes, max_boxes), np.int32)
    sizes = np.zeros((b, 2), np.int32)
    for i, rec in enumerate(records):
        ih, iw = rec["image"].shape[:2]
        images[i, :ih, :iw] = rec["image"]
        if rec.get("depth") is not None:
            depth[i, :ih, :iw] = rec["depth"]
        n = min(len(rec["boxes"]), max_boxes)
        boxes[i, :n] = rec["boxes"][:n]
        box_mask[i, :n] = True
        labels[i, :n] = rec["labels"][:n]
        rel_matrix[i, :n, :n] = rec["rel_matrix"][:n, :n]
        sizes[i] = rec["size"]
    # PredCls: the detector logits are the GT one-hot
    obj_logits = np.eye(num_obj_classes, dtype=np.float32)[labels] * box_mask[..., None]
    return SGGBatch(images=images, depth=depth, boxes=boxes, box_mask=box_mask,
                    labels=labels, obj_logits=obj_logits, rel_matrix=rel_matrix,
                    sizes=sizes)
