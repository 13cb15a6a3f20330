"""Deterministic synthetic SGG corpus (``veto_tpu/data/synthetic.py``).

Seeded numpy records with the Visual Genome schema (boxes, labels, dense
relation matrix, relation tuples, depth channel), so the evaluation path
runs without the VG files.  The same seed gives the same records as the
JAX package's dataset, draw for draw, so one batch feeds both packages.
Every record carries depth.  ``with_masks`` adds each box's instance mask
(the ellipse inscribed in the box; uint8 0/1, where the JAX dataset has
f32 of the same values) and ``with_keypoints=K`` K keypoints a box
(``[x, y, 2]`` at fixed fractions of the box), as the JAX dataset makes
them; neither draws from the seed.  The JAX dataset's depth-less,
rendered-box and deterministic-relation options serve its overfit tests
and are not ported.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticSGGDataset:
    def __init__(self, num_images: int = 16, image_size: tuple = (256, 256),
                 num_obj_classes: int = 151, num_rel_classes: int = 51,
                 max_objects: int = 20, min_objects: int = 4,
                 max_relations: int = 12, seed: int = 0,
                 with_masks: bool = False, with_keypoints: int = 0):
        self.num_images = num_images
        self.image_size = image_size
        self.num_obj_classes = num_obj_classes
        self.num_rel_classes = num_rel_classes
        self.max_objects = max_objects
        self.min_objects = min_objects
        self.max_relations = max_relations
        self.seed = seed
        self.with_masks = with_masks
        self.with_keypoints = with_keypoints

    def __len__(self) -> int:
        return self.num_images

    def __getitem__(self, idx: int) -> Dict:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        h, w = self.image_size
        n = rng.randint(self.min_objects, self.max_objects + 1)
        x1 = rng.uniform(0, w * 0.7, n)
        y1 = rng.uniform(0, h * 0.7, n)
        bw = rng.uniform(w * 0.1, w * 0.3, n)
        bh = rng.uniform(h * 0.1, h * 0.3, n)
        boxes = np.stack(
            [x1, y1, np.minimum(x1 + bw, w - 1), np.minimum(y1 + bh, h - 1)],
            axis=1).astype(np.float32)
        labels = rng.randint(1, self.num_obj_classes, n).astype(np.int32)

        rel_matrix = np.zeros((n, n), np.int32)
        for _ in range(rng.randint(1, self.max_relations + 1)):
            s, o = rng.randint(0, n, 2)
            if s != o and rel_matrix[s, o] == 0:
                rel_matrix[s, o] = rng.randint(1, self.num_rel_classes)
        rel_tuples = np.column_stack(np.nonzero(rel_matrix))
        rel_tuples = np.column_stack(
            [rel_tuples, rel_matrix[rel_tuples[:, 0], rel_tuples[:, 1]]]
        ).astype(np.int64) if len(rel_tuples) else np.zeros((0, 3), np.int64)

        image = rng.uniform(-1, 1, (h, w, 3)).astype(np.float32)
        depth = rng.uniform(-1, 1, (h, w, 1)).astype(np.float32)
        rec = {"image": image, "depth": depth, "boxes": boxes,
               "labels": labels, "rel_matrix": rel_matrix,
               "rel_tuples": rel_tuples, "size": np.array([w, h], np.int32)}
        if self.with_masks:
            # each ellipse evaluated over the pixels of its bounding square
            # only: outside it the left side exceeds 1
            masks = np.zeros((n, h, w), np.uint8)
            for j in range(n):
                xa, ya, xb, yb = boxes[j]
                cx, cy = (xa + xb) / 2, (ya + yb) / 2
                rx, ry = max((xb - xa) / 2, 1.0), max((yb - ya) / 2, 1.0)
                x0, x1 = max(int(np.floor(cx - rx)), 0), min(int(np.ceil(cx + rx)) + 1, w)
                y0, y1 = max(int(np.floor(cy - ry)), 0), min(int(np.ceil(cy + ry)) + 1, h)
                yy, xx = np.mgrid[y0:y1, x0:x1]
                masks[j, y0:y1, x0:x1] = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1.0
            rec["masks"] = masks
        if self.with_keypoints:
            k = self.with_keypoints
            fr = (np.arange(k, dtype=np.float32) + 0.5) / k
            kps = np.zeros((n, k, 3), np.float32)
            for j in range(n):
                xa, ya, xb, yb = boxes[j]
                kps[j, :, 0] = xa + fr * (xb - xa)
                kps[j, :, 1] = ya + fr[::-1] * (yb - ya)
                kps[j, :, 2] = 2.0
            rec["keypoints"] = kps
        return rec

    def batches(self, batch_size: int, max_boxes: int, rank: int = 0,
                world: int = 1):
        """Yield (numpy SGGBatch, list[record]) batches covering the dataset
        (with ``world`` ranks, rank ``rank``'s shard: the images
        ``[rank::world]``); the last batch wraps around to the first."""
        from .batching import make_sgg_batch

        idx = list(range(len(self)))[rank::world]
        for start in range(0, len(idx), batch_size):
            recs = [self[idx[i % len(idx)]] for i in range(start, start + batch_size)]
            yield make_sgg_batch(recs, self.image_size, max_boxes,
                                 self.num_obj_classes), recs
