"""Deterministic synthetic SGG corpus (``veto_tpu/data/synthetic.py``).

Seeded numpy records with the Visual Genome schema (boxes, labels, dense
relation matrix, relation tuples, depth channel), so the evaluation path
runs without the VG files.  The same seed gives the same records as the
JAX package's dataset, draw for draw, so one batch feeds both packages.
Every record carries depth.  The JAX dataset's depth-less, rendered-box,
deterministic-relation, mask and keypoint options serve other tasks and
are not ported in this slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticSGGDataset:
    def __init__(self, num_images: int = 16, image_size: tuple = (256, 256),
                 num_obj_classes: int = 151, num_rel_classes: int = 51,
                 max_objects: int = 20, min_objects: int = 4,
                 max_relations: int = 12, seed: int = 0):
        self.num_images = num_images
        self.image_size = image_size
        self.num_obj_classes = num_obj_classes
        self.num_rel_classes = num_rel_classes
        self.max_objects = max_objects
        self.min_objects = min_objects
        self.max_relations = max_relations
        self.seed = seed

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
        return {"image": image, "depth": depth, "boxes": boxes,
                "labels": labels, "rel_matrix": rel_matrix,
                "rel_tuples": rel_tuples,
                "size": np.array([w, h], np.int32)}

    def batches(self, batch_size: int, max_boxes: int):
        """Yield (numpy SGGBatch, list[record]) batches covering the dataset."""
        from .batching import make_sgg_batch

        for start in range(0, len(self), batch_size):
            recs = [self[i % len(self)] for i in range(start, start + batch_size)]
            yield make_sgg_batch(recs, self.image_size, max_boxes,
                                 self.num_obj_classes), recs
