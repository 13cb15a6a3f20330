"""COCO instances dataset for detector pretraining
(``veto_tpu/data/coco.py``).

Reads the instances JSON with the standard library (no pycocotools) into
the readers' record protocol (``get_groundtruth`` / ``load_image`` /
``idx_list`` / ``img_info``), so :class:`~.loader.SGGLoader` and the
detector tools take it as they take Visual Genome; the relation fields are
empty.  The JAX package's semantics:

  * image ids sorted;
  * images without a valid annotation dropped (none, or every box with a
    side of at most 1 pixel: ``_valid_anno``);
  * crowd annotations dropped;
  * the JSON category ids mapped to contiguous labels from 1, in id order;
  * xywh → xyxy with TO_REMOVE = 1 (``x2 = x + max(w - 1, 0)``), clipped to
    the image, boxes left empty by the clip removed (and an image left with
    none dropped).

PIL is imported only inside :meth:`COCODetDataset.load_image`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np


def _valid_anno(objs: List[dict]) -> bool:
    """At least one annotation, and not every box close to zero area."""
    if len(objs) == 0:
        return False
    return not all(any(o <= 1 for o in obj["bbox"][2:]) for obj in objs)


class COCODetDataset:
    """Detection-only dataset over a COCO instances JSON."""

    def __init__(self, ann_file: str, img_dir: str = "",
                 remove_images_without_annotations: bool = True,
                 num_im: int = -1):
        with open(ann_file) as f:
            coco = json.load(f)

        self.ann_file, self.img_dir = ann_file, img_dir
        self.depth_img_dir = None

        cat_ids = sorted(c["id"] for c in coco["categories"])
        self.json_to_contiguous = {c: i + 1 for i, c in enumerate(cat_ids)}
        self.contiguous_to_json = {v: k for k, v in self.json_to_contiguous.items()}
        self.ind_to_classes = ["__background__"] + [
            c["name"] for c in sorted(coco["categories"], key=lambda c: c["id"])]
        self.ind_to_predicates = ["__background__"]

        per_image: Dict[int, List[dict]] = {}
        for ann in coco["annotations"]:
            if ann.get("iscrowd", 0) == 0:
                per_image.setdefault(ann["image_id"], []).append(ann)

        images = {im["id"]: im for im in coco["images"]}
        ids = sorted(images)
        if remove_images_without_annotations:
            ids = [i for i in ids if _valid_anno(per_image.get(i, []))]
        if num_im != -1:
            ids = ids[:num_im]

        self.filenames: List[str] = []
        self.img_info: List[dict] = []
        self.gt_boxes: List[np.ndarray] = []
        self.gt_classes: List[np.ndarray] = []
        self.relationships: List[np.ndarray] = []
        for i in ids:
            im = images[i]
            w, h = float(im["width"]), float(im["height"])
            boxes, labels = [], []
            for obj in per_image.get(i, []):
                x, y, bw, bh = obj["bbox"]
                x2 = x + max(bw - 1.0, 0.0)
                y2 = y + max(bh - 1.0, 0.0)
                x1 = min(max(x, 0.0), w - 1.0)
                y1 = min(max(y, 0.0), h - 1.0)
                x2 = min(max(x2, 0.0), w - 1.0)
                y2 = min(max(y2, 0.0), h - 1.0)
                if x2 > x1 and y2 > y1:
                    boxes.append([x1, y1, x2, y2])
                    labels.append(self.json_to_contiguous[obj["category_id"]])
            if not boxes:
                continue
            self.filenames.append(im["file_name"])
            self.img_info.append({"width": int(w), "height": int(h),
                                  "image_id": len(self.filenames) - 1, "coco_id": i})
            self.gt_boxes.append(np.asarray(boxes, np.float32))
            self.gt_classes.append(np.asarray(labels, np.int64))
            self.relationships.append(np.zeros((0, 3), np.int64))

        self.idx_list = list(range(len(self.img_info)))
        self.repeat_dict = None

    def __len__(self) -> int:
        return len(self.idx_list)

    def get_groundtruth(self, index: int, inner_idx: bool = True) -> Dict:
        if not inner_idx:
            index = self.idx_list[index]
        info = self.img_info[index]
        n = len(self.gt_boxes[index])
        return {
            "boxes": self.gt_boxes[index].copy(),
            "labels": self.gt_classes[index].astype(np.int32),
            "attributes": np.zeros((n, 10), np.int64),
            "rel_matrix": np.zeros((n, n), np.int64),
            "rel_tuples": np.zeros((0, 3), np.int64),
            "size": np.array([info["width"], info["height"]], np.int32),
            "image_id": info["image_id"],
        }

    def load_image(self, index: int) -> np.ndarray:
        from PIL import Image

        path = os.path.join(self.img_dir, self.filenames[index])
        img = Image.open(path).convert("RGB")
        return np.asarray(img, np.float32) / 255.0

    def load_depth(self, index: int) -> Optional[np.ndarray]:
        return None
