"""GQA-200 dataset reader, the port's copy of ``veto_tpu/data/gqa.py``
(reference GQADataset, pysgg/data/datasets/gqa.py:21-357):
annotations live in two preprocessed JSON files (train / test), each a dict
of parallel lists — filenames, img_info, gt_boxes (already in image coords,
unlike VG's BOX_SCALE), gt_classes, relationships (triplet lists).  201
object classes / 101 predicate classes including __background__.

Split semantics preserved from load_graphs (:305-357): keep images with at
least one box and relation; item 5580 of the eval file is skipped (:327-329,
a corrupted record); 'val' is the first 5000 eval records, 'test' the rest.
Exposes the same record protocol as VGDataset so the bucketed loader and
the evaluation stack work unchanged.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np


def load_gqa_info(dict_file: str):
    """GQA-200 class dictionaries → (obj names, predicate names), bg first."""
    with open(dict_file) as f:
        info = json.load(f)
    if "label_to_idx" in info:
        obj = ["__background__"] + sorted(
            info["label_to_idx"], key=lambda k: info["label_to_idx"][k]
        )
        rel = ["__background__"] + sorted(
            info["predicate_to_idx"], key=lambda k: info["predicate_to_idx"][k]
        )
    else:  # idx→name maps
        obj = [info["idx_to_label"][str(i)] for i in sorted(map(int, info["idx_to_label"]))]
        rel = [info["idx_to_predicate"][str(i)] for i in sorted(map(int, info["idx_to_predicate"]))]
        if obj[0] != "__background__":
            obj = ["__background__"] + obj
        if rel[0] != "__background__":
            rel = ["__background__"] + rel
    return obj, rel


def load_gqa_graphs(data_json_file: str, split: str, num_val_im: int = 5000):
    """gqa.py load_graphs (:305-357) on NumPy records."""
    with open(data_json_file) as f:
        data = json.load(f)
    filenames, img_info = data["filenames_all"], data["img_info_all"]
    boxes, classes, rels = (
        data["gt_boxes_all"], data["gt_classes_all"], data["relationships_all"]
    )

    out = []
    for items, rec in enumerate(zip(filenames, img_info, boxes, classes, rels), 1):
        if split in ("val", "test") and items == 5580:  # corrupted record
            continue
        fn, info, b, c, r = rec
        if len(r) > 0 and len(b) > 0:
            out.append(
                (
                    fn,
                    info,
                    np.asarray(b, np.float32).reshape(-1, 4),
                    np.asarray(c, np.int64),
                    np.asarray(r, np.int64).reshape(-1, 3),
                )
            )
    if split == "val":
        out = out[:num_val_im]
    elif split == "test":
        out = out[num_val_im:]
    return out


class GQADataset:
    """Split view over the GQA-200 scene-graph annotations."""

    def __init__(
        self,
        split: str,
        dict_file: str,
        train_file: str,
        test_file: str,
        img_dir: str = "",
        depth_img_dir: Optional[str] = None,
        num_val_im: int = 5000,
        filter_duplicate_rels: bool = True,
        resampling: Optional[Dict] = None,
        seed: int = 1,
    ):
        assert split in ("train", "val", "test")
        self.split = split
        self.img_dir = img_dir
        self.depth_img_dir = depth_img_dir
        self.filter_duplicate_rels = filter_duplicate_rels and split == "train"
        self.rng = np.random.RandomState(seed)

        self.ind_to_classes, self.ind_to_predicates = load_gqa_info(dict_file)
        src = train_file if split == "train" else test_file
        records = load_gqa_graphs(src, split, num_val_im)
        self.filenames = [r[0] for r in records]
        self.img_info = [r[1] for r in records]
        self.gt_boxes = [r[2] for r in records]
        self.gt_classes = [r[3] for r in records]
        self.relationships = [r[4] for r in records]
        self.idx_list = list(range(len(self.img_info)))

        self.repeat_dict = None
        self.drop_rate = 0.0
        if resampling and split == "train":
            from .resampling import resampling_dict_generation

            self.drop_rate = resampling.get("instance_drop_rate", 1.6)
            self.repeat_dict = resampling_dict_generation(
                self, resampling.get("repeat_factor", 0.13), self.rng
            )
            self.idx_list = [
                i for i in range(len(self.img_info)) for _ in range(self.repeat_dict[i])
            ]

    def __len__(self) -> int:
        return len(self.idx_list)

    # same record protocol as VGDataset.get_groundtruth
    def get_groundtruth(self, index: int, inner_idx: bool = True) -> Dict:
        if not inner_idx:
            index = self.idx_list[index]
        info = self.img_info[index]
        w, h = info["width"], info["height"]
        boxes = self.gt_boxes[index].copy()

        relation = self.relationships[index].copy()
        if self.filter_duplicate_rels:
            seen = {}
            for s, o, p in relation:
                seen.setdefault((int(s), int(o)), []).append(int(p))
            relation = np.array(
                [(s, o, self.rng.choice(ps)) for (s, o), ps in seen.items()],
                dtype=np.int64,
            )

        relation_non_masked = None
        if self.repeat_dict is not None:
            from .resampling import apply_resampling

            relation, relation_non_masked = apply_resampling(
                index, relation, self.repeat_dict, self.drop_rate, self.rng
            )

        n = len(boxes)
        rel_matrix = np.zeros((n, n), np.int64)
        rel_matrix_nm = (
            np.zeros((n, n), np.int64) if relation_non_masked is not None else None
        )
        for i in range(relation.shape[0]):
            s, o, p = (int(v) for v in relation[i])
            if rel_matrix[s, o] == 0 or self.rng.rand() > 0.5:
                rel_matrix[s, o] = p
                if rel_matrix_nm is not None:
                    s2, o2, p2 = (int(v) for v in relation_non_masked[i])
                    rel_matrix_nm[s2, o2] = p2

        rec = {
            "boxes": boxes.astype(np.float32),
            "labels": self.gt_classes[index].astype(np.int32),
            "attributes": np.zeros((n, 10), np.int64),
            "rel_matrix": rel_matrix,
            "rel_tuples": relation,
            "size": np.array([w, h], np.int32),
            "image_id": info.get("image_id", index),
        }
        if rel_matrix_nm is not None:
            rec["rel_matrix_non_masked"] = rel_matrix_nm
        return rec

    def load_image(self, index: int) -> np.ndarray:
        from PIL import Image

        path = os.path.join(self.img_dir, os.path.basename(self.filenames[index]))
        img = Image.open(path).convert("RGB")
        return np.asarray(img, np.float32) / 255.0

    def load_depth(self, index: int) -> Optional[np.ndarray]:
        if not self.depth_img_dir:
            return None
        from PIL import Image

        base = os.path.basename(self.filenames[index]).split(".")[0]
        path = os.path.join(self.depth_img_dir, f"{base}-depth_raw.png")
        img = Image.open(path)
        return np.asarray(img, np.float32)[..., None]
