"""Visual Genome dataset reader (VG-SGG-with-attri.h5 lineage), the port's
copy of ``veto_tpu/data/visual_genome.py`` (reference VGDataset,
pysgg/data/datasets/visual_genome.py:44-666):

  * `load_graphs` — h5 split masks (train=0/test=2), 5000-image val
    carve-out from the train split, empty-box/empty-rel filtering,
    BOX_SCALE=1024 cx/cy/w/h → xyxy conversion, optional non-overlap
    filtering, optional frequency-based predicate reorder (:616-629).
  * per-image records — boxes recovered to original image scale
    (`gt_boxes / BOX_SCALE * max(w, h)`, :317), duplicate-relation random
    choice (:325-334), dense (N, N) relation matrix with coin-flip overwrite
    for colliding predicates (:349-367), `relation_tuple` kept for eval.
  * bi-level resampling hooks (repeat list + instance drop, bi_lvl_rsmp.py)
    via :mod:`veto_tpu_torch.data.resampling`.

Images/depth load lazily from disk; records are NumPy, feeding the bucketed
loader (:mod:`veto_tpu_torch.data.loader`).  ``self.rng`` is drawn in index
order, on the loader's main thread, so records do not depend on the
loader's worker count.  h5py and PIL are imported where they are used; a
missing one raises an ``ImportError`` that names it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from .predicate_stats import VG_PREDICATE_NAMES, reorder_predicates

BOX_SCALE = 1024


def load_info(dict_file: str):
    """Class/predicate/attribute name lists from VG-SGG-dicts json
    (reference load_info, visual_genome.py:668-690)."""
    with open(dict_file) as f:
        info = json.load(f)
    info["label_to_idx"]["__background__"] = 0
    info["predicate_to_idx"]["__background__"] = 0
    ind_to_classes = sorted(info["label_to_idx"], key=lambda k: info["label_to_idx"][k])
    ind_to_predicates = sorted(
        info["predicate_to_idx"], key=lambda k: info["predicate_to_idx"][k]
    )
    ind_to_attributes = sorted(
        info.get("attribute_to_idx", {"__background__": 0}),
        key=lambda k: info.get("attribute_to_idx", {"__background__": 0})[k],
    )
    return ind_to_classes, ind_to_predicates, ind_to_attributes


def load_graphs(
    roidb_file: str,
    split: str,
    num_im: int = -1,
    num_val_im: int = 5000,
    filter_empty_rels: bool = True,
    filter_non_overlap: bool = False,
    reorder_freq_based: bool = True,
):
    """Parse the VG-SGG h5 into per-image numpy graphs.

    Returns (image_index, boxes, classes, attributes, relationships) where
    image_index indexes the h5's global image list.  Boxes stay at
    BOX_SCALE; callers rescale per image (reference get_groundtruth :317).
    """
    import h5py

    with h5py.File(roidb_file, "r") as h5:
        data_split = h5["split"][:]
        split_flag = 2 if split == "test" else 0
        split_mask = data_split == split_flag
        split_mask &= h5["img_to_first_box"][:] >= 0
        if filter_empty_rels:
            split_mask &= h5["img_to_first_rel"][:] >= 0

        image_index = np.where(split_mask)[0]
        if num_im > -1:
            image_index = image_index[:num_im]
        if num_val_im > 0:
            if split == "val":
                image_index = image_index[:num_val_im]
            elif split == "train":
                image_index = image_index[num_val_im:]

        keep = np.zeros_like(split_mask)
        keep[image_index] = True

        all_labels = h5["labels"][:, 0]
        all_attributes = h5["attributes"][:, :] if "attributes" in h5 else None
        all_boxes = h5[f"boxes_{BOX_SCALE}"][:].astype(np.float32)  # cx cy w h
        # cx/cy/w/h → x1 y1 x2 y2
        all_boxes[:, :2] = all_boxes[:, :2] - all_boxes[:, 2:] / 2
        all_boxes[:, 2:] = all_boxes[:, :2] + all_boxes[:, 2:]

        first_box = h5["img_to_first_box"][keep]
        last_box = h5["img_to_last_box"][keep]
        first_rel = h5["img_to_first_rel"][keep]
        last_rel = h5["img_to_last_rel"][keep]
        rel_pairs = h5["relationships"][:]
        rel_preds = h5["predicates"][:, 0]

    boxes, classes, attributes, relationships, kept_index = [], [], [], [], []
    for i, gidx in enumerate(image_index):
        b0, b1 = first_box[i], last_box[i]
        boxes_i = all_boxes[b0 : b1 + 1]
        classes_i = all_labels[b0 : b1 + 1]
        attrs_i = (
            all_attributes[b0 : b1 + 1]
            if all_attributes is not None
            else np.zeros((b1 + 1 - b0, 10), np.int64)
        )
        r0, r1 = first_rel[i], last_rel[i]
        if r0 >= 0:
            preds = rel_preds[r0 : r1 + 1]
            if reorder_freq_based:
                preds = reorder_predicates(preds)
            pair_idx = rel_pairs[r0 : r1 + 1] - b0
            rels = np.column_stack([pair_idx, preds]).astype(np.int64)
        else:
            rels = np.zeros((0, 3), np.int64)

        if filter_non_overlap:
            from ..evaluation.sgg_eval import np_iou

            iou = np_iou(boxes_i, boxes_i)
            inc = np.where(iou[rels[:, 0], rels[:, 1]] > 0.0)[0]
            if inc.size == 0:
                continue
            rels = rels[inc]

        boxes.append(boxes_i)
        classes.append(classes_i.astype(np.int64))
        attributes.append(attrs_i)
        relationships.append(rels)
        kept_index.append(gidx)

    return np.asarray(kept_index), boxes, classes, attributes, relationships


def load_image_metadata(image_file: str) -> List[Dict]:
    """image_data.json → per-image {image_id, width, height}
    (reference load_image_filenames, visual_genome.py:497-536)."""
    with open(image_file) as f:
        img_info = json.load(f)
    # the reference drops 2 known-corrupt images by filename
    corrupt = {"1592.jpg", "1722.jpg", "4616.jpg", "4617.jpg"}
    return [
        info
        for info in img_info
        if f"{info['image_id']}.jpg" not in corrupt
    ]


class VGDataset:
    """Split view over the VG scene-graph annotations."""

    def __init__(
        self,
        split: str,
        roidb_file: str,
        dict_file: str,
        image_file: str,
        img_dir: str = "",
        depth_img_dir: Optional[str] = None,
        num_im: int = -1,
        num_val_im: int = 5000,
        filter_empty_rels: bool = True,
        filter_duplicate_rels: bool = True,
        filter_non_overlap: bool = True,
        reorder_freq_based: bool = True,
        resampling: Optional[Dict] = None,
        seed: int = 1,
    ):
        assert split in ("train", "val", "test")
        self.split = split
        self.img_dir = img_dir
        self.depth_img_dir = depth_img_dir
        self.filter_duplicate_rels = filter_duplicate_rels and split == "train"
        self.rng = np.random.RandomState(seed)

        self.ind_to_classes, self.ind_to_predicates, self.ind_to_attributes = load_info(
            dict_file
        )
        if reorder_freq_based:
            self.ind_to_predicates = list(VG_PREDICATE_NAMES)

        (
            self.image_index,
            self.gt_boxes,
            self.gt_classes,
            self.gt_attributes,
            self.relationships,
        ) = load_graphs(
            roidb_file,
            split,
            num_im=num_im,
            num_val_im=num_val_im,
            filter_empty_rels=filter_empty_rels,
            filter_non_overlap=filter_non_overlap and split == "train",
            reorder_freq_based=reorder_freq_based,
        )

        meta = load_image_metadata(image_file)
        self.img_info = [meta[i] for i in self.image_index]
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

    # ------------------------------------------------------------------
    def get_groundtruth(self, index: int, inner_idx: bool = True) -> Dict:
        """Per-image record at original image scale (get_groundtruth :308-376)."""
        if not inner_idx:
            index = self.idx_list[index]
        info = self.img_info[index]
        w, h = info["width"], info["height"]
        boxes = self.gt_boxes[index] / BOX_SCALE * max(w, h)

        relation = self.relationships[index].copy()
        if self.filter_duplicate_rels:
            seen = {}
            for s, o, p in relation:
                seen.setdefault((s, o), []).append(p)
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
        rel_matrix_nm = np.zeros((n, n), np.int64) if relation_non_masked is not None else None
        for i in range(relation.shape[0]):
            s, o, p = (int(v) for v in relation[i])
            # colliding predicates: later one wins a coin flip (:349-361)
            if rel_matrix[s, o] == 0 or self.rng.rand() > 0.5:
                rel_matrix[s, o] = p
                if rel_matrix_nm is not None:
                    s2, o2, p2 = (int(v) for v in relation_non_masked[i])
                    rel_matrix_nm[s2, o2] = p2

        rec = {
            "boxes": boxes.astype(np.float32),
            "labels": self.gt_classes[index].astype(np.int32),
            "attributes": self.gt_attributes[index],
            "rel_matrix": rel_matrix,
            "rel_tuples": relation,
            "size": np.array([w, h], np.int32),
            "image_id": info["image_id"],
        }
        if rel_matrix_nm is not None:
            rec["rel_matrix_non_masked"] = rel_matrix_nm
        return rec

    def load_image(self, index: int) -> np.ndarray:
        """RGB float32 [0,1] (H, W, 3)."""
        from PIL import Image

        path = os.path.join(self.img_dir, f"{self.img_info[index]['image_id']}.jpg")
        img = Image.open(path).convert("RGB")
        return np.asarray(img, np.float32) / 255.0

    def load_image_raw(self, index: int) -> np.ndarray:
        """RGB uint8 (H, W, 3) — the fused native loader path consumes raw
        bytes (resize is linear, so /255·x255 cancels; data/loader.py)."""
        from PIL import Image

        path = os.path.join(self.img_dir, f"{self.img_info[index]['image_id']}.jpg")
        return np.asarray(Image.open(path).convert("RGB"))

    def image_size(self, index: int):
        """(width, height) from img_info metadata — aspect routing without
        a decode (reference GroupedBatchSampler reads the same metadata)."""
        info = self.img_info[index]
        return info["width"], info["height"]

    def load_depth(self, index: int) -> Optional[np.ndarray]:
        """Raw depth PNG `{id}-depth_raw.png` → (H, W, 1) float32
        (reference :122,518)."""
        if not self.depth_img_dir:
            return None
        from PIL import Image

        path = os.path.join(
            self.depth_img_dir, f"{self.img_info[index]['image_id']}-depth_raw.png"
        )
        img = Image.open(path)
        return np.asarray(img, np.float32)[..., None]
