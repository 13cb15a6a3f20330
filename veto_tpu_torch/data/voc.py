"""Pascal VOC detection dataset (``veto_tpu/data/voc.py``).

Reads ``ImageSets/Main/{split}.txt`` and the ``Annotations`` XML with the
standard library into the readers' record protocol (``get_groundtruth`` /
``load_image`` / ``idx_list`` / ``img_info``); the relation fields are
empty, and each record also carries ``difficult`` for
:class:`~..evaluation.voc_eval.VOCEvaluator`.  The JAX package's
semantics: pixel indexes made 0-based (1 off all four coordinates),
difficult objects dropped unless ``use_difficult``, the fixed 20-class
vocabulary.  PIL is imported only inside :meth:`VOCDataset.load_image`.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

VOC_CLASSES = (
    "__background__", "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
    "tvmonitor",
)


class VOCDataset:
    def __init__(self, data_dir: str, split: str, use_difficult: bool = False,
                 num_im: int = -1):
        self.root, self.split = data_dir, split
        self.keep_difficult = use_difficult
        self.ind_to_classes = list(VOC_CLASSES)
        self.ind_to_predicates = ["__background__"]
        self._class_to_ind = {c.strip(): i for i, c in enumerate(VOC_CLASSES)}

        with open(os.path.join(data_dir, "ImageSets", "Main", f"{split}.txt")) as f:
            ids = [line.strip() for line in f if line.strip()]
        if num_im != -1:
            ids = ids[:num_im]
        self.ids = ids

        self.img_info: List[dict] = []
        self.gt_boxes: List[np.ndarray] = []
        self.gt_classes: List[np.ndarray] = []
        self.gt_difficult: List[np.ndarray] = []
        self.relationships: List[np.ndarray] = []
        for i, img_id in enumerate(ids):
            anno = ET.parse(os.path.join(data_dir, "Annotations",
                                         f"{img_id}.xml")).getroot()
            boxes, labels, difficult = [], [], []
            for obj in anno.iter("object"):
                diff = int(obj.find("difficult").text) == 1
                if not self.keep_difficult and diff:
                    continue
                bb = obj.find("bndbox")
                boxes.append([int(bb.find(k).text) - 1
                              for k in ("xmin", "ymin", "xmax", "ymax")])
                labels.append(self._class_to_ind[obj.find("name").text.lower().strip()])
                difficult.append(diff)
            size = anno.find("size")
            self.img_info.append({"width": int(size.find("width").text),
                                  "height": int(size.find("height").text),
                                  "image_id": i})
            self.gt_boxes.append(np.asarray(boxes, np.float32).reshape(-1, 4))
            self.gt_classes.append(np.asarray(labels, np.int64))
            self.gt_difficult.append(np.asarray(difficult, bool))
            self.relationships.append(np.zeros((0, 3), np.int64))

        self.idx_list = list(range(len(self.ids)))
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
            "difficult": self.gt_difficult[index].copy(),
            "attributes": np.zeros((n, 10), np.int64),
            "rel_matrix": np.zeros((n, n), np.int64),
            "rel_tuples": np.zeros((0, 3), np.int64),
            "size": np.array([info["width"], info["height"]], np.int32),
            "image_id": info["image_id"],
        }

    def load_image(self, index: int) -> np.ndarray:
        from PIL import Image

        path = os.path.join(self.root, "JPEGImages", f"{self.ids[index]}.jpg")
        img = Image.open(path).convert("RGB")
        return np.asarray(img, np.float32) / 255.0

    def load_depth(self, index: int) -> Optional[np.ndarray]:
        return None
