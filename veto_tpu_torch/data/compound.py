"""Compound datasets (``veto_tpu/data/compound.py``): concatenation and raw
image lists, over the readers' protocol (``__len__``,
``get_groundtruth(index, inner_idx=False)``, ``load_image(inner)``,
``load_depth(inner)``, an optional ``idx_list``).

  * :class:`ConcatDataset` chains datasets of one class vocabulary, for
    detector pretraining on several sets (``data.dataset=VOC2007+VOC2012``).
    A global index goes to its part by the bisect rule of torch's
    ``ConcatDataset``.
  * :class:`ListDataset` is a bare list of image paths, each with one
    whole-image dummy box, for detector inference over unannotated folders.

Neither defines ``idx_list``: each part's resampling map is applied inside
the routed calls, so a loader addresses them with plain global indices.
PIL is imported only where an image file is read.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence

import numpy as np


class ConcatDataset:
    """Concatenation of datasets sharing one class vocabulary (the first
    part's ``ind_to_classes`` / ``ind_to_predicates`` / ``classes``)."""

    def __init__(self, datasets: Sequence):
        assert len(datasets) > 0
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()
        for attr in ("ind_to_classes", "ind_to_predicates", "classes"):
            if hasattr(self.datasets[0], attr):
                setattr(self, attr, getattr(self.datasets[0], attr))

    def __len__(self) -> int:
        return self.cumulative_sizes[-1]

    def get_idxs(self, idx: int):
        """Global index → (part, index within the part)."""
        dataset_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        if dataset_idx == 0:
            return 0, idx
        return dataset_idx, idx - self.cumulative_sizes[dataset_idx - 1]

    def _route(self, idx: int):
        d_idx, s_idx = self.get_idxs(idx)
        ds = self.datasets[d_idx]
        inner = ds.idx_list[s_idx] if hasattr(ds, "idx_list") else s_idx
        return ds, s_idx, inner

    def get_groundtruth(self, index: int, inner_idx: bool = False) -> Dict:
        ds, s_idx, _ = self._route(index)
        return ds.get_groundtruth(s_idx, inner_idx=False)

    def load_image(self, index: int) -> np.ndarray:
        ds, _, inner = self._route(index)
        return ds.load_image(inner)

    def load_depth(self, index: int) -> Optional[np.ndarray]:
        ds, _, inner = self._route(index)
        return ds.load_depth(inner)

    def get_img_info(self, index: int):
        ds, s_idx, inner = self._route(index)
        if hasattr(ds, "get_img_info"):
            return ds.get_img_info(s_idx)
        return ds.img_info[inner]


class ListDataset:
    """A plain list of image paths; each item carries a whole-image dummy
    box, so detector inference runs over an unannotated folder."""

    def __init__(self, image_paths: List[str]):
        self.image_paths = list(image_paths)
        self._sizes: Dict[int, tuple] = {}

    def __len__(self) -> int:
        return len(self.image_paths)

    def _size(self, index: int):
        if index not in self._sizes:
            from PIL import Image

            with Image.open(self.image_paths[index]) as im:
                self._sizes[index] = im.size  # (w, h)
        return self._sizes[index]

    def get_groundtruth(self, index: int, inner_idx: bool = False) -> Dict:
        w, h = self._size(index)
        return {
            "boxes": np.array([[0, 0, w, h]], np.float32),
            "labels": np.zeros(1, np.int32),
            "attributes": np.zeros((1, 10), np.int64),
            "rel_matrix": np.zeros((1, 1), np.int64),
            "rel_tuples": np.zeros((0, 3), np.int64),
            "size": np.array([w, h], np.int32),
            "image_id": index,
        }

    def load_image(self, index: int) -> np.ndarray:
        from PIL import Image

        img = Image.open(self.image_paths[index]).convert("RGB")
        self._sizes[index] = img.size
        return np.asarray(img, np.float32) / 255.0

    def load_depth(self, index: int) -> Optional[np.ndarray]:
        return None
