"""Bi-level (image + instance) resampling for long-tail predicates
(``veto_tpu/data/resampling.py``, reference bi_lvl_rsmp.py:11-163):
  * image level — per-class repeat factor sqrt(global_rf / freq) clipped
    >= 1, randomly rounded; an image repeats max over its predicate classes.
  * instance level — on repeated images, head-class relation labels are
    dropped (set to -1) with probability
    (1 - class_repeat / image_repeat) * drop_rate; the untouched copy
    survives as ``relation_non_masked`` for rel-PN supervision
    (sampling.py:160-168 in the reference).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def resampling_dict_generation(dataset, global_rf: float, rng) -> Dict:
    """index → repeat count, plus 'cls_rf' class repeat factors."""
    num_rel = len(dataset.ind_to_predicates)
    freq = np.zeros(num_rel)
    per_image_labels: List[np.ndarray] = []
    for rels in dataset.relationships:
        labels = rels[:, 2] if len(rels) else np.zeros((0,), np.int64)
        per_image_labels.append(labels)
        np.add.at(freq, labels, 1)
    freq = freq / (freq.sum() + 1e-11)

    rf = np.sqrt(global_rf / (freq[1:] + 1e-11))
    rf = np.clip(rf, 1.0, rf.max() + 1)
    # random rounding (bi_lvl_rsmp.py:65-72)
    rand = rng.rand(*rf.shape)
    int_part = rf.astype(int)
    rep = int_part + (rand < (rf - int_part)).astype(int)

    cls_rf = {0: 1}
    for i, r in enumerate(rep.tolist()):
        cls_rf[i + 1] = int(r)

    repeat: Dict = {}
    for i, labels in enumerate(per_image_labels):
        uniq = np.unique(labels)
        repeat[i] = int(max((cls_rf[int(c)] for c in uniq), default=1))
    repeat["cls_rf"] = cls_rf
    return repeat


def apply_resampling(
    index: int,
    relation: np.ndarray,
    repeat_dict: Dict,
    drop_rate: float,
    rng,
):
    """Drop head-class relations on repeated images (labels → -1)."""
    relation_non_masked = relation.copy()
    r_c = repeat_dict[index]
    if r_c > 1 and len(relation) > 0:
        cls_rf = repeat_dict["cls_rf"]
        rel_repeat = np.array([cls_rf.get(int(p), 1) for p in relation[:, 2]])
        p_drop = np.clip((1 - rel_repeat / (r_c + 1e-11)) * drop_rate, 0.0, 1.0)
        dropped = rng.uniform(0, 1, len(relation)) < p_drop
        relation = relation.copy()
        relation[dropped, 2] = -1
    return relation, relation_non_masked
