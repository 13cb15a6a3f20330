"""Predicate statistics of Visual Genome and GQA-200
(``veto_tpu/data/predicate_stats.py``), as far as the evaluator, the Rwt
loss and the VG reader need them: the frequency-rank reordering, the
predicate names in that order, and the training counts per
frequency-ranked predicate (index 0 = background)."""

import numpy as np

# old predicate id → frequency-rank id (descending train count), VG 51 classes
VG_PREDICATE_NEW_ORDER = [
    0, 10, 42, 43, 34, 28, 17, 19, 7, 29, 33, 18, 35, 32, 27, 50, 22, 44, 45,
    25, 2, 9, 5, 15, 26, 23, 37, 48, 41, 6, 4, 1, 38, 21, 46, 30, 36, 47, 14,
    49, 11, 16, 39, 13, 31, 40, 20, 24, 3, 12, 8,
]

# training-sample count per frequency-ranked predicate (index 0 = background)
VG_PREDICATE_COUNTS = [
    3024465, 109355, 67144, 47326, 31347, 21748, 15300, 10011, 11059, 10764,
    6712, 5086, 4810, 3757, 4260, 3167, 2273, 1829, 1603, 1413, 1225, 793,
    809, 676, 352, 663, 752, 565, 504, 644, 601, 551, 460, 394, 379, 397,
    429, 364, 333, 299, 270, 234, 171, 208, 163, 157, 151, 71, 114, 44, 4,
]

# frequency-ranked predicate names
VG_PREDICATE_NAMES = [
    "__background__", "on", "has", "wearing", "of", "in", "near", "behind",
    "with", "holding", "above", "sitting on", "wears", "under", "riding",
    "in front of", "standing on", "at", "carrying", "attached to",
    "walking on", "over", "for", "looking at", "watching", "hanging from",
    "laying on", "eating", "and", "belonging to", "parked on", "using",
    "covering", "between", "along", "covered in", "part of", "lying on",
    "on back of", "to", "walking in", "mounted on", "across", "against",
    "from", "growing on", "painted on", "playing", "made of", "says",
    "flying in",
]

GQA_PREDICATE_COUNTS = [
    200000, 64218, 47205, 32126, 25203, 21104, 15890, 15676, 7688, 6966,
    6596, 6044, 5250, 4260, 4180, 4131, 2859, 2559, 2368, 2351, 2134, 1673,
    1532, 1373, 1273, 1175, 1139, 1123, 1077, 941, 916, 849, 835, 808, 782,
    767, 628, 603, 569, 540, 494, 416, 412, 412, 398, 395, 394, 390, 345,
    327, 302, 301, 292, 275, 270, 267, 267, 264, 258, 251, 233, 233, 229,
    224, 215, 214, 209, 204, 198, 195, 192, 191, 185, 181, 176, 158, 158,
    154, 151, 148, 143, 136, 131, 130, 130, 128, 127, 125, 124, 124, 121,
    118, 112, 112, 106, 105, 104, 103, 102, 52, 52,
]


def predicate_counts(dataset: str) -> np.ndarray:
    """Training counts per predicate of ``"VG"`` or ``"GQA"``, int64."""
    return np.asarray(
        {"VG": VG_PREDICATE_COUNTS, "GQA": GQA_PREDICATE_COUNTS}[dataset],
        dtype=np.int64,
    )


def reorder_predicates(predicates: np.ndarray) -> np.ndarray:
    """Map VG predicate ids to frequency-rank ids (the reader's
    ``data.reorder_freq_based`` path)."""
    return np.asarray(VG_PREDICATE_NEW_ORDER, dtype=np.int64)[predicates]
