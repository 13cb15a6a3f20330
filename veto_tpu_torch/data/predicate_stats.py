"""Visual Genome predicate statistics (``veto_tpu/data/predicate_stats.py``),
as far as the evaluator needs them."""

# old predicate id → frequency-rank id (descending train count), VG 51 classes
VG_PREDICATE_NEW_ORDER = [
    0, 10, 42, 43, 34, 28, 17, 19, 7, 29, 33, 18, 35, 32, 27, 50, 22, 44, 45,
    25, 2, 9, 5, 15, 26, 23, 37, 48, 41, 6, 4, 1, 38, 21, 46, 30, 36, 47, 14,
    49, 11, 16, 39, 13, 31, 40, 20, 24, 3, 12, 8,
]
