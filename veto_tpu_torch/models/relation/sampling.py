"""Test-time relation pairs (``veto_tpu/models/relation/sampling.py``
``prepare_test_pairs``)."""

from __future__ import annotations

from typing import Tuple

import torch


def prepare_test_pairs(box_mask: torch.Tensor, scores: torch.Tensor,
                       max_pairs: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """All candidate pairs of each image, batched.

    box_mask, scores: (B, N) → pair_idx (B, max_pairs, 2) int32 and mask
    (B, max_pairs), ordered by descending score product with row-major
    order among exact ties (an exact stable sort, as in the JAX package; in
    PredCls every valid pair ties, so the order is purely row-major).
    Requiring box overlap (``relation_require_overlap``) is not ported.
    """
    b, n = box_mask.shape
    dev = box_mask.device
    ii = torch.arange(n, device=dev).repeat_interleave(n)
    jj = torch.arange(n, device=dev).repeat(n)
    valid = box_mask[:, ii] & box_mask[:, jj] & (ii != jj)
    quality = torch.where(valid, scores[:, ii] * scores[:, jj],
                          torch.full((), -float("inf"), device=dev))
    k = min(max_pairs, n * n)
    sneg, order = torch.sort(-quality, dim=1, stable=True)
    mask = sneg[:, :k] < float("inf")
    pair_idx = torch.stack([ii[order[:, :k]], jj[order[:, :k]]], dim=-1)
    pair_idx = torch.where(mask[..., None], pair_idx, 0).to(torch.int32)
    if max_pairs > n * n:  # pad out to the static budget
        pad = max_pairs - n * n
        pair_idx = torch.cat([pair_idx, pair_idx.new_zeros((b, pad, 2))], dim=1)
        mask = torch.cat([mask, mask.new_zeros((b, pad))], dim=1)
    return pair_idx, mask
