"""Relation pairs (``veto_tpu/models/relation/sampling.py``): all candidate
pairs at test time (``prepare_test_pairs``), and the training sample of
ground-truth pairs (``gtbox_relsample``)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class RelSample(NamedTuple):
    pair_idx: torch.Tensor  # (B, P, 2) int32 subject/object box indices
    labels: torch.Tensor    # (B, P) int32 predicate labels; 0 = bg, -1 = pad
    mask: torch.Tensor      # (B, P) bool


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


def _rank(x: torch.Tensor) -> torch.Tensor:
    """Rank of each entry along dim 1 (ties by position)."""
    return torch.argsort(torch.argsort(x, dim=1, stable=True), dim=1, stable=True)


def gtbox_relsample(rel_matrix: torch.Tensor, box_mask: torch.Tensor,
                    generator: torch.Generator, batch_size: int = 1024,
                    positive_fraction: float = 0.25) -> RelSample:
    """Training pairs over GT boxes, batched (JAX ``gtbox_relsample``).

    rel_matrix (B, N, N) predicate per GT pair (0 none, -1 a dropped
    relation, which counts as background); box_mask (B, N).  Per image:
    at most ``int(batch_size * positive_fraction)`` foreground pairs drawn
    uniformly from the GT relations, then uniformly drawn background pairs
    (valid i != j pairs with no GT relation) up to ``batch_size``; output
    order is the chosen foreground, the chosen background, then padding
    (label -1, mask False, pair (0, 0)).  ``min(batch_size, N * N)`` pairs.

    The draws come from ``generator`` (on the tensors' device); they cannot
    repeat ``jax.random``'s, so the sampler is held to the rules above.
    """
    b, n = box_mask.shape
    dev = box_mask.device
    num_pos = int(batch_size * positive_fraction)
    big = n * n
    ii = torch.arange(n, device=dev).repeat_interleave(n)
    jj = torch.arange(n, device=dev).repeat(n)
    flat_rel = rel_matrix.reshape(b, big).long()
    valid = box_mask[:, ii] & box_mask[:, jj] & (ii != jj)
    fg = valid & (flat_rel > 0)
    bg = valid & (flat_rel <= 0)
    r = torch.rand((2, b, big), generator=generator, device=dev)
    inf = torch.full((), float("inf"), device=dev)
    fg_rank = _rank(torch.where(fg, r[0], inf))
    bg_rank = _rank(torch.where(bg, r[1], inf))
    chosen_fg = fg & (fg_rank < num_pos)
    num_fg = chosen_fg.sum(1, keepdim=True)
    chosen_bg = bg & (bg_rank < batch_size - num_fg)
    sel_key = torch.where(chosen_fg, fg_rank, torch.where(
        chosen_bg, big + bg_rank, 2 * big + torch.arange(big, device=dev)))
    order = torch.argsort(sel_key, dim=1)[:, :batch_size]  # keys are distinct
    mask = torch.gather(chosen_fg | chosen_bg, 1, order)
    labels = torch.where(mask, torch.gather(flat_rel, 1, order).clamp(min=0), -1)
    pair_idx = torch.stack([ii[order], jj[order]], dim=-1)
    pair_idx = torch.where(mask[..., None], pair_idx, 0)
    return RelSample(pair_idx.to(torch.int32), labels.to(torch.int32), mask)
