"""Relation pairs (``veto_tpu/models/relation/sampling.py``): all candidate
pairs at test time (``prepare_test_pairs``), the training sample of
ground-truth pairs (``gtbox_relsample``), and SGDet's training sample over
detections (``detect_relsample``), batched over images."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ...engine import distributed
from ...ops.box_ops import box_iou


class RelSample(NamedTuple):
    pair_idx: torch.Tensor  # (B, P, 2) int32 subject/object box indices
    labels: torch.Tensor    # (B, P) int32 predicate labels; 0 = bg, -1 = pad
    mask: torch.Tensor      # (B, P) bool


def binary_relatedness(rel_matrix: torch.Tensor, box_mask: torch.Tensor) -> torch.Tensor:
    """(B, N, N) int32: 1 where boxes i and j, both valid, have a GT
    relation either way (the JAX ``RelSample.binary_rel``, VCTree's binary
    loss target)."""
    rel = rel_matrix > 0
    valid = box_mask[:, :, None] & box_mask[:, None, :]
    return ((rel | rel.transpose(1, 2)) & valid).to(torch.int32)


def prepare_test_pairs(box_mask: torch.Tensor, scores: torch.Tensor,
                       max_pairs: int = 2048, boxes: Optional[torch.Tensor] = None,
                       require_overlap: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All candidate pairs of each image, batched.

    box_mask, scores: (B, N) → pair_idx (B, max_pairs, 2) int32 and mask
    (B, max_pairs), ordered by descending score product with row-major
    order among exact ties (an exact stable sort, as in the JAX package; in
    PredCls every valid pair ties, so the order is purely row-major).
    ``require_overlap`` (``test.relation_require_overlap``) keeps only the
    pairs whose ``boxes`` (B, N, 4) overlap (IoU > 0).
    """
    b, n = box_mask.shape
    dev = box_mask.device
    ii = torch.arange(n, device=dev).repeat_interleave(n)
    jj = torch.arange(n, device=dev).repeat(n)
    valid = box_mask[:, ii] & box_mask[:, jj] & (ii != jj)
    if require_overlap:
        valid = valid & (box_iou(boxes.float(), boxes.float()).reshape(b, -1) > 0)
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
                    positive_fraction: float = 0.25, dp=None) -> RelSample:
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
    Under data parallelism (``dp``) each draw is made at the global batch's
    size and this rank keeps its own images' rows.
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
    r = distributed.rand(dp, (2, b, big), generator, dev, batch_dim=1)
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


class DetRelSample(NamedTuple):
    pair_idx: torch.Tensor    # (B, P, 2) int32 indices into the detections
    labels: torch.Tensor      # (B, P) int32 labels of the (resampled) matrix
    labels_all: torch.Tensor  # (B, P) int32 labels of the full matrix
    mask: torch.Tensor        # (B, P) bool
    binary_rel: torch.Tensor  # (B, D, D) int32 GT relatedness, symmetric


def detect_relsample(rel_matrix: torch.Tensor, rel_matrix_all: torch.Tensor,
                     tgt_boxes: torch.Tensor, tgt_labels: torch.Tensor,
                     tgt_mask: torch.Tensor, prp_boxes: torch.Tensor,
                     prp_labels: torch.Tensor, prp_scores: torch.Tensor,
                     prp_mask: torch.Tensor, generator: torch.Generator,
                     batch_size: int = 1024, positive_fraction: float = 0.25,
                     num_sample_per_gt_rel: int = 4, fg_thres: float = 0.5,
                     require_overlap: bool = False,
                     max_gt_rels: int = 160, dp=None) -> DetRelSample:
    """SGDet training pairs over the detections, batched (JAX
    ``detect_relsample``; the reference's ``detect_relsample`` with
    ``motif_rel_fg_bg_sampling``).

    rel_matrix, rel_matrix_all (B, T, T) GT predicates (the second not
    resampled); tgt_* the T GT boxes, labels and mask; prp_* the D
    detections, their GT-assigned labels (0 = bg), scores and mask.
    Per image:

      * a detection matches a GT box when their labels are equal and their
        IoU exceeds ``fg_thres``;
      * the GT relations are the nonzero entries of ``rel_matrix`` between
        valid boxes, in row-major order, at most ``max_gt_rels``; each
        expands to every (head match, tail match) pair of distinct
        detections, of which at most ``num_sample_per_gt_rel`` are drawn
        without replacement with weights IoU(head) x IoU(tail) (Gumbel
        top-k, the distribution of ``npr.choice(p=w, replace=False)``);
      * the foreground is capped at ``int(batch_size * positive_fraction)``
        by a uniform draw;
      * the background pool is every pair of distinct valid detections
        with nonzero labels (with ``require_overlap``, boxes whose IoU is
        strictly between 0 and 1) that no GT relation's candidates hold;
        ``num_neg = min(batch_size - #fg, #pool)`` of them are drawn
        uniformly from the ``2 num_neg`` best by score product (ties by
        position);
      * with no foreground and no background, two (0, 0) pairs of label 0
        (the reference's dummy triplets);
      * emitted: the foreground (in the order of the cap's draw), the
        background (in the order of its draw), then padding (label -1,
        mask False, pair (0, 0));
        ``min(batch_size, R K + D D)`` entries;
      * ``binary_rel`` marks every (head match, tail match) of a GT
        relation, both ways, the diagonal included.

    The draws come from ``generator`` (on the tensors' device); they cannot
    repeat ``jax.random``'s, so the sampler is held to the rules above.
    Under data parallelism (``dp``) each draw is made at the global batch's
    size (its other axes are the padded shapes: GT boxes, detections) and
    this rank keeps its own images' rows.
    """
    b, t = tgt_mask.shape
    d = prp_mask.shape[1]
    dev = prp_mask.device
    num_pos = int(batch_size * positive_fraction)
    r = min(max_gt_rels, t * t)
    k = num_sample_per_gt_rel
    inf = torch.full((), float("inf"), device=dev)

    # ---- GT relation list, row-major, budget R
    flat_rel = rel_matrix.reshape(b, -1).long()
    flat_all = rel_matrix_all.reshape(b, -1).long()
    ti = torch.arange(t, device=dev)
    pair_valid = ((flat_rel != 0) & tgt_mask[:, ti.repeat_interleave(t)]
                  & tgt_mask[:, ti.repeat(t)])
    order = torch.sort((~pair_valid).to(torch.uint8), dim=1, stable=True)[1][:, :r]
    rel_valid = torch.gather(pair_valid, 1, order)
    rel_h, rel_t = order // t, order % t
    rel_lab = torch.gather(flat_rel, 1, order).clamp(min=0)
    rel_lab_all = torch.gather(flat_all, 1, order).clamp(min=0)

    # ---- matching
    ious = box_iou(tgt_boxes.float(), prp_boxes.float())           # (B, T, D)
    ious = torch.where(tgt_mask[:, :, None] & prp_mask[:, None, :], ious, 0.0)
    is_match = ((tgt_labels[:, :, None].long() == prp_labels[:, None, :].long())
                & (ious > fg_thres))

    def rows(x, idx):  # x (B, T, D) at GT indices idx (B, R) → (B, R, D)
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, d))

    mh = rows(is_match, rel_h) & rel_valid[..., None]
    mt = rows(is_match, rel_t) & rel_valid[..., None]
    notself = ~torch.eye(d, dtype=torch.bool, device=dev)
    cand = mh[:, :, :, None] & mt[:, :, None, :] & notself           # (B,R,D,D)
    marks = torch.einsum("bri,brj->bij", mh.float(), mt.float()) > 0
    binary_rel = (marks | marks.transpose(1, 2)).to(torch.int32)

    # ---- at most K pairs a GT relation, weighted: Gumbel top-k
    w = rows(ious, rel_h)[:, :, :, None] * rows(ious, rel_t)[:, :, None, :]
    u = distributed.rand(dp, (b, r, d * d), generator, dev)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    key = torch.where(cand.reshape(b, r, -1),
                      torch.log(w.reshape(b, r, -1).clamp(min=1e-20)) + gumbel,
                      -inf)
    top_key, top_flat = torch.topk(key, min(k, d * d), dim=-1)
    fg_sel = (top_key > -inf).reshape(b, -1)
    fg_head = (top_flat // d).reshape(b, -1)
    fg_tail = (top_flat % d).reshape(b, -1)
    kk = top_key.shape[-1]
    fg_lab = rel_lab[..., None].expand(-1, -1, kk).reshape(b, -1)
    fg_lab_all = rel_lab_all[..., None].expand(-1, -1, kk).reshape(b, -1)

    # the foreground cap, a uniform draw
    uf = distributed.rand(dp, fg_sel.shape, generator, dev)
    fg_rank = _rank(torch.where(fg_sel, uf, inf))
    fg_keep = fg_sel & (fg_rank < num_pos)
    num_fg = fg_keep.sum(1, keepdim=True)

    # ---- background pool
    if require_overlap:
        self_iou = box_iou(prp_boxes.float(), prp_boxes.float())
        possibility = (self_iou > 0) & (self_iou < 1)
    else:
        possibility = notself.expand(b, d, d)
    lab_ok = prp_mask & (prp_labels > 0)
    possibility = (possibility & lab_ok[:, :, None] & lab_ok[:, None, :]
                   & ~cand.any(1)).reshape(b, -1)
    quality = (prp_scores[:, :, None].float()
               * prp_scores[:, None, :].float()).reshape(b, -1)
    num_neg = torch.minimum(batch_size - num_fg, possibility.sum(1, keepdim=True))
    q_rank = _rank(torch.where(possibility, -quality, inf))
    eligible = possibility & (q_rank < 2 * num_neg)
    ub = distributed.rand(dp, possibility.shape, generator, dev)
    bg_rank = _rank(torch.where(eligible, ub, inf))
    bg_keep = eligible & (bg_rank < num_neg)

    # ---- fg (in rank order), then bg, then padding
    nfg, nbg = fg_sel.shape[1], d * d
    big = nfg + nbg
    ar_fg = torch.arange(nfg, device=dev)
    ar_bg = torch.arange(nbg, device=dev)
    all_key = torch.cat([torch.where(fg_keep, fg_rank, big + ar_fg),
                         torch.where(bg_keep, num_pos + bg_rank, 2 * big + ar_bg)], 1)
    all_head = torch.cat([fg_head, (ar_bg // d).expand(b, -1)], 1)
    all_tail = torch.cat([fg_tail, (ar_bg % d).expand(b, -1)], 1)
    zeros = torch.zeros((b, nbg), dtype=torch.long, device=dev)
    all_lab = torch.cat([fg_lab, zeros], 1)
    all_lab_all = torch.cat([fg_lab_all, zeros], 1)
    all_keep = torch.cat([fg_keep, bg_keep], 1)

    sel = torch.argsort(all_key, dim=1)[:, :batch_size]  # the keys are distinct
    mask = torch.gather(all_keep, 1, sel)
    p = sel.shape[1]
    empty = (num_fg + bg_keep.sum(1, keepdim=True)) == 0
    dummy = empty & (torch.arange(p, device=dev) < 2)
    mask = mask | dummy
    real = mask & ~dummy
    pair_idx = torch.stack([torch.gather(all_head, 1, sel),
                            torch.gather(all_tail, 1, sel)], -1)
    pair_idx = torch.where(real[..., None], pair_idx, 0)

    def labels_of(lab):
        out = torch.where(real, torch.gather(lab, 1, sel),
                          torch.where(dummy, 0, -1))
        return torch.where(mask, out, -1).to(torch.int32)

    return DetRelSample(pair_idx=pair_idx.to(torch.int32), labels=labels_of(all_lab),
                        labels_all=labels_of(all_lab_all), mask=mask,
                        binary_rel=binary_rel)
