"""Relation post-processing (``veto_tpu/models/relation/postprocess.py``
``postprocess_relations``), batched: logits → triplets ranked by score."""

from __future__ import annotations

from typing import NamedTuple

import torch


class RelPrediction(NamedTuple):
    pair_idx: torch.Tensor    # (B, P, 2) sorted by triple score desc
    rel_scores: torch.Tensor  # (B, P, C) softmax over predicates (bg at 0)
    rel_labels: torch.Tensor  # (B, P) argmax fg predicate
    pair_mask: torch.Tensor   # (B, P)
    obj_labels: torch.Tensor  # (B, N) predicted object classes
    obj_scores: torch.Tensor  # (B, N) predicted object scores


def postprocess_relations(rel_logits: torch.Tensor, obj_dists: torch.Tensor,
                          pair_idx: torch.Tensor,
                          pair_mask: torch.Tensor) -> RelPrediction:
    """(B, P, C) logits, (B, N, num_obj) object logits → RelPrediction.

    Object softmax with background zeroed, fg-predicate argmax per pair,
    triple score = rel · subj · obj, and a stable descending sort (the
    JAX package's ``jnp.argsort`` is stable too).
    """
    obj_prob = torch.softmax(obj_dists.float(), dim=-1)
    obj_prob[..., 0] = 0.0
    obj_scores, obj_labels = obj_prob[..., 1:].max(dim=-1)
    obj_labels = obj_labels + 1

    rel_prob = torch.softmax(rel_logits.float(), dim=-1)
    rel_fg, rel_labels = rel_prob[..., 1:].max(dim=-1)
    rel_labels = rel_labels + 1

    si, oi = pair_idx[..., 0].long(), pair_idx[..., 1].long()
    triple = (rel_fg * torch.gather(obj_scores, 1, si)
              * torch.gather(obj_scores, 1, oi))
    triple = torch.where(pair_mask, triple,
                         torch.full((), -float("inf"), device=triple.device))
    order = torch.argsort(-triple, dim=1, stable=True)

    def take(x):
        idx = order.reshape(order.shape + (1,) * (x.dim() - 2))
        return torch.gather(x, 1, idx.expand(order.shape + x.shape[2:]))

    return RelPrediction(
        pair_idx=take(pair_idx), rel_scores=take(rel_prob),
        rel_labels=take(rel_labels), pair_mask=take(pair_mask),
        obj_labels=obj_labels.to(torch.int32), obj_scores=obj_scores)
