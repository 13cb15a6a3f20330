"""MEET: the mutually-exclusive-expert ensemble over predicate frequency
groups (``veto_tpu/models/relation/predictor_meet.py``).

The VETO trunk (embedding the hard object label in every mode) feeds G
per-group heads per expert, each a Linear ``dim → gs + 2``: the
background at 0, the group's predicates, and an out-of-distribution class
last.  Groups are consecutive ranges of the frequency-ranked predicate
ids, so every remap is an offset.

  * Training: each sampled pair is routed to a prefix of the groups
    (:func:`meet_route`, one draw shared by the experts); per group the
    labels are remapped in-group (:func:`meet_group_labels`: background 0,
    a member its 1-based position, any other predicate ``gs + 1``), and
    each (expert, group) head takes a plain cross-entropy over the pairs
    routed to it (:func:`meet_losses`).
  * Evaluation: every group proposes its best member for every pair, and
    the G·P candidates of an image compete in one stable sort by triple
    score (:func:`postprocess_meet_single`); with 3 experts a group's
    candidate survives only if the experts agree (:func:`postprocess_meet_voting`,
    consensus ``'C'`` or unanimous ``'U'``).

The heads run in f32 on the trunk feature cast to f32, all of an expert
set's heads as one product over their concatenated columns (one GEMM in
place of G·E); PyTorch's default keeps TF32 off for that product, as for
``rel_out``.  Nothing here has a kernel of its own: the JAX package runs
it outside Pallas too.  Everything is batched over images: (B, P) pairs,
(B, N) objects.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...engine import distributed
from ...ops.nms import first_argmax
from ..layers import Dense
from .predictor_veto import VetoTrunk, weighted_ce_loss


class MeetConfig(NamedTuple):
    """MEET's constants from the dataset's predicate statistics.
    ``incre_idx`` and ``sample_rate`` are numpy arrays, or tensors on the
    device of the labels they route (``TrainState.meet``)."""

    group_sizes: Tuple[int, ...]
    incre_idx: object     # (C,) 1-based group of each predicate, 0 for bg
    sample_rate: object   # (G, C) routing thresholds
    experts_per_group: int
    voting: str           # 'C' | 'U'


VOTING = ("C", "U")


def make_meet_config(dataset: str = "VG", split: str = "divide4",
                     expert_group: bool = False, voting: str = "C") -> MeetConfig:
    """The routing constants of ``dataset``'s ``split``, with 3 experts a
    group when ``expert_group``."""
    from ...data.predicate_stats import (
        generate_sample_rate_matrix, get_group_splits, incre_idx_list,
        predicate_counts,
    )

    if voting not in VOTING:
        raise ValueError(f"ensemble.voting={voting!r}: expected one of {VOTING}")
    _, sizes = get_group_splits(dataset, split)
    return MeetConfig(
        group_sizes=tuple(sizes),
        incre_idx=incre_idx_list(sizes, len(predicate_counts(dataset))),
        sample_rate=generate_sample_rate_matrix(dataset, sizes),
        experts_per_group=3 if expert_group else 1, voting=voting)


def group_starts(group_sizes: Sequence[int]) -> np.ndarray:
    """First frequency-ranked predicate id of each group."""
    return np.cumsum([1] + list(group_sizes))[:-1]


class MeetPredictorOutput(NamedTuple):
    group_logits: Tuple[Tuple[torch.Tensor, ...], ...]  # [e][k]: (B, P, gs + 2) f32
    obj_dists: torch.Tensor                             # (B, N, num_obj) one-hot

    @property
    def rel_logits(self):
        """The group logits, in the slot the VETO predictor's logits ride
        in (``SGGForward.rel_logits``, the train step's losses)."""
        return self.group_logits


class MeetPredictor(nn.Module):
    """The VETO trunk with ``hard_label_embed`` and E x G f32 heads
    ``rel_out_e{e}_g{k}`` of ``gs + 2`` classes."""

    def __init__(self, group_sizes: Sequence[int] = (4, 6, 9, 19, 12),
                 experts_per_group: int = 1, num_obj_classes: int = 151,
                 embed_dim: int = 200, dim: int = 576, layers: int = 6,
                 heads: int = 6, patch_size: int = 2, depth_proj_dim: int = 512,
                 visual_proj_dim: int = 64, rgb_channels: int = 256,
                 depth_channels: int = 256, dtype: torch.dtype = torch.bfloat16,
                 encoder_impl: str = "fused", mode: str = "predcls"):
        super().__init__()
        self.num_obj_classes = num_obj_classes
        self.group_sizes = tuple(group_sizes)
        self.experts_per_group = experts_per_group
        self.trunk = VetoTrunk(num_obj_classes, embed_dim, dim, layers, heads,
                               patch_size, depth_proj_dim, visual_proj_dim,
                               rgb_channels, depth_channels, dtype, encoder_impl,
                               mode, hard_label_embed=True)
        self.head_names = [f"rel_out_e{e}_g{k}" for e in range(experts_per_group)
                           for k in range(len(self.group_sizes))]
        for e in range(experts_per_group):
            for k, gs in enumerate(self.group_sizes):
                self.add_module(f"rel_out_e{e}_g{k}",
                                Dense(dim, gs + 2, dtype=torch.float32))

    def heads(self, feat: torch.Tensor) -> Tuple[Tuple[torch.Tensor, ...], ...]:
        """The trunk feature (B, P, dim) → every head's f32 logits, [e][k]:
        (B, P, gs + 2), as one product over the heads' concatenated
        columns."""
        heads = [getattr(self, n) for n in self.head_names]
        out = F.linear(feat.float(), torch.cat([h.weight for h in heads]),
                       torch.cat([h.bias for h in heads]))
        cols = out.split([h.out_features for h in heads], dim=-1)
        g = len(self.group_sizes)
        return tuple(tuple(cols[e * g: (e + 1) * g])
                     for e in range(self.experts_per_group))

    def forward(self, boxes, box_mask, obj_labels, pair_idx, roi_features,
                depth_features, obj_logits=None) -> MeetPredictorOutput:
        feat = self.trunk(boxes, box_mask, obj_labels, pair_idx, roi_features,
                          depth_features, obj_logits)
        obj_dists = F.one_hot(obj_labels.long(), self.num_obj_classes).float()
        return MeetPredictorOutput(self.heads(feat), obj_dists)


# ------------------------------------------------------------- training
def meet_route(generator: torch.Generator, labels: torch.Tensor,
               mask: torch.Tensor, incre_idx, sample_rate,
               dp=None) -> torch.Tensor:
    """Group membership (..., G) bool of each sample: a background sample
    goes to one group drawn uniformly, a foreground one to the groups
    ``[0, act)`` where ``act`` is the largest stage whose threshold accepts
    one uniform draw, or whose number is below the label's own group; a
    masked sample to none.  Draws (first the background groups, then the
    uniforms) from ``generator``, on the labels' device; under data
    parallelism (``dp``) this rank's rows of draws at the global batch's
    size."""
    dev = labels.device
    incre_idx = torch.as_tensor(incre_idx, device=dev)
    sample_rate = torch.as_tensor(sample_rate, device=dev)
    g = sample_rate.shape[0]
    safe = labels.clamp(min=0).long()
    bg_group = distributed.randint(dp, 0, g, labels.shape, generator, dev)
    u = distributed.rand(dp, labels.shape, generator, dev)
    acts = torch.arange(1, g + 1, device=dev)
    thresholds = sample_rate[:, safe].movedim(0, -1)                   # (..., G)
    cond = (u[..., None] <= thresholds) | (acts < incre_idx[safe][..., None])
    act = torch.where(cond, acts, 0).amax(-1)
    fg_member = torch.arange(g, device=dev) < act[..., None]
    bg_member = F.one_hot(bg_group, g).bool()
    member = torch.where((labels == 0)[..., None], bg_member, fg_member)
    return member & mask[..., None]


def meet_group_labels(labels: torch.Tensor,
                      group_sizes: Sequence[int]) -> List[torch.Tensor]:
    """Per group, the in-group labels: background 0, a member its 1-based
    position, any other predicate ``gs + 1``; padding (-1) stays -1."""
    out = []
    for start, gs in zip(group_starts(group_sizes).tolist(), group_sizes):
        in_group = (labels >= start) & (labels < start + gs)
        remapped = torch.where(labels == 0, 0,
                               torch.where(in_group, labels - start + 1, gs + 1))
        out.append(torch.where(labels >= 0, remapped, -1))
    return out


def meet_losses(generator: Optional[torch.Generator], group_logits, labels,
                mask, incre_idx, sample_rate, group_sizes: Sequence[int],
                member: Optional[torch.Tensor] = None,
                dp=None) -> Dict[str, torch.Tensor]:
    """The cross-entropy of each (expert, group) head over the samples
    routed to it, no class weights, keyed ``group_{k}{e+1}_CE_loss``
    expert-major.  The routing is :func:`meet_route`'s draw from
    ``generator``, shared by the experts, unless ``member`` (..., G) is
    given.  A group no sample reached has loss 0.  Under data parallelism
    (``dp``) each loss takes the global batch's denominator."""
    if member is None:
        member = meet_route(generator, labels, mask, incre_idx, sample_rate, dp)
    glabels = meet_group_labels(labels, group_sizes)
    losses = {}
    for e, expert in enumerate(group_logits):
        for k, logits in enumerate(expert):
            losses[f"group_{k}{e + 1}_CE_loss"] = weighted_ce_loss(
                logits, glabels[k], member[..., k] & mask, None, dp)
    return losses


# ----------------------------------------------------------- evaluation
class MeetPrediction(NamedTuple):
    pair_idx: torch.Tensor    # (B, G*P, 2) sorted by triple score desc
    rel_scores: torch.Tensor  # (B, G*P, C) probabilities scattered to global ids
    rel_labels: torch.Tensor  # (B, G*P) global predicate ids
    pair_mask: torch.Tensor   # (B, G*P)
    obj_labels: torch.Tensor  # (B, N)
    obj_scores: torch.Tensor  # (B, N)


def _group_best(logits: torch.Tensor, start: int, gs: int, num_rel: int):
    """One group head's (B, P, gs + 2) logits → each pair's best member:
    its probability, its global id (the first maximum, as ``jnp.argmax``)
    and the (B, P, C) row of the softmax without the OOD class, scattered
    to the global ids (background at 0)."""
    prob = torch.softmax(logits.float(), dim=-1)[..., :-1]
    fg = prob[..., 1:]
    idx = torch.arange(gs, device=fg.device).expand(fg.shape)
    cls = first_argmax(fg, idx)
    scat = torch.zeros(fg.shape[:-1] + (num_rel,), dtype=torch.float32,
                       device=fg.device)
    scat[..., 0] = prob[..., 0]
    scat[..., start: start + gs] = fg
    return fg.amax(-1), (cls + start).to(torch.int32), scat


def _rank(scores, labels, probs, masks, pair_idx, obj_labels, obj_scores):
    """Concatenate the groups' candidates along the pair axis and sort them
    by triple score, descending and stable (``jnp.argsort``), the masked
    ones last."""
    g = len(scores)
    all_scores = torch.cat(scores, dim=1)
    all_mask = torch.cat(masks, dim=1)
    key = torch.where(all_mask, -all_scores,
                      torch.full((), float("inf"), device=all_scores.device))
    order = torch.sort(key, dim=1, stable=True).indices

    def take(x):
        idx = order.reshape(order.shape + (1,) * (x.dim() - 2))
        return torch.gather(x, 1, idx.expand(order.shape + x.shape[2:]))

    return MeetPrediction(
        pair_idx=take(pair_idx.repeat(1, g, 1)), rel_scores=take(torch.cat(probs, 1)),
        rel_labels=take(torch.cat(labels, 1)), pair_mask=take(all_mask),
        obj_labels=obj_labels, obj_scores=obj_scores)


def _subj_obj_scores(obj_scores, pair_idx):
    return (torch.gather(obj_scores, 1, pair_idx[..., 0].long()),
            torch.gather(obj_scores, 1, pair_idx[..., 1].long()))


def postprocess_meet_single(group_logits: Sequence[torch.Tensor],
                            obj_labels: torch.Tensor, obj_scores: torch.Tensor,
                            pair_idx: torch.Tensor, pair_mask: torch.Tensor,
                            group_sizes: Sequence[int],
                            num_rel_classes: int) -> MeetPrediction:
    """One expert's group logits ([k]: (B, P, gs + 2)) → the G·P candidates
    of each image, each group's best member of each pair at triple score
    ``p · s_subj · s_obj``, ranked.  The object labels and scores are the
    caller's."""
    s0, s1 = _subj_obj_scores(obj_scores, pair_idx)
    scores, labels, probs = [], [], []
    for start, gs, logits in zip(group_starts(group_sizes).tolist(), group_sizes,
                                 group_logits):
        sc, lab, scat = _group_best(logits, start, gs, num_rel_classes)
        scores.append(sc * s0 * s1)
        labels.append(lab)
        probs.append(scat)
    return _rank(scores, labels, probs, [pair_mask] * len(scores), pair_idx,
                 obj_labels, obj_scores)


def postprocess_meet_voting(group_logits, obj_labels: torch.Tensor,
                            obj_scores: torch.Tensor, pair_idx: torch.Tensor,
                            pair_mask: torch.Tensor, group_sizes: Sequence[int],
                            num_rel_classes: int,
                            voting: str = "C") -> MeetPrediction:
    """Three experts a group ([e][k]: (B, P, gs + 2)) vote.  Consensus
    ``'C'``: a pair survives a group if two experts agree on its class; its
    score and probabilities average over the agreeing expert pairs, and
    the class of the last agreeing pair in the order (0, 1), (1, 2),
    (0, 2) wins.  Unanimous ``'U'``: all three must agree; the average
    is over the three.  The pair (1, 2) averages experts 1 and 2, as in
    the JAX package (the reference averaged expert 1 with itself)."""
    if len(group_logits) != 3:
        raise ValueError("voting needs 3 experts a group")
    if voting not in VOTING:
        raise ValueError(f"voting={voting!r}: expected one of {VOTING}")
    s0, s1 = _subj_obj_scores(obj_scores, pair_idx)
    scores, labels, probs, masks = [], [], [], []
    for k, (start, gs) in enumerate(zip(group_starts(group_sizes).tolist(),
                                        group_sizes)):
        per_e = [_group_best(group_logits[e][k], start, gs, num_rel_classes)
                 for e in range(3)]
        tr = [sc * s0 * s1 for sc, _, _ in per_e]
        cls = [lab for _, lab, _ in per_e]
        pr = [scat for _, _, scat in per_e]
        agree = [cls[0] == cls[1], cls[1] == cls[2], cls[0] == cls[2]]
        if voting == "C":
            pair_t = [(tr[0] + tr[1]) / 2, (tr[1] + tr[2]) / 2, (tr[0] + tr[2]) / 2]
            pair_p = [(pr[0] + pr[1]) / 2, (pr[1] + pr[2]) / 2, (pr[0] + pr[2]) / 2]
            count = sum(a.float() for a in agree)
            t_sum = sum(torch.where(a, t, 0.0) for a, t in zip(agree, pair_t))
            p_sum = sum(torch.where(a[..., None], p, 0.0)
                        for a, p in zip(agree, pair_p))
            safe = count.clamp(min=1.0)
            triple = torch.where(count > 0, t_sum / safe, 0.0)
            prob = torch.where(count[..., None] > 0, p_sum / safe[..., None], 0.0)
            rel_class = torch.zeros_like(cls[0])
            for a, c in zip(agree, (cls[0], cls[1], cls[0])):
                rel_class = torch.where(a, c, rel_class)
            keep = agree[0] | agree[1] | agree[2]
        else:
            triple = (tr[0] + tr[1] + tr[2]) / 3
            prob = (pr[0] + pr[1] + pr[2]) / 3
            rel_class = cls[0]
            keep = agree[0] & agree[1] & agree[2]
        scores.append(triple)
        labels.append(rel_class)
        probs.append(prob)
        masks.append(keep & pair_mask)
    return _rank(scores, labels, probs, masks, pair_idx, obj_labels, obj_scores)


def postprocess_meet(meet: MeetConfig, group_logits, obj_labels, obj_scores,
                     pair_idx, pair_mask, num_rel_classes: int) -> MeetPrediction:
    """Voting with 3 experts a group, else the single expert's ranking."""
    if meet.experts_per_group == 3:
        return postprocess_meet_voting(group_logits, obj_labels, obj_scores,
                                       pair_idx, pair_mask, meet.group_sizes,
                                       num_rel_classes, meet.voting)
    return postprocess_meet_single(group_logits[0], obj_labels, obj_scores,
                                   pair_idx, pair_mask, meet.group_sizes,
                                   num_rel_classes)
