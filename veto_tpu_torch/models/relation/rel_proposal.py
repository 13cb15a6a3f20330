"""The relation-confidence pre-classifier (``veto_tpu/models/relation/
rel_proposal.py``): :class:`RelAwareRelFeature`, BGNN's relatedness
("relness") estimate of each pair, and its auxiliary loss
:func:`rel_aware_focal_loss` (the engine's ``pre_rel_classify_loss``).

The ``hybrid`` pre-classifier, the JAX module's default and the only one
its predictors build: per-foreground-class logits (C - 1) from the pair's
geometry, the soft class embeddings of its two boxes and its (detached)
visual features, plus a fused binary logit whose sigmoid is the pair's
relness.  Padded pairs score 0.  Everything here is plain PyTorch; the
JAX package computes it with XLA outside Pallas.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.box_ops import encode_box_info
from ..layers import Dense, LayerNorm
from .legacy.context import soft_embed, take_rows


class RelnessOutput(NamedTuple):
    logits: torch.Tensor  # (B, P, C) f32: C - 1 class logits, then the binary one
    scores: torch.Tensor  # (B, P) f32 sigmoid relness, 0 on padded pairs


class RelAwareRelFeature(nn.Module):
    """The pair scorer: geometry (9 → 128 → 128 a box) and the soft
    semantic embedding of both boxes → ``proposal_box_feat_extract``; the
    detached visual features → ``vis_embed``; fused through LayerNorms into
    the C - 1 class logits and the binary ``fusion_layer`` (both f32)."""

    def __init__(self, num_obj_classes: int = 151, num_rel_classes: int = 51,
                 visual_dim: int = 4096, embed_dim: int = 200,
                 geometry_dim: int = 128, hidden_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.obj_sem_embed = nn.Embedding(num_obj_classes, embed_dim)
        self.pos_fc1 = Dense(9, geometry_dim, dtype=dtype)
        self.pos_fc2 = Dense(geometry_dim, geometry_dim, dtype=dtype)
        self.proposal_box_feat_extract = Dense(2 * (geometry_dim + embed_dim),
                                               hidden_dim, dtype=dtype)
        self.vis_embed = Dense(visual_dim, hidden_dim, dtype=dtype)
        self.fusion_ln = LayerNorm(2 * hidden_dim)
        self.proposal_feat_fusion = Dense(2 * hidden_dim, hidden_dim, dtype=dtype)
        self.cls_ln = LayerNorm(hidden_dim)
        self.proposal_relness_cls_fc = Dense(hidden_dim, num_rel_classes - 1,
                                             dtype=torch.float32)
        self.fusion_layer = Dense(num_rel_classes - 1, 1, dtype=torch.float32)

    def forward(self, visual_feat, boxes, predict_logits, pair_idx, pair_mask,
                image_sizes) -> RelnessOutput:
        cdt = self.dtype
        sem = soft_embed(self.obj_sem_embed, predict_logits.detach(), cdt)
        pos = self.pos_fc1(encode_box_info(boxes, image_sizes).to(cdt))
        pos = self.pos_fc2(F.relu(pos))
        si, oi = pair_idx[..., 0], pair_idx[..., 1]
        symb = torch.cat([take_rows(pos, si), take_rows(sem, si), take_rows(pos, oi),
                          take_rows(sem, oi)], -1)
        geo = self.proposal_box_feat_extract(F.relu(symb))
        vis = self.vis_embed(F.relu(visual_feat.detach().to(cdt)))
        x = self.proposal_feat_fusion(F.relu(self.fusion_ln(torch.cat([vis, geo], -1))))
        logits = self.proposal_relness_cls_fc(F.relu(self.cls_ln(x)))
        bin_logit = self.fusion_layer(logits)
        scores = torch.where(pair_mask, torch.sigmoid(bin_logit[..., 0]), 0.0)
        return RelnessOutput(torch.cat([logits, bin_logit], -1), scores)


def rel_aware_focal_loss(logits: torch.Tensor, rel_labels: torch.Tensor,
                         pair_mask: torch.Tensor, num_rel_classes: int,
                         alpha: float = 1.0, gamma: float = 2.0) -> torch.Tensor:
    """The focal BCE of the (B, P, C) hybrid logits against the one-hot
    foreground class and the binary foreground column, summed over the
    classes and the valid pairs of each image, divided by the count of
    positive targets of the batch (at least 1), averaged over the images."""
    fg = rel_labels > 0
    onehot = F.one_hot(torch.clamp(rel_labels, min=0).long(),
                       num_rel_classes)[..., 1:].float()
    onehot = torch.where(fg[..., None], onehot, 0.0)
    targets = torch.cat([onehot, fg.float()[..., None]], -1)
    x = logits.float()
    bce = torch.clamp(x, min=0) - x * targets + torch.log1p(torch.exp(-x.abs()))
    focal = alpha * (1.0 - torch.exp(-bce)) ** gamma * bce
    focal = torch.where(pair_mask[..., None], focal, 0.0).sum(-1)
    n_fg = torch.clamp((targets > 0).sum(), min=1)
    return (focal.sum(-1) / n_fg).mean()
