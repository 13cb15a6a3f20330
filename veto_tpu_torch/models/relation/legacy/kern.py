"""KERN, the knowledge-embedded routing network
(``veto_tpu/models/relation/legacy/kern.py``).

Per pair, a gated graph network (:class:`GGNNRel`) over [subject, object,
one node per foreground predicate] runs ``time_steps`` rounds of
"Gated Graph Sequence Neural Networks" (eq. 2-5), its adjacency the
statistical prior P(predicate | subject class, object class) of the pair's
classes.  The reset gate reuses ``fc_eq3_u``, as the reference does (kept
for weight-for-weight parity).  With no ``prior_matrix`` the prior is the
uniform 1/C, as the JAX model builds it (the dataset statistics come with
``data/statistics.py``, not here).

The pair gathers are products with the incidence matrix
(``context.take_rows``).  No kernel of its own: the JAX module runs on XLA
outside Pallas.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Dense
from ..freq_bias import FrequencyBias
from .context import PairwiseFeatureExtractor, take_rows
from .predictors import LegacyOutput, first_argmax_labels, pair_classes


class GGNNRel(nn.Module):
    """(B, P, h) subject, object and predicate features and the (B, P, C - 1)
    prior rows → (B, P, output_dim): the nodes' final states beside their
    initial ones, averaged over the 2 + C - 1 nodes, through ``fc_output``
    and a ReLU."""

    def __init__(self, num_rel_classes: int = 51, time_steps: int = 3,
                 hidden_dim: int = 512, output_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        h = hidden_dim
        self.num_pred, self.time_steps = num_rel_classes - 1, time_steps
        self.dtype = dtype
        self.fc_eq3_w = Dense(2 * h, h, dtype=dtype)
        self.fc_eq3_u = Dense(h, h, dtype=dtype)
        self.fc_eq4_w = Dense(2 * h, h, dtype=dtype)
        self.fc_eq5_w = Dense(2 * h, h, dtype=dtype)
        self.fc_eq5_u = Dense(h, h, dtype=dtype)
        self.fc_output = Dense(2 * h, output_dim, dtype=dtype)

    def forward(self, ent_sub, ent_obj, rel_feat, prior) -> torch.Tensor:
        cdt = self.dtype
        b, p, h = ent_sub.shape
        c = self.num_pred
        x0 = torch.cat([ent_sub[:, :, None].to(cdt), ent_obj[:, :, None].to(cdt),
                        rel_feat[:, :, None].to(cdt).expand(b, p, c, h)], 2)
        a_sub = torch.stack([prior, prior], 2).to(cdt)  # (B, P, 2, C - 1)
        hidden = x0
        for _ in range(self.time_steps):
            # eq. 2: the predicates' states to the entities, and back
            av_ent = torch.einsum("bpnc,bpch->bpnh", a_sub, hidden[:, :, 2:])
            av_pred = torch.einsum("bpnc,bpnh->bpch", a_sub, hidden[:, :, :2])
            av = torch.cat([av_ent, av_pred], 2)
            av = torch.cat([av, av], -1)  # the reference's repeat(..., 2)
            u = self.fc_eq3_u(hidden)
            zv = torch.sigmoid(self.fc_eq3_w(av) + u)
            rv = torch.sigmoid(self.fc_eq4_w(av) + u)  # fc_eq3_u reused
            hv = torch.tanh(self.fc_eq5_w(av) + self.fc_eq5_u(rv * hidden))
            hidden = (1 - zv) * hidden + zv * hv
        return F.relu(self.fc_output(torch.cat([hidden, x0], -1).mean(2)))


class KERNPredictor(nn.Module):
    """The base KERN head over the pairwise features: ``instance_fc`` on the
    augmented objects, ``rel_union_feat_fc`` on the pairs, the GGNN over
    each pair, ``rel_classifier`` and the frequency bias; outside PredCls
    ``obj_classifier`` on the objects (the labels its argmax).  The prior
    and the bias key on the labels it embeds: the JAX model gives KERN no
    ``pred_labels``, so they are ``obj_labels`` and the port's
    ``pred_labels`` argument is ignored."""

    def __init__(self, num_obj_classes: int = 151, num_rel_classes: int = 51,
                 embed_dim: int = 200, hidden_dim: int = 512, pooling_dim: int = 4096,
                 in_channels: int = 4096, time_steps: int = 3, mode: str = "predcls",
                 prior_matrix: Optional[np.ndarray] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_obj_classes, self.mode = num_obj_classes, mode
        self.pairwise_feature_extractor = PairwiseFeatureExtractor(
            num_obj_classes, embed_dim, hidden_dim, pooling_dim, in_channels, mode,
            dtype)
        self.instance_fc = Dense(pooling_dim, hidden_dim, dtype=dtype)
        self.rel_union_feat_fc = Dense(pooling_dim, hidden_dim, dtype=dtype)
        if prior_matrix is not None:  # drop the background predicate column
            prior = torch.as_tensor(np.asarray(prior_matrix, np.float32)[..., 1:])
        else:
            prior = torch.full((num_obj_classes, num_obj_classes, num_rel_classes - 1),
                               1.0 / num_rel_classes)
        self.register_buffer("prior_tbl", prior, persistent=False)
        self.ggnn_rel = GGNNRel(num_rel_classes, time_steps, hidden_dim, hidden_dim,
                                dtype)
        self.rel_classifier = Dense(hidden_dim, num_rel_classes, dtype=torch.float32)
        if mode != "predcls":
            self.obj_classifier = Dense(hidden_dim, num_obj_classes, dtype=torch.float32)
        self.freq_bias = FrequencyBias(num_obj_classes, num_rel_classes)

    def forward(self, boxes, box_mask, obj_labels, predict_logits, pair_idx,
                roi_features, union_features, image_sizes, boxes_per_cls=None,
                gumbel=None, forest=None, pair_mask=None,
                pred_labels=None) -> LegacyOutput:
        aug_obj, rel_feats = self.pairwise_feature_extractor(
            roi_features, union_features, boxes, obj_labels, predict_logits,
            obj_labels, pair_idx, image_sizes)
        ent = self.instance_fc(aug_obj)
        rel = self.rel_union_feat_fc(rel_feats)
        pair_lab = pair_classes(obj_labels, pair_idx)
        prior = self.prior_tbl[pair_lab[..., 0], pair_lab[..., 1]]  # (B, P, C - 1)
        si, oi = pair_idx[..., 0], pair_idx[..., 1]
        out = self.ggnn_rel(take_rows(ent, si), take_rows(ent, oi), rel, prior)
        rel_dists = self.rel_classifier(out) + self.freq_bias(pair_lab)
        if self.mode == "predcls":
            obj_dists = F.one_hot(obj_labels.long(), self.num_obj_classes).float()
        else:
            obj_dists = self.obj_classifier(ent)
        return LegacyOutput(obj_dists, rel_dists, first_argmax_labels(obj_dists))
