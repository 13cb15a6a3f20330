"""The diagnostic baselines (``veto_tpu/models/relation/legacy/naive.py``):
the Naive sum-fusion head and the relatedness test.

Both build the object features of :class:`~.context.PairwiseFeatureExtractor`,
split them into a head and a tail half (``pairwise_obj_feat_updim_fc``),
join each pair's two halves through ``output_fc``, gate the join by a net
of the pair's 32-d geometry (``spt_emb_fc1`` / ``spt_emb_fc2``), and
classify the sum of the union features and the gated join
(``rel_classifier``) plus the frequency bias of the pair's labels.
:class:`RelatednessTestPredictor` also runs the relation-confidence
pre-classifier (``rel_proposal.RelAwareRelFeature``) on
``rel_pn_fc(relu(union + join))`` and returns its ``relness_logits``, which
the train step takes into ``pre_rel_classify_loss``.

Both embed ``pred_labels`` beside the labels (the JAX model passes them to
these two and IMP only); outside PredCls the object logits are the
proposals' and the labels ``pred_labels``.  The pair gathers are products
with the incidence matrix (``context.take_rows``).  No kernel of its own:
the JAX module runs on XLA outside Pallas.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Dense
from ..freq_bias import FrequencyBias
from ..rel_proposal import RelAwareRelFeature
from .context import PairwiseFeatureExtractor, box_pair_info, take_rows
from .predictors import LegacyOutput, pair_classes, valid_pairs


class NaivePredictor(nn.Module):
    """The sum-fusion baseline head; ``rel_pn_on`` adds the relation
    confidence (:class:`RelatednessTestPredictor`)."""

    rel_pn_on = False

    def __init__(self, num_obj_classes: int = 151, num_rel_classes: int = 51,
                 hidden_dim: int = 512, pooling_dim: int = 4096,
                 in_channels: int = 4096, mode: str = "predcls",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_obj_classes, self.mode = num_obj_classes, mode
        self.hidden_dim, self.dtype = hidden_dim, dtype
        self.obj_pair_feature_extractor = PairwiseFeatureExtractor(
            num_obj_classes, hidden_dim=hidden_dim, pooling_dim=pooling_dim,
            in_channels=in_channels, mode=mode, dtype=dtype)
        self.pairwise_obj_feat_updim_fc = Dense(pooling_dim, hidden_dim * 2, dtype=dtype)
        self.output_fc = Dense(hidden_dim * 2, pooling_dim, dtype=dtype)
        self.spt_emb_fc1 = Dense(32, hidden_dim, dtype=dtype)
        self.spt_emb_fc2 = Dense(hidden_dim, pooling_dim, dtype=dtype)
        if self.rel_pn_on:
            self.rel_pn_fc = Dense(pooling_dim, pooling_dim, dtype=dtype)
            self.rel_pn_module = RelAwareRelFeature(num_obj_classes, num_rel_classes,
                                                    visual_dim=pooling_dim, dtype=dtype)
        self.rel_classifier = Dense(pooling_dim, num_rel_classes, dtype=torch.float32)
        self.freq_bias = FrequencyBias(num_obj_classes, num_rel_classes)

    def forward(self, boxes, box_mask, obj_labels, predict_logits, pair_idx,
                roi_features, union_features, image_sizes, boxes_per_cls=None,
                gumbel=None, forest=None, pair_mask=None,
                pred_labels=None) -> LegacyOutput:
        cdt, h = self.dtype, self.hidden_dim
        pred_labels = obj_labels if pred_labels is None else pred_labels
        aug_obj, _ = self.obj_pair_feature_extractor(
            roi_features, union_features, boxes, obj_labels, predict_logits,
            pred_labels, pair_idx, image_sizes)
        fused = self.pairwise_obj_feat_updim_fc(aug_obj)
        pair_rep = torch.cat([take_rows(fused[..., :h], pair_idx[..., 0]),
                              take_rows(fused[..., h:], pair_idx[..., 1])], -1)
        pair_rep = F.relu(self.output_fc(pair_rep))
        geo = box_pair_info(boxes, image_sizes, pair_idx).to(cdt)
        pair_rep = pair_rep * F.relu(self.spt_emb_fc2(F.relu(self.spt_emb_fc1(geo))))
        uf = union_features.to(cdt)
        relness = None
        if self.rel_pn_on:
            pn_feat = self.rel_pn_fc(F.relu(uf + pair_rep))
            relness = self.rel_pn_module(pn_feat, boxes, predict_logits, pair_idx,
                                         valid_pairs(pair_mask, pair_idx),
                                         image_sizes).logits
        rel_dists = self.rel_classifier(uf + pair_rep)
        if self.mode == "predcls":
            obj_dists = F.one_hot(obj_labels.long(), self.num_obj_classes).float()
            obj_preds = obj_labels
        else:
            obj_dists = predict_logits.float()
            obj_preds = pred_labels
        rel_dists = rel_dists + self.freq_bias(pair_classes(obj_preds, pair_idx))
        return LegacyOutput(obj_dists, rel_dists, obj_preds, relness_logits=relness)


class RelatednessTestPredictor(NaivePredictor):
    """:class:`NaivePredictor` with the relation-confidence pre-classifier
    and its auxiliary loss."""

    rel_pn_on = True
