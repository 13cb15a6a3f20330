"""BGNN, GPSNet and MSDN (``veto_tpu/models/relation/legacy/bgnn.py``).

  * :class:`BGNNContext`: entities and predicates exchange gated messages
    (:class:`GatedMessageUnit`) for ``num_iter`` steps, each side fusing the
    mean of what it received into its state (:class:`MessageFusion`); the
    iterations share one set of units.
  * :class:`BGNNPredictor` (and :class:`MSDNPredictor`, the same network
    under its own name): the pairwise features, down to ``hidden_dim``,
    the context, the classifiers and the frequency bias.  With
    ``rel_aware`` the relation-confidence pre-classifier
    (``rel_proposal.RelAwareRelFeature``) scores every pair; its relness,
    recalibrated by the learnable gate ``clamp(a x - a b, 0, 1)``
    (``relness_alpha`` = a, trained; b = 0.03), weights the messages, and
    only the pairs scoring at least the ``mp_valid_pairs``-th best score
    pass messages (a threshold, ``>=``: tied scores let more through);
    its logits ride out for ``pre_rel_classify_loss``.
  * :class:`GPSNetContext` / :class:`GPSNetPredictor`: a scalar gate per
    pair from its subject, object and union features, normalised over each
    subject's outgoing pairs (a softmax shifted by the image's largest
    gate; a box with no pair has none), a two-way attention message into
    each box, and the final pair features from the updated boxes plus the
    initial ones.

Segment sums and gathers by pair index are products with the incidence
matrix (``context.segment_sum``, ``take_rows``): bit-equal across runs on
the card, the backward included.  Dense layers run in the model's dtype,
the classifiers, the relness and the GPSNet softmax in f32, as in the JAX
modules.  Nothing here has a kernel of its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Dense, LayerNorm
from ..freq_bias import FrequencyBias
from .context import PairwiseFeatureExtractor, segment_sum, take_rows
from .predictors import LegacyOutput, first_argmax_labels, pair_classes, valid_pairs

# LEARNABLE_SCALING_WEIGHT: the relness gate's start a and its offset b
SCALING_WEIGHT = (2.5, 0.03)


class GatedMessageUnit(nn.Module):
    """``pair * mean(sigmoid(w(relu(ln([unary; pair])))))``: the message of
    ``pair`` gated by a 64-wide filter of both."""

    def __init__(self, dim: int, filter_dim: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln = LayerNorm(2 * dim)
        self.w = Dense(2 * dim, filter_dim, dtype=dtype)

    def forward(self, unary: torch.Tensor, pair: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self.w(F.relu(self.ln(torch.cat([unary, pair], -1)))))
        return pair * gate.mean(-1, keepdim=True)


class MessageFusion(nn.Module):
    """``wih(relu(input)) + whh(relu(hidden))``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.wih = Dense(dim, dim, dtype=dtype)
        self.whh = Dense(dim, dim, dtype=dtype)

    def forward(self, inp: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
        return self.wih(F.relu(inp)) + self.whh(F.relu(hidden))


class BGNNContext(nn.Module):
    """Bipartite message passing over (B, N, h) entities and (B, P, h)
    predicates; padded boxes and pairs outside ``pair_mask`` keep their
    state, and ``relness`` (B, P) weights the predicates' messages (their
    mean over each entity is weighted by it)."""

    UNITS = ("gate_pred2sub", "gate_pred2obj", "gate_sub2pred", "gate_obj2pred")

    def __init__(self, hidden_dim: int = 512, num_iter: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_iter, self.dtype = num_iter, dtype
        for name in self.UNITS:  # one set, shared by the iterations
            self.add_module(f"{name}0", GatedMessageUnit(hidden_dim, dtype=dtype))
        for name in ("object_msg_fusion", "pred_msg_fusion"):
            self.add_module(f"{name}0", MessageFusion(hidden_dim, dtype))

    def forward(self, ent, rel, pair_idx, pair_mask, box_mask, relness=None):
        n = ent.shape[1]
        si, oi = pair_idx[..., 0], pair_idx[..., 1]
        pm = pair_mask[..., None].to(self.dtype)
        if relness is not None:
            pm = pm * relness[..., None].to(self.dtype)
        count = torch.clamp(segment_sum(pm, si, n), min=1.0), torch.clamp(
            segment_sum(pm, oi, n), min=1.0)
        u = {name: getattr(self, f"{name}0") for name in self.UNITS}
        for _ in range(self.num_iter):
            ent_s, ent_o = take_rows(ent, si), take_rows(ent, oi)
            msg_sub = u["gate_pred2sub"](ent_s, rel)
            msg_obj = u["gate_pred2obj"](ent_o, rel)
            agg = 0.5 * (segment_sum(msg_sub * pm, si, n) / count[0]
                         + segment_sum(msg_obj * pm, oi, n) / count[1])
            new_ent = ent + self.object_msg_fusion0(agg, ent)
            phrase = 0.5 * (u["gate_sub2pred"](rel, ent_s) + u["gate_obj2pred"](rel, ent_o))
            new_rel = rel + self.pred_msg_fusion0(phrase, rel)
            ent = torch.where(box_mask[..., None], new_ent, ent)
            rel = torch.where(pair_mask[..., None], new_rel, rel)
        return ent, rel


class _MessagePassingHead(nn.Module):
    """What the BGNN family's predictors share: the pairwise features, the
    classifiers (``obj_classifier`` outside PredCls) and the frequency
    bias."""

    def __init__(self, num_obj_classes, num_rel_classes, hidden_dim, pooling_dim,
                 in_channels, mode, dtype, head_dim):
        super().__init__()
        self.num_obj_classes, self.mode, self.dtype = num_obj_classes, mode, dtype
        self.pairwise_feature_extractor = PairwiseFeatureExtractor(
            num_obj_classes, hidden_dim=hidden_dim, pooling_dim=pooling_dim,
            in_channels=in_channels, mode=mode, dtype=dtype)
        if mode != "predcls":
            self.obj_classifier = Dense(head_dim, num_obj_classes, dtype=torch.float32)
        self.rel_classifier = Dense(head_dim, num_rel_classes, dtype=torch.float32)
        self.freq_bias = FrequencyBias(num_obj_classes, num_rel_classes)

    def features(self, roi_features, union_features, boxes, obj_labels,
                 predict_logits, pair_idx, image_sizes):
        # the JAX model passes these predictors no pred_labels: they embed
        # obj_labels twice
        return self.pairwise_feature_extractor(
            roi_features, union_features, boxes, obj_labels, predict_logits,
            obj_labels, pair_idx, image_sizes)

    def classify(self, ent, rel, obj_labels, pair_idx, relness_logits=None):
        if self.mode == "predcls":
            obj_dists = F.one_hot(obj_labels.long(), self.num_obj_classes).float()
        else:
            obj_dists = self.obj_classifier(ent)
        obj_preds = first_argmax_labels(obj_dists)
        rel_dists = (self.rel_classifier(rel)
                     + self.freq_bias(pair_classes(obj_preds, pair_idx)))
        return LegacyOutput(obj_dists, rel_dists, obj_preds,
                            relness_logits=relness_logits)


class BGNNPredictor(_MessagePassingHead):
    """BGNN (see the module docstring)."""

    def __init__(self, num_obj_classes: int = 151, num_rel_classes: int = 51,
                 hidden_dim: int = 512, pooling_dim: int = 4096,
                 in_channels: int = 4096, num_iter: int = 3, mode: str = "predcls",
                 rel_aware: bool = False, mp_valid_pairs: int = 200,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_obj_classes, num_rel_classes, hidden_dim, pooling_dim,
                         in_channels, mode, dtype, hidden_dim)
        self.rel_aware, self.mp_valid_pairs = rel_aware, mp_valid_pairs
        if rel_aware:
            # imported here: rel_proposal imports this package's helpers
            from ..rel_proposal import RelAwareRelFeature

            self.relation_conf_aware_models = RelAwareRelFeature(
                num_obj_classes, num_rel_classes, visual_dim=pooling_dim, dtype=dtype)
            self.relness_alpha = nn.Parameter(torch.full((1,), SCALING_WEIGHT[0]))
        self.obj_downdim_fc = Dense(pooling_dim, hidden_dim, dtype=dtype)
        self.rel_downdim_fc = Dense(pooling_dim, hidden_dim, dtype=dtype)
        self.context_layer = BGNNContext(hidden_dim, num_iter, dtype)

    def message_pairs(self, scores: torch.Tensor, pair_mask: torch.Tensor):
        """The pairs that pass messages: the valid ones scoring at least the
        ``mp_valid_pairs``-th best valid score of their image (every valid
        pair when there are fewer)."""
        masked = torch.where(pair_mask, scores, float("-inf"))
        k = min(self.mp_valid_pairs, pair_mask.shape[1])
        kth = torch.topk(masked, k, dim=-1).values[..., -1:]
        return pair_mask & (masked >= kth)

    def forward(self, boxes, box_mask, obj_labels, predict_logits, pair_idx,
                roi_features, union_features, image_sizes, boxes_per_cls=None,
                gumbel=None, forest=None, pair_mask=None,
                pred_labels=None) -> LegacyOutput:
        pair_mask = valid_pairs(pair_mask, pair_idx)
        aug_obj, rel_feats = self.features(roi_features, union_features, boxes,
                                           obj_labels, predict_logits, pair_idx,
                                           image_sizes)
        relness_logits = relness = None
        mp_mask = pair_mask
        if self.rel_aware:
            out = self.relation_conf_aware_models(rel_feats, boxes, predict_logits,
                                                  pair_idx, pair_mask, image_sizes)
            relness_logits = out.logits
            a, b = self.relness_alpha, SCALING_WEIGHT[1]
            scores = out.scores.detach().float()
            relness = torch.clamp(a * scores - a * b, 0.0, 1.0)
            mp_mask = self.message_pairs(scores, pair_mask)
        ent = F.relu(self.obj_downdim_fc(aug_obj))
        rel = F.relu(self.rel_downdim_fc(rel_feats))
        ent, rel = self.context_layer(ent, rel, pair_idx, mp_mask, box_mask, relness)
        return self.classify(ent, rel, obj_labels, pair_idx, relness_logits)


class MSDNPredictor(BGNNPredictor):
    """MSDN: the JAX package's is BGNN's gated bipartite message passing
    under its own name (the reference's MSDN context has the same units,
    without the relation-confidence machinery unless ``rel_aware``)."""


class GPSNetContext(nn.Module):
    """GPSNet's message passing over (B, N, pooling) boxes for ``num_iter``
    steps (see the module docstring); returns the boxes and the (B, P,
    pooling) pair features."""

    def __init__(self, pooling_dim: int = 4096, hidden_dim: int = 512,
                 num_iter: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        d, h = pooling_dim, hidden_dim
        self.num_iter, self.hidden_dim, self.dtype = num_iter, h, dtype
        self.gate_ws = Dense(d, h, dtype=dtype)
        self.gate_wo = Dense(d, h, dtype=dtype)
        self.gate_wu = Dense(d, h, dtype=dtype)
        self.gate_w = Dense(h, 32, dtype=dtype)
        self.message_fc = Dense(d, d // 2, dtype=dtype)
        self.msg_out_fc1 = Dense(d, d // 4, dtype=dtype)
        self.msg_out_ln = LayerNorm(d // 4)
        self.msg_out_fc2 = Dense(d // 4, h, dtype=dtype)
        self.obj2obj_msg_fuse = Dense(h, pooling_dim, dtype=dtype)
        for t in range(num_iter):
            self.add_module(f"inst_down{t}", Dense(d, h, dtype=dtype))
        self.pairwise_obj_feat_updim_fc = Dense(d, 2 * h, dtype=dtype)
        self.pairwise_rel_feat_finalize_fc = Dense(2 * h, pooling_dim, dtype=dtype)

    def attention(self, gate: torch.Tensor, si: torch.Tensor, pair_mask: torch.Tensor,
                  n: int) -> torch.Tensor:
        """(B, P) f32 weights: ``exp(g - max g)`` over the image's valid
        pairs, divided by its subject's sum (+ 1e-6); 0 on padded pairs."""
        g = torch.where(pair_mask, gate.float(), -1e9)
        e = torch.exp(g - g.amax(-1, keepdim=True)) * pair_mask.float()
        denom = segment_sum(e, si, n)
        return e / (take_rows(denom[..., None], si)[..., 0] + 1e-6)

    def forward(self, inst, rel_feats, pair_idx, pair_mask, box_mask):
        cdt = self.dtype
        n = inst.shape[1]
        si, oi = pair_idx[..., 0], pair_idx[..., 1]
        wu = F.relu(self.gate_wu(rel_feats))
        for t in range(self.num_iter):
            prod = F.relu(self.gate_ws(take_rows(inst, si))) * F.relu(
                self.gate_wo(take_rows(inst, oi)))
            gate = F.relu(self.gate_w(prod * wu)).mean(-1)
            atten = self.attention(gate, si, pair_mask, n)[..., None].to(cdt)
            src = self.message_fc(inst)
            fwd = segment_sum(take_rows(src, oi) * atten, si, n)
            bwd = segment_sum(take_rows(src, si) * atten, oi, n)
            msg = self.msg_out_fc1(torch.cat([fwd, bwd], -1))
            msg = F.relu(self.msg_out_fc2(F.relu(self.msg_out_ln(msg))))
            fused = msg + F.relu(getattr(self, f"inst_down{t}")(inst))
            inst = torch.where(box_mask[..., None], F.relu(self.obj2obj_msg_fuse(fused)),
                               inst)
        h = self.hidden_dim
        updim = F.relu(self.pairwise_obj_feat_updim_fc(inst))
        paired = torch.cat([take_rows(updim[..., :h], si), take_rows(updim[..., h:], oi)],
                           -1)
        return inst, F.relu(self.pairwise_rel_feat_finalize_fc(paired)) + rel_feats


class GPSNetPredictor(_MessagePassingHead):
    """GPSNet: the pairwise features, :class:`GPSNetContext` over the
    augmented boxes, the classifiers on its pooling-wide outputs and the
    frequency bias."""

    def __init__(self, num_obj_classes: int = 151, num_rel_classes: int = 51,
                 hidden_dim: int = 512, pooling_dim: int = 4096,
                 in_channels: int = 4096, num_iter: int = 2, mode: str = "predcls",
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_obj_classes, num_rel_classes, hidden_dim, pooling_dim,
                         in_channels, mode, dtype, pooling_dim)
        self.context_layer = GPSNetContext(pooling_dim, hidden_dim, num_iter, dtype)

    def forward(self, boxes, box_mask, obj_labels, predict_logits, pair_idx,
                roi_features, union_features, image_sizes, boxes_per_cls=None,
                gumbel=None, forest=None, pair_mask=None,
                pred_labels=None) -> LegacyOutput:
        aug_obj, rel_feats = self.features(roi_features, union_features, boxes,
                                           obj_labels, predict_logits, pair_idx,
                                           image_sizes)
        ent, rel = self.context_layer(aug_obj, rel_feats, pair_idx,
                                      valid_pairs(pair_mask, pair_idx), box_mask)
        return self.classify(ent, rel, obj_labels, pair_idx)
