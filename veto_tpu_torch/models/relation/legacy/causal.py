"""Causal analysis (``veto_tpu/models/relation/legacy/causal.py``): the
TDE predictor of "Unbiased Scene Graph Generation from Biased Training".

A context (the Motifs biLSTMs, or VTransE's linear one) feeds three logit
branches: the context branch (each pair's joined head and tail
representation through ``post_cat``, gated by a net of its 32-d pair
geometry), the visual branch (the union features) and the frequency bias;
``sum`` adds them, ``gate`` multiplies the context logits by the sigmoid of
the other two plus ``ctx_gate_fc``'s.

With an ``effect_type`` other than ``none`` the predictor keeps moving
averages of its "untreated" inputs, updated in training without a
gradient: the decoder's input inside the context (``untreated_dcd_feat``,
or VTransE's ``untreated_obj_feat`` / ``untreated_edg_feat``), the pair
geometry (``untreated_spt``), the gated context (``avg_post_ctx``) and the
union features (``untreated_feat``).  They are buffers, so they ride in the
``state_dict`` and in checkpoints.  In evaluation the predictor runs the
context a second time on the averages (the counterfactual), and returns a
difference of logits, the frequency branch taken as the soft lookup of the
pair's class distributions (``FrequencyBias.index_with_probability``):

  TDE: logits(ctx, vis, frq) - logits(ctx̄, vis, frq)
  NIE: logits(ctx̄, vis, frq) - logits(ctx̄, vis, frq̄)
  TE:  logits(ctx, vis, frq) - logits(ctx̄, vis, frq̄)

Training (and ``effect_type="none"``) classifies with the hard lookup of
the pair's labels.  The pair gathers are products with the incidence matrix
(``context.take_rows``), so the backward adds into no address from many
threads.  No kernel of its own: the JAX module runs on XLA outside Pallas.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ....ops.box_ops import encode_box_info
from ...layers import BatchNorm1d, Dense
from ..freq_bias import FrequencyBias
from .context import box_pair_info, soft_embed, take_rows
from .predictors import (
    LegacyOutput, LSTMContext, first_argmax_labels, moving_average, pair_classes,
    valid_pairs,
)

EFFECT_TYPES = ("none", "TDE", "NIE", "TE")
FUSION_TYPES = ("sum", "gate")
CONTEXT_LAYERS = ("motifs", "vtranse")
# the untreated moving averages' buffer names (the JAX step's batch_stats)
UNTREATED = ("untreated_dcd_feat", "untreated_obj_feat", "untreated_edg_feat",
             "untreated_spt", "avg_post_ctx", "untreated_feat")


class VTransEContext(nn.Module):
    """VTransE's context: (obj_dists, obj_preds, edge_ctx).  A linear object
    classifier ``pred_layer`` over [roi, class embedding, 9 → 32 → BN → 128
    geometry] (its labels the argmax over every class, in PredCls too), and
    one ``fc_layer`` with ReLU over [roi, geometry, embedding of the labels].
    With ``effect_analysis`` the buffers ``untreated_obj_feat`` and
    ``untreated_edg_feat`` average the classifier's and the edge layer's
    inputs over the valid boxes; ``ctx_average=True`` in evaluation feeds
    them in place of the real inputs (the edge layer then embeds the
    classifier's softmax)."""

    def __init__(self, num_obj_classes: int = 151, embed_dim: int = 200,
                 hidden_dim: int = 512, in_dim: int = 4096, mode: str = "predcls",
                 effect_analysis: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mode, self.dtype = mode, dtype
        self.effect_analysis = effect_analysis
        self.obj_embed1 = nn.Embedding(num_obj_classes, embed_dim)
        self.obj_embed2 = nn.Embedding(num_obj_classes, embed_dim)
        self.pos_fc1 = Dense(9, 32, dtype=dtype)
        self.pos_bn = BatchNorm1d(32, momentum=0.999)
        self.pos_fc2 = Dense(32, 128, dtype=dtype)
        d_obj, d_edg = in_dim + embed_dim + 128, in_dim + 128
        if effect_analysis:
            self.register_buffer("untreated_obj_feat", torch.zeros(d_obj))
            self.register_buffer("untreated_edg_feat", torch.zeros(d_edg))
        self.pred_layer = Dense(d_obj, num_obj_classes, dtype=torch.float32)
        self.fc_layer = Dense(d_edg + embed_dim, hidden_dim, dtype=dtype)

    def forward(self, roi_features, boxes, box_mask, obj_labels, predict_logits,
                image_sizes, boxes_per_cls=None, ctx_average: bool = False):
        cdt = self.dtype
        if self.mode == "predcls":
            obj_embed = self.obj_embed1(obj_labels.long()).to(cdt)
        else:
            obj_embed = soft_embed(self.obj_embed1, predict_logits, cdt)
        pos = self.pos_bn(self.pos_fc1(encode_box_info(boxes, image_sizes).to(cdt)))
        pos = F.relu(self.pos_fc2(pos))
        x = roi_features.to(cdt)
        obj_pre = torch.cat([x, obj_embed, pos], -1)
        average = self.effect_analysis and ctx_average and not self.training
        if self.effect_analysis and self.training:
            moving_average(self.untreated_obj_feat, obj_pre, box_mask)
            moving_average(self.untreated_edg_feat, torch.cat([x, pos], -1), box_mask)
        if average:
            obj_pre = self.untreated_obj_feat.to(cdt).expand_as(obj_pre)
        obj_dists = self.pred_layer(obj_pre)
        obj_preds = first_argmax_labels(obj_dists)
        if average:
            e2 = torch.matmul(torch.softmax(obj_dists, -1).to(cdt),
                              self.obj_embed2.weight.to(cdt))
            edg = self.untreated_edg_feat.to(cdt)
            edge_pre = torch.cat([edg.expand(obj_pre.shape[:-1] + edg.shape), e2], -1)
        else:
            edge_pre = torch.cat([x, pos, self.obj_embed2(obj_preds.long()).to(cdt)], -1)
        return obj_dists, obj_preds, F.relu(self.fc_layer(edge_pre))


class CausalPredictor(nn.Module):
    """The causal-analysis relation head (see the module docstring);
    ``context_layer`` is ``motifs`` (the Motifs :class:`LSTMContext`) or
    ``vtranse`` (:class:`VTransEContext`), a module argument only, as in the
    JAX package (no config key reaches it).  The spatial gate's two Dense
    layers keep flax's names for the JAX module's unnamed ``nn.Sequential``
    (``Dense_0``, ``Dense_1``), so the weight bridge maps them as it maps
    every other leaf.  ``ctx_gate_fc`` exists with the ``gate`` fusion
    only, the untreated buffers with an effect only, as the JAX tree
    has them.  The JAX module's ``spatial_for_vision``, on in every
    configuration, is fixed on."""

    def __init__(self, num_obj_classes: int = 151, num_rel_classes: int = 51,
                 embed_dim: int = 200, hidden_dim: int = 512, pooling_dim: int = 4096,
                 in_channels: int = 4096, mode: str = "predcls",
                 context_layer: str = "motifs", fusion_type: str = "sum",
                 effect_type: str = "none", dtype: torch.dtype = torch.float32):
        super().__init__()
        for what, value, allowed in (("context_layer", context_layer, CONTEXT_LAYERS),
                                     ("fusion_type", fusion_type, FUSION_TYPES),
                                     ("effect_type", effect_type, EFFECT_TYPES)):
            if value not in allowed:
                raise ValueError(f"CausalPredictor {what} {value!r}: expected one "
                                 f"of {allowed}")
        if in_channels != pooling_dim:
            raise ValueError(f"in_channels {in_channels} != pooling_dim "
                             f"{pooling_dim}: the union features come pooling_dim wide")
        self.hidden_dim, self.dtype = hidden_dim, dtype
        self.fusion_type, self.effect_type = fusion_type, effect_type
        ctx = VTransEContext if context_layer == "vtranse" else LSTMContext
        self.context_layer = ctx(num_obj_classes, embed_dim, hidden_dim, in_channels,
                                 mode=mode, effect_analysis=effect_type != "none",
                                 dtype=dtype)
        self.post_emb = Dense(hidden_dim, hidden_dim * 2, dtype=dtype)
        self.post_cat = Dense(hidden_dim * 2, pooling_dim, dtype=dtype)
        self.Dense_0 = Dense(32, hidden_dim, dtype=dtype)
        self.Dense_1 = Dense(hidden_dim, pooling_dim, dtype=dtype)
        if effect_type != "none":
            self.register_buffer("untreated_spt", torch.zeros(32))
            self.register_buffer("avg_post_ctx", torch.zeros(pooling_dim))
            self.register_buffer("untreated_feat", torch.zeros(pooling_dim))
        self.vis_compress = Dense(pooling_dim, num_rel_classes, dtype=torch.float32)
        self.ctx_compress = Dense(pooling_dim, num_rel_classes, dtype=torch.float32)
        if fusion_type == "gate":
            self.ctx_gate_fc = Dense(pooling_dim, num_rel_classes, dtype=torch.float32)
        self.freq_bias = FrequencyBias(num_obj_classes, num_rel_classes)

    def _spatial(self, geo: torch.Tensor) -> torch.Tensor:
        return F.relu(self.Dense_1(F.relu(self.Dense_0(geo))))

    def _pair_reps(self, edge_ctx, obj_dists, obj_preds, pair_idx):
        """(post_ctx (B, P, pooling), pair_prob (B, P, C, 2), pair_pred (B, P, 2))."""
        si, oi = pair_idx[..., 0], pair_idx[..., 1]
        h = self.hidden_dim
        rep = self.post_emb(edge_ctx)
        prod = torch.cat([take_rows(rep[..., :h], si), take_rows(rep[..., h:], oi)], -1)
        post_ctx = F.relu(self.post_cat(prod))
        prob = torch.softmax(obj_dists.float(), -1)
        pair_prob = torch.stack([take_rows(prob, si), take_rows(prob, oi)], -1)
        return post_ctx, pair_prob, pair_classes(obj_preds, pair_idx)

    def _logits(self, vis_rep, ctx_rep, frq_rep, soft: bool) -> torch.Tensor:
        frq = (self.freq_bias.index_with_probability(frq_rep) if soft
               else self.freq_bias(frq_rep))
        vis, ctx = self.vis_compress(vis_rep), self.ctx_compress(ctx_rep)
        if self.fusion_type == "gate":
            return ctx * torch.sigmoid(vis + frq + self.ctx_gate_fc(ctx_rep))
        return vis + ctx + frq

    def forward(self, boxes, box_mask, obj_labels, predict_logits, pair_idx,
                roi_features, union_features, image_sizes, boxes_per_cls=None,
                gumbel=None, forest=None, pair_mask=None,
                pred_labels=None) -> LegacyOutput:
        cdt = self.dtype
        ctx_args = (roi_features, boxes, box_mask, obj_labels, predict_logits,
                    image_sizes, boxes_per_cls)
        obj_dists, obj_preds, edge_ctx = self.context_layer(*ctx_args)
        post_ctx, pair_prob, pair_pred = self._pair_reps(edge_ctx, obj_dists,
                                                         obj_preds, pair_idx)
        pair_geo = box_pair_info(boxes, image_sizes, pair_idx).to(cdt)
        uf = union_features.to(cdt)
        post_ctx = post_ctx * self._spatial(pair_geo)
        if self.effect_type != "none" and self.training:
            pm = valid_pairs(pair_mask, pair_idx)
            moving_average(self.untreated_spt, pair_geo, pm)
            moving_average(self.avg_post_ctx, post_ctx, pm)
            moving_average(self.untreated_feat, uf, pm)
        if self.effect_type == "none" or self.training:
            rel_dists = self._logits(uf, post_ctx, pair_pred, False)
            return LegacyOutput(obj_dists, rel_dists, obj_preds)

        # the counterfactual context on the untreated averages
        avg_dists, avg_preds, avg_edge = self.context_layer(*ctx_args, ctx_average=True)
        avg_ctx, avg_pair_prob, _ = self._pair_reps(avg_edge, avg_dists, avg_preds,
                                                    pair_idx)
        avg_ctx = avg_ctx * self._spatial(self.untreated_spt.to(cdt).expand_as(pair_geo))
        avg_ctx, avg_frq = avg_ctx.detach(), avg_pair_prob.detach()
        if self.effect_type == "TDE":
            rel_dists = (self._logits(uf, post_ctx, pair_prob, True)
                         - self._logits(uf, avg_ctx, pair_prob, True))
        elif self.effect_type == "NIE":
            rel_dists = (self._logits(uf, avg_ctx, pair_prob, True)
                         - self._logits(uf, avg_ctx, avg_frq, True))
        else:  # TE
            rel_dists = (self._logits(uf, post_ctx, pair_prob, True)
                         - self._logits(uf, avg_ctx, avg_frq, True))
        return LegacyOutput(obj_dists, rel_dists, obj_preds)
