"""Legacy relation predictors (``veto_tpu/models/relation/legacy/
predictors.py``): Transformer, TransLike and Motifs, with their MEET heads,
and IMP.

Each takes the (B, N) boxes with their 4096-d box-MLP features and the
(B, P) pairs with their union features, builds a context over the boxes
(attention for Transformer and TransLike, biLSTMs for Motifs), splits it
into a head and a tail representation per box, joins each pair's head and
tail (``post_cat``), gates it by the pair's union feature and classifies
the predicate, plus the frequency bias of the pair's classes where the
predictor has one.  With ``meet_group_sizes`` the classifier gives way to
MEET's per-(expert, group) heads (:class:`MeetRelHeads`), whose logits
the engine's MEET routing, losses and post-processing take as they take
``VETOPredictor_MEET``'s.

IMP (:class:`IMPPredictor`) passes messages instead: GRU cells over the
boxes and the pairs, each box taking the gated sum of its pairs' states,
each pair its two boxes' (``context.segment_sum`` / ``take_rows``).

Every predictor returns a :class:`LegacyOutput`; its ``rel_logits``
property is the relation output the engine reads (``rel_dists``, or the
group logits with MEET).  All share one call signature: VCTree's decoder
noise ``gumbel`` and its ``forest``, the message-passing predictors'
``pair_mask`` (the valid pairs; all when None) and IMP's ``pred_labels``
(the labels it embeds beside ``obj_labels``; ``obj_labels`` when None)
are ignored by the others.
The dense layers run in the model's dtype, the classifiers in f32, as in
the JAX modules.  Nothing here has a kernel of its own: the JAX package
computes it with XLA outside Pallas.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ....ops.box_ops import encode_box_info
from ....ops.nms import first_argmax, obj_prediction_nms
from ...detector.attribute_head import attribute_targets
from ...layers import BatchNorm1d, Dense
from ..freq_bias import FrequencyBias
from .context import (
    PairwiseFeatureExtractor, SHAContext, TransformerContext, segment_sum,
    soft_embed, take_rows,
)
from .lstm import HighwayDecoderLSTM, MaskedBiLSTM, centerx_perm, gather_rows


class LegacyOutput(NamedTuple):
    obj_dists: torch.Tensor            # (B, N, num_obj) refined object logits
    rel_dists: Optional[torch.Tensor]  # (B, P, num_rel); None with MEET
    obj_preds: torch.Tensor            # (B, N) refined object labels
    # (B, N, N) pair-relatedness logits for VCTree's binary loss
    binary_preds: Optional[torch.Tensor] = None
    # MEET: [expert][group] (B, P, gs + 2) f32 logits
    group_logits: Optional[Tuple[Tuple[torch.Tensor, ...], ...]] = None
    # VCTree: the forest its contexts ran on (a ``vctree.BinaryForest``)
    forest: Optional["BinaryForest"] = None
    # BGNN with rel_aware: (B, P, C) f32 pre-classifier logits, for
    # ``pre_rel_classify_loss`` and the eval's relness
    relness_logits: Optional[torch.Tensor] = None
    # Motifs with ``attribute_on``: (B, N, num_att) f32 attribute logits (in
    # PredCls the raw GT multi-hot)
    att_dists: Optional[torch.Tensor] = None

    @property
    def rel_logits(self):
        """The relation output the engine reads: ``rel_dists``, or with MEET
        the group logits."""
        return self.group_logits if self.rel_dists is None else self.rel_dists


class MeetRelHeads(nn.Module):
    """Per-(expert, group) f32 classifiers ``rel_out_e{e}_g{k}`` of ``gs + 2``
    classes (background, the group's predicates, out-of-distribution) on
    the pair representation; with ``ctx_features`` a second set
    ``ctx_out_e{e}_g{k}`` on a second input of that width, added
    (TransLike's visual + context heads).  All heads of a set are one
    product over their concatenated columns."""

    def __init__(self, in_features: int, group_sizes: Sequence[int],
                 experts: int = 1, ctx_features: Optional[int] = None):
        super().__init__()
        self.group_sizes, self.experts = tuple(group_sizes), experts
        for e in range(experts):
            for k, gs in enumerate(self.group_sizes):
                self.add_module(f"rel_out_e{e}_g{k}",
                                Dense(in_features, gs + 2, dtype=torch.float32))
                if ctx_features is not None:
                    self.add_module(f"ctx_out_e{e}_g{k}",
                                    Dense(ctx_features, gs + 2, dtype=torch.float32))

    def _set(self, name: str, x: torch.Tensor):
        heads = [getattr(self, f"{name}_e{e}_g{k}") for e in range(self.experts)
                 for k in range(len(self.group_sizes))]
        out = F.linear(x.float(), torch.cat([h.weight for h in heads]),
                       torch.cat([h.bias for h in heads]))
        return out.split([h.out_features for h in heads], dim=-1)

    def forward(self, feat: torch.Tensor, ctx_feat: Optional[torch.Tensor] = None
                ) -> Tuple[Tuple[torch.Tensor, ...], ...]:
        cols = self._set("rel_out", feat)
        if ctx_feat is not None:
            cols = [a + b for a, b in zip(cols, self._set("ctx_out", ctx_feat))]
        g = len(self.group_sizes)
        return tuple(tuple(cols[e * g: (e + 1) * g]) for e in range(self.experts))


def pair_classes(obj_preds: torch.Tensor, pair_idx: torch.Tensor) -> torch.Tensor:
    """(B, P, 2) subject and object classes of each pair."""
    return torch.stack([torch.gather(obj_preds, 1, pair_idx[..., 0].long()),
                        torch.gather(obj_preds, 1, pair_idx[..., 1].long())], -1)


class _PairHead(nn.Module):
    """The head / tail split of the edge context (``post_emb``) and the
    pair representation ``post_cat`` of each pair's head and tail.  The
    union features arrive ``pooling_dim`` wide (``SGGModel`` builds them
    so), so the JAX modules' ``up_dim`` projection is never built."""

    def __init__(self, hidden_dim, pooling_dim, dtype, relu_emb=False):
        super().__init__()
        self.hidden_dim, self.relu_emb = hidden_dim, relu_emb
        self.post_emb = Dense(hidden_dim, hidden_dim * 2, dtype=dtype)
        self.post_cat = Dense(hidden_dim * 2, pooling_dim, dtype=dtype)

    def prod(self, edge_ctx: torch.Tensor, pair_idx: torch.Tensor) -> torch.Tensor:
        """(B, P, 2 hidden) joined head and tail representations (gathered as
        products with the incidence matrix: no backward adds into one
        address from many threads, so two runs on the card are bit-equal)."""
        rep = self.post_emb(edge_ctx)
        if self.relu_emb:
            rep = F.relu(rep)
        h = self.hidden_dim
        return torch.cat([take_rows(rep[..., :h], pair_idx[..., 0]),
                          take_rows(rep[..., h:], pair_idx[..., 1])], -1)


class TransformerPredictor(_PairHead):
    """Self-attention context with union-gated visual and context heads
    (``rel_compress`` + ``ctx_compress``, and the frequency bias with
    ``use_bias``); TransLike's when ``context_type`` is ``"sha"``."""

    context_type = "self_attention"

    def __init__(self, num_obj_classes: int = 151, num_rel_classes: int = 51,
                 embed_dim: int = 200, hidden_dim: int = 512, pooling_dim: int = 4096,
                 in_channels: int = 4096, obj_layers: int = 4, edge_layers: int = 2,
                 heads: int = 8, inner_dim: int = 2048, k_dim: int = 64,
                 v_dim: int = 64, mode: str = "predcls", use_bias: bool = False,
                 meet_group_sizes: Optional[Sequence[int]] = None,
                 meet_experts: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__(hidden_dim, pooling_dim, dtype)
        self.dtype = dtype
        ctx = SHAContext if self.context_type == "sha" else TransformerContext
        self.context_layer = ctx(num_obj_classes, embed_dim, hidden_dim, in_channels,
                                 obj_layers, edge_layers, heads, inner_dim, k_dim,
                                 v_dim, mode, dtype=dtype)
        self.meet = meet_group_sizes is not None
        if self.meet:
            self.meet_heads = MeetRelHeads(pooling_dim, meet_group_sizes, meet_experts,
                                           ctx_features=hidden_dim * 2)
        else:
            self.rel_compress = Dense(pooling_dim, num_rel_classes, dtype=torch.float32)
            self.ctx_compress = Dense(hidden_dim * 2, num_rel_classes,
                                      dtype=torch.float32)
            if use_bias:
                self.freq_bias = FrequencyBias(num_obj_classes, num_rel_classes)

    def forward(self, boxes, box_mask, obj_labels, predict_logits, pair_idx,
                roi_features, union_features, image_sizes, boxes_per_cls=None,
                gumbel=None, forest=None, pair_mask=None,
                pred_labels=None) -> LegacyOutput:
        obj_dists, obj_preds, edge_ctx = self.context_layer(
            roi_features, boxes, box_mask, obj_labels, predict_logits, image_sizes,
            boxes_per_cls)
        prod_rep = self.prod(edge_ctx, pair_idx)
        visual_rep = self.post_cat(prod_rep) * union_features.to(self.dtype)
        if self.meet:
            return LegacyOutput(obj_dists, None, obj_preds,
                                group_logits=self.meet_heads(visual_rep, prod_rep))
        rel_dists = self.rel_compress(visual_rep) + self.ctx_compress(prod_rep)
        if hasattr(self, "freq_bias"):
            rel_dists = rel_dists + self.freq_bias(pair_classes(obj_preds, pair_idx))
        return LegacyOutput(obj_dists, rel_dists, obj_preds)


class TransLikePredictor(TransformerPredictor):
    """The Transformer-style predictor over the SHA hybrid-attention context
    (the reference ships only its MEET variant; without MEET this is the
    plain dual-compress head)."""

    context_type = "sha"


class LSTMContext(nn.Module):
    """The Motifs biLSTM object and edge context: (obj_dists, obj_preds,
    edge_ctx (B, N, hidden)).  In PredCls the GT labels and their one-hot;
    in SGCls and SGDet the decoder's refined labels (teacher-forced at
    train), in SGDet evaluation relabelled by the late NMS (overwrite, the
    background column at 0).

    ``effect_analysis`` (Causal-TDE) keeps the buffer
    ``untreated_dcd_feat``, the moving average of the decoder's input over
    the valid boxes (``AVERAGE_RATIO`` of each training batch's mean, taken
    without a gradient; in PredCls, which runs no decoder, it stays at 0);
    ``ctx_average=True`` in evaluation feeds that average to the decoder in
    place of the real input (the counterfactual forward)."""

    def __init__(self, num_obj_classes: int = 151, embed_dim: int = 200,
                 hidden_dim: int = 512, in_dim: int = 4096, obj_layers: int = 1,
                 edge_layers: int = 1, mode: str = "predcls",
                 later_nms_thres: float = 0.3, effect_analysis: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_obj_classes, self.mode, self.dtype = num_obj_classes, mode, dtype
        self.later_nms_thres = later_nms_thres
        self.effect_analysis = effect_analysis
        self.obj_embed1 = nn.Embedding(num_obj_classes, embed_dim)
        self.obj_embed2 = nn.Embedding(num_obj_classes, embed_dim)
        self.pos_fc1 = Dense(9, 32, dtype=dtype)
        self.pos_bn = BatchNorm1d(32, momentum=0.999)
        self.pos_fc2 = Dense(32, 128, dtype=dtype)
        pre = in_dim + embed_dim + 128
        self.obj_ctx_rnn = MaskedBiLSTM(pre, hidden_dim, obj_layers, dtype)
        self.lin_obj_h = Dense(2 * hidden_dim, hidden_dim, dtype=dtype)
        if mode != "predcls":
            self.decoder_rnn = HighwayDecoderLSTM(num_obj_classes, pre + hidden_dim,
                                                  embed_dim, hidden_dim, dtype=dtype)
        if effect_analysis:
            self.register_buffer("untreated_dcd_feat", torch.zeros(pre + hidden_dim))
        self.edge_ctx_rnn = MaskedBiLSTM(embed_dim + in_dim + hidden_dim, hidden_dim,
                                         edge_layers, dtype)
        self.lin_edge_h = Dense(2 * hidden_dim, hidden_dim, dtype=dtype)

    def forward(self, roi_features, boxes, box_mask, obj_labels, predict_logits,
                image_sizes, boxes_per_cls=None, ctx_average: bool = False):
        cdt = self.dtype
        if self.mode == "predcls":
            obj_embed = self.obj_embed1(obj_labels.long()).to(cdt)
        else:
            obj_embed = soft_embed(self.obj_embed1, predict_logits, cdt)
        g = self.pos_bn(self.pos_fc1(encode_box_info(boxes, image_sizes).to(cdt)))
        g = F.relu(self.pos_fc2(g))
        x = roi_features.to(cdt)
        obj_pre = torch.cat([x, obj_embed, g], -1)

        perm, inv = centerx_perm(boxes, box_mask)
        sorted_pre = gather_rows(obj_pre, perm)
        sorted_mask = torch.gather(box_mask, 1, perm)
        enc = self.lin_obj_h(self.obj_ctx_rnn(sorted_pre, sorted_mask))

        if self.mode == "predcls":
            obj_preds = obj_labels
            obj_dists = F.one_hot(obj_labels.long(), self.num_obj_classes).float()
        else:
            dec_inp = torch.cat([sorted_pre, enc], -1)
            if self.effect_analysis:
                if self.training:
                    moving_average(self.untreated_dcd_feat, dec_inp, sorted_mask)
                elif ctx_average:
                    dec_inp = self.untreated_dcd_feat.to(dec_inp.dtype).expand_as(dec_inp)
            sorted_labels = (torch.gather(obj_labels, 1, perm) if self.training
                             else None)
            logits, refined = self.decoder_rnn(dec_inp, sorted_mask, sorted_labels)
            obj_dists = gather_rows(logits, inv)
            obj_preds = torch.gather(refined, 1, inv)
            if self.mode == "sgdet" and not self.training:
                b, n, c = obj_dists.shape
                bpc = boxes_per_cls if boxes_per_cls is not None else \
                    boxes[:, :, None, :].expand(b, n, c, 4)
                obj_preds = obj_prediction_nms(bpc, obj_dists, self.later_nms_thres,
                                               valid_mask=box_mask, overwrite=True,
                                               bg_init=0.0)

        obj_ctx = gather_rows(enc, inv)
        edge_pre = torch.cat([self.obj_embed2(obj_preds.long()).to(cdt), x, obj_ctx], -1)
        edge = self.edge_ctx_rnn(gather_rows(edge_pre, perm), sorted_mask)
        return obj_dists, obj_preds, gather_rows(self.lin_edge_h(edge), inv)


# the share of each training batch's mean in a Causal-TDE moving average
AVERAGE_RATIO = 0.0005


@torch.no_grad()
def moving_average(holder: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                   ratio: float = AVERAGE_RATIO) -> None:
    """``holder`` ← ``holder * (1 - ratio) + ratio * mean``, the f32 mean of
    ``x`` (..., F) over the rows where ``mask`` (...) is set (at least one
    row counted), without a gradient: the Causal-TDE "untreated" buffers."""
    m = mask.reshape(-1).float()
    mean = (x.reshape(-1, x.shape[-1]).float() * m[:, None]).sum(0) / \
        torch.clamp(m.sum(), min=1.0)
    holder.copy_(holder * (1 - ratio) + ratio * mean)


def norm_sigmoid(logits: torch.Tensor) -> torch.Tensor:
    """The reference's ``normalize_sigmoid_logits``: the f32 sigmoid over the
    last axis divided by its sum (+ 1e-12)."""
    p = torch.sigmoid(logits.float())
    return p / (p.sum(-1, keepdim=True) + 1e-12)


class AttributeLSTMContext(nn.Module):
    """The attribute-aware Motifs context (``attribute_on``): (obj_dists,
    obj_preds, att_dists, edge_ctx).  Beside :class:`LSTMContext`'s, the
    object stream embeds the attributes (in PredCls the normalized GT
    multi-hot through ``att_embed1``, else the normalized sigmoid of the
    detector's attribute logits), the decoder is the attribute variant
    (:class:`HighwayDecoderLSTM` with ``num_att_classes``), the edge stream
    adds the normalized sigmoid of ``att_dists`` through ``att_embed2``.
    In PredCls ``obj_dists`` is the ±1000 one-hot and ``att_dists`` the raw
    GT multi-hot, whose sigmoid the edge stream then takes (the reference's
    quirk, kept).  The position net has no BatchNorm, and no late NMS runs
    in SGDet, as in the JAX module."""

    def __init__(self, num_obj_classes: int = 151, num_att_classes: int = 201,
                 embed_dim: int = 200, hidden_dim: int = 512, in_dim: int = 4096,
                 obj_layers: int = 1, edge_layers: int = 1, mode: str = "predcls",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_obj_classes, self.num_att_classes = num_obj_classes, num_att_classes
        self.mode, self.dtype = mode, dtype
        self.obj_embed1 = nn.Embedding(num_obj_classes, embed_dim)
        self.obj_embed2 = nn.Embedding(num_obj_classes, embed_dim)
        self.att_embed1 = nn.Embedding(num_att_classes, embed_dim)
        self.att_embed2 = nn.Embedding(num_att_classes, embed_dim)
        self.pos_fc1 = Dense(9, 32, dtype=dtype)
        self.pos_fc2 = Dense(32, 128, dtype=dtype)
        pre = in_dim + 2 * embed_dim + 128
        self.obj_ctx_rnn = MaskedBiLSTM(pre, hidden_dim, obj_layers, dtype)
        self.lin_obj_h = Dense(2 * hidden_dim, hidden_dim, dtype=dtype)
        if mode != "predcls":
            self.decoder_rnn = HighwayDecoderLSTM(num_obj_classes, pre + hidden_dim,
                                                  embed_dim, hidden_dim,
                                                  num_att_classes, dtype=dtype)
        self.edge_ctx_rnn = MaskedBiLSTM(2 * embed_dim + in_dim + hidden_dim,
                                         hidden_dim, edge_layers, dtype)
        self.lin_edge_h = Dense(2 * hidden_dim, hidden_dim, dtype=dtype)

    def forward(self, roi_features, boxes, box_mask, obj_labels, attributes,
                predict_logits, attribute_logits, image_sizes):
        """``attributes`` (B, N, 10) padded GT attribute ids, ``attribute_logits``
        (B, N, A) the attribute head's (read outside PredCls)."""
        cdt = self.dtype
        gt_multihot = attribute_targets(attributes, self.num_att_classes)
        if self.mode == "predcls":
            obj_embed = self.obj_embed1(obj_labels.long()).to(cdt)
            gt_norm = gt_multihot / (gt_multihot.sum(-1, keepdim=True) + 1e-12)
            att_embed = torch.matmul(gt_norm.to(cdt), self.att_embed1.weight.to(cdt))
        else:
            obj_embed = soft_embed(self.obj_embed1, predict_logits, cdt)
            att_embed = torch.matmul(norm_sigmoid(attribute_logits).to(cdt),
                                     self.att_embed1.weight.to(cdt))
        g = F.relu(self.pos_fc1(encode_box_info(boxes, image_sizes).to(cdt)))
        g = F.relu(self.pos_fc2(g))
        x = roi_features.to(cdt)
        obj_pre = torch.cat([x, obj_embed, att_embed, g], -1)

        perm, inv = centerx_perm(boxes, box_mask)
        sorted_pre = gather_rows(obj_pre, perm)
        sorted_mask = torch.gather(box_mask, 1, perm)
        enc = self.lin_obj_h(self.obj_ctx_rnn(sorted_pre, sorted_mask))

        if self.mode == "predcls":
            obj_preds = obj_labels
            obj_dists = F.one_hot(obj_labels.long(),
                                  self.num_obj_classes).float() * 2000.0 - 1000.0
            att_dists = gt_multihot
        else:
            sorted_labels = (torch.gather(obj_labels, 1, perm) if self.training
                             else None)
            logits, refined, att = self.decoder_rnn(torch.cat([sorted_pre, enc], -1),
                                                    sorted_mask, sorted_labels)
            obj_dists = gather_rows(logits, inv)
            obj_preds = torch.gather(refined, 1, inv)
            att_dists = gather_rows(att, inv)

        obj_ctx = gather_rows(enc, inv)
        att2 = torch.matmul(norm_sigmoid(att_dists).to(cdt),
                            self.att_embed2.weight.to(cdt))
        edge_pre = torch.cat([self.obj_embed2(obj_preds.long()).to(cdt), att2, x,
                              obj_ctx], -1)
        edge = self.edge_ctx_rnn(gather_rows(edge_pre, perm), sorted_mask)
        return obj_dists, obj_preds, att_dists, gather_rows(self.lin_edge_h(edge), inv)


class MotifPredictor(_PairHead):
    """Neural Motifs: the biLSTM context, the union-gated pair rep,
    ``rel_compress`` and the frequency bias (with MEET the group heads on
    the gated rep, no bias).  ``attribute_on`` swaps in
    :class:`AttributeLSTMContext`, fed the GT ``attributes`` and the
    attribute head's ``attribute_logits``, and returns its ``att_dists``
    too; the JAX model's ``build_model`` never builds it so (its
    ``model.attribute_on`` adds the attribute head beside a plain Motifs),
    and neither does the port's.  The JAX module's ``use_vision`` and
    ``use_bias``, on in every configuration, are fixed on."""

    def __init__(self, num_obj_classes: int = 151, num_rel_classes: int = 51,
                 embed_dim: int = 200, hidden_dim: int = 512, pooling_dim: int = 4096,
                 in_channels: int = 4096, mode: str = "predcls",
                 meet_group_sizes: Optional[Sequence[int]] = None,
                 meet_experts: int = 1, attribute_on: bool = False,
                 num_att_classes: int = 201, dtype: torch.dtype = torch.float32):
        super().__init__(hidden_dim, pooling_dim, dtype)
        self.dtype, self.attribute_on = dtype, attribute_on
        if attribute_on:
            self.context_layer = AttributeLSTMContext(
                num_obj_classes, num_att_classes, embed_dim, hidden_dim, in_channels,
                mode=mode, dtype=dtype)
        else:
            self.context_layer = LSTMContext(num_obj_classes, embed_dim, hidden_dim,
                                             in_channels, mode=mode, dtype=dtype)
        self.meet = meet_group_sizes is not None
        if self.meet:
            self.meet_heads = MeetRelHeads(pooling_dim, meet_group_sizes, meet_experts)
        else:
            self.rel_compress = Dense(pooling_dim, num_rel_classes, dtype=torch.float32)
            self.freq_bias = FrequencyBias(num_obj_classes, num_rel_classes)

    def forward(self, boxes, box_mask, obj_labels, predict_logits, pair_idx,
                roi_features, union_features, image_sizes, boxes_per_cls=None,
                gumbel=None, forest=None, pair_mask=None, pred_labels=None,
                attributes=None, attribute_logits=None) -> LegacyOutput:
        att_dists = None
        if self.attribute_on:
            obj_dists, obj_preds, att_dists, edge_ctx = self.context_layer(
                roi_features, boxes, box_mask, obj_labels, attributes, predict_logits,
                attribute_logits, image_sizes)
        else:
            obj_dists, obj_preds, edge_ctx = self.context_layer(
                roi_features, boxes, box_mask, obj_labels, predict_logits,
                image_sizes, boxes_per_cls)
        prod_rep = (self.post_cat(self.prod(edge_ctx, pair_idx))
                    * union_features.to(self.dtype))
        if self.meet:
            return LegacyOutput(obj_dists, None, obj_preds, att_dists=att_dists,
                                group_logits=self.meet_heads(prod_rep))
        rel_dists = (self.rel_compress(prod_rep)
                     + self.freq_bias(pair_classes(obj_preds, pair_idx)))
        return LegacyOutput(obj_dists, rel_dists, obj_preds, att_dists=att_dists)


def valid_pairs(pair_mask: Optional[torch.Tensor], pair_idx: torch.Tensor) -> torch.Tensor:
    """The (B, P) bool pair mask, all pairs when None."""
    if pair_mask is None:
        return torch.ones(pair_idx.shape[:2], dtype=torch.bool, device=pair_idx.device)
    return pair_mask


def first_argmax_labels(obj_dists: torch.Tensor) -> torch.Tensor:
    """int32 argmax over every class (background included), the first
    maximum on ties (``jnp.argmax``)."""
    idx = torch.arange(obj_dists.shape[-1], device=obj_dists.device)
    return first_argmax(obj_dists, idx.expand(obj_dists.shape)).to(torch.int32)


class GRUCell(nn.Module):
    """flax's ``nn.GRUCell`` in ``torch.nn.GRUCell``'s parameters, computing
    in ``dtype``: ``weight_ih`` (3H, D) and ``bias_ih`` (3H) of the input
    projections (r, z, n), ``weight_hh`` (3H, H) of the hidden ones, and of
    torch's ``bias_hh`` only its n third, ``bias_hn`` (H): flax puts no bias
    on the hidden r and z projections, so ``b_hr = b_hz = 0`` here, fixed.

        r = σ(W_ir x + b_ir + W_hr h),  z = σ(W_iz x + b_iz + W_hz h)
        n = tanh(W_in x + b_in + r (W_hn h + b_hn)),  h' = (1 - z) n + z h
    """

    def __init__(self, in_features: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.hidden = dtype, hidden
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden, in_features))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.bias_ih = nn.Parameter(torch.zeros(3 * hidden))
        self.bias_hn = nn.Parameter(torch.zeros(hidden))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """flax's argument order: the carry ``h``, then the input ``x``."""
        dt = self.dtype
        h = h.to(dt)
        i_r, i_z, i_n = F.linear(x.to(dt), self.weight_ih.to(dt),
                                 self.bias_ih.to(dt)).chunk(3, -1)
        h_r, h_z, h_n = F.linear(h, self.weight_hh.to(dt)).chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * (h_n + self.bias_hn.to(dt)))
        return (1.0 - z) * n + z * h


class IMPPredictor(nn.Module):
    """Iterative message passing: the pairwise features, ``obj_unary`` /
    ``edge_unary`` projections, one GRU step each from zero, then
    ``num_iter`` rounds in which each pair's GRU takes its two boxes'
    states gated by ``sub_vert_w_fc`` / ``obj_vert_w_fc`` and each box's
    GRU the sum of its outgoing and incoming pairs' states gated by
    ``out_edge_w_fc`` / ``in_edge_w_fc`` (padded pairs send nothing).
    ``rel_classifier`` on the pairs, ``obj_classifier`` on the boxes
    outside PredCls (their labels its argmax), and the frequency bias."""

    def __init__(self, num_obj_classes: int = 151, num_rel_classes: int = 51,
                 hidden_dim: int = 512, pooling_dim: int = 4096,
                 in_channels: int = 4096, num_iter: int = 3, mode: str = "predcls",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        h = hidden_dim
        self.num_obj_classes, self.num_iter, self.mode, self.dtype = (
            num_obj_classes, num_iter, mode, dtype)
        self.pairwise_feature_extractor = PairwiseFeatureExtractor(
            num_obj_classes, hidden_dim=h, pooling_dim=pooling_dim,
            in_channels=in_channels, mode=mode, dtype=dtype)
        self.obj_unary = Dense(pooling_dim, h, dtype=dtype)
        self.edge_unary = Dense(pooling_dim, h, dtype=dtype)
        self.node_gru = GRUCell(h, h, dtype)
        self.edge_gru = GRUCell(h, h, dtype)
        for name in ("sub_vert_w_fc", "obj_vert_w_fc", "out_edge_w_fc", "in_edge_w_fc"):
            self.add_module(name, Dense(2 * h, 1, dtype=dtype))
        if mode != "predcls":
            self.obj_classifier = Dense(h, num_obj_classes, dtype=torch.float32)
        self.rel_classifier = Dense(h, num_rel_classes, dtype=torch.float32)
        self.freq_bias = FrequencyBias(num_obj_classes, num_rel_classes)

    def forward(self, boxes, box_mask, obj_labels, predict_logits, pair_idx,
                roi_features, union_features, image_sizes, boxes_per_cls=None,
                gumbel=None, forest=None, pair_mask=None,
                pred_labels=None) -> LegacyOutput:
        n = box_mask.shape[1]
        pred_labels = obj_labels if pred_labels is None else pred_labels
        aug_obj, rel_feats = self.pairwise_feature_extractor(
            roi_features, union_features, boxes, obj_labels, predict_logits,
            pred_labels, pair_idx, image_sizes)
        obj_rep = self.obj_unary(aug_obj)
        rel_rep = F.relu(self.edge_unary(rel_feats))
        si, oi = pair_idx[..., 0], pair_idx[..., 1]
        pm = valid_pairs(pair_mask, pair_idx)[..., None].to(self.dtype)
        vert = self.node_gru(torch.zeros_like(obj_rep), obj_rep)
        edge = self.edge_gru(torch.zeros_like(rel_rep), rel_rep)
        for _ in range(self.num_iter):
            sub_vert, obj_vert = take_rows(vert, si), take_rows(vert, oi)
            sub_edge = torch.cat([sub_vert, edge], -1)
            obj_edge = torch.cat([obj_vert, edge], -1)
            w_sub = torch.sigmoid(self.sub_vert_w_fc(sub_edge))
            w_obj = torch.sigmoid(self.obj_vert_w_fc(obj_edge))
            new_edge = self.edge_gru(edge, (w_sub * sub_vert + w_obj * obj_vert) * pm)
            pre_out = torch.sigmoid(self.out_edge_w_fc(sub_edge)) * edge * pm
            pre_in = torch.sigmoid(self.in_edge_w_fc(obj_edge)) * edge * pm
            vert = self.node_gru(vert, segment_sum(pre_out, si, n)
                                 + segment_sum(pre_in, oi, n))
            edge = new_edge
        if self.mode == "predcls":
            obj_dists = F.one_hot(obj_labels.long(), self.num_obj_classes).float()
        else:
            obj_dists = self.obj_classifier(vert)
        obj_preds = first_argmax_labels(obj_dists)
        rel_dists = (self.rel_classifier(edge)
                     + self.freq_bias(pair_classes(obj_preds, pair_idx)))
        return LegacyOutput(obj_dists, rel_dists, obj_preds)
