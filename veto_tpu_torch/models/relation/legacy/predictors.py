"""Legacy relation predictors (``veto_tpu/models/relation/legacy/
predictors.py``): Transformer, TransLike and Motifs, with their MEET heads.

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

Every predictor returns a :class:`LegacyOutput`; its ``rel_logits``
property is the relation output the engine reads (``rel_dists``, or the
group logits with MEET).  The four share one call signature: VCTree's
decoder noise ``gumbel`` and its ``forest`` are ignored by the others.
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
from ....ops.nms import obj_prediction_nms
from ...layers import BatchNorm1d, Dense
from ..freq_bias import FrequencyBias
from .context import SHAContext, TransformerContext, soft_embed
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
        """(B, P, 2 hidden) joined head and tail representations."""
        rep = self.post_emb(edge_ctx)
        if self.relu_emb:
            rep = F.relu(rep)
        h = self.hidden_dim
        return torch.cat([gather_rows(rep[..., :h], pair_idx[..., 0]),
                          gather_rows(rep[..., h:], pair_idx[..., 1])], -1)


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
                gumbel=None, forest=None) -> LegacyOutput:
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
    background column at 0).  ``effect_analysis`` (Causal-TDE's moving
    average decoder input) comes with ``CausalPredictor``."""

    def __init__(self, num_obj_classes: int = 151, embed_dim: int = 200,
                 hidden_dim: int = 512, in_dim: int = 4096, obj_layers: int = 1,
                 edge_layers: int = 1, mode: str = "predcls",
                 later_nms_thres: float = 0.3, effect_analysis: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if effect_analysis:
            raise NotImplementedError(
                "LSTMContext.effect_analysis (Causal-TDE) comes with CausalPredictor")
        self.num_obj_classes, self.mode, self.dtype = num_obj_classes, mode, dtype
        self.later_nms_thres = later_nms_thres
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
        self.edge_ctx_rnn = MaskedBiLSTM(embed_dim + in_dim + hidden_dim, hidden_dim,
                                         edge_layers, dtype)
        self.lin_edge_h = Dense(2 * hidden_dim, hidden_dim, dtype=dtype)

    def forward(self, roi_features, boxes, box_mask, obj_labels, predict_logits,
                image_sizes, boxes_per_cls=None):
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
            sorted_labels = (torch.gather(obj_labels, 1, perm) if self.training
                             else None)
            logits, refined = self.decoder_rnn(torch.cat([sorted_pre, enc], -1),
                                               sorted_mask, sorted_labels)
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


class MotifPredictor(_PairHead):
    """Neural Motifs: the biLSTM context, the union-gated pair rep,
    ``rel_compress`` and the frequency bias (with MEET the group heads on
    the gated rep, no bias).  ``attribute_on`` comes with
    ``AttributeLSTMContext``; the JAX module's ``use_vision`` and
    ``use_bias``, on in every configuration, are fixed on."""

    def __init__(self, num_obj_classes: int = 151, num_rel_classes: int = 51,
                 embed_dim: int = 200, hidden_dim: int = 512, pooling_dim: int = 4096,
                 in_channels: int = 4096, mode: str = "predcls",
                 meet_group_sizes: Optional[Sequence[int]] = None,
                 meet_experts: int = 1, attribute_on: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_dim, pooling_dim, dtype)
        if attribute_on:
            raise NotImplementedError(
                "MotifPredictor with attribute_on comes with AttributeLSTMContext")
        self.dtype = dtype
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
                gumbel=None, forest=None) -> LegacyOutput:
        obj_dists, obj_preds, edge_ctx = self.context_layer(
            roi_features, boxes, box_mask, obj_labels, predict_logits, image_sizes,
            boxes_per_cls)
        prod_rep = (self.post_cat(self.prod(edge_ctx, pair_idx))
                    * union_features.to(self.dtype))
        if self.meet:
            return LegacyOutput(obj_dists, None, obj_preds,
                                group_logits=self.meet_heads(prod_rep))
        rel_dists = (self.rel_compress(prod_rep)
                     + self.freq_bias(pair_classes(obj_preds, pair_idx)))
        return LegacyOutput(obj_dists, rel_dists, obj_preds)
