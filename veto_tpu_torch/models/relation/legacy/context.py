"""Contexts of the legacy predictors
(``veto_tpu/models/relation/legacy/context.py``).

  * :class:`MaskedEncoder`: the post-LN encoder of "attention is all you
    need" over the padded proposal axis (reference ``model_transformer``):
    per-head key / value widths, residual and LayerNorm after attention
    and after the FFN, padded positions zeroed after each;
  * :class:`TransformerContext`: the object and edge stacks of the
    Transformer predictor, with the SGDet late NMS of the refined labels;
  * :class:`SHAEncoder` / :class:`SHAContext`: the hybrid self / cross
    attention over a visual and a textual stream (TransLike's context).

Attention masks the keys with -1e9 and takes its softmax in f32, so a
query row whose keys are all padding attends uniformly (and is zeroed
after), never NaN; the scores and the value product run in the model's
dtype, as in the JAX modules.  The JAX package computes all of it with
XLA, outside any Pallas kernel; so does the port (``torch.matmul``).
LayerNorms are flax's (epsilon 1e-6, fast variance).

  * :class:`PairwiseFeatureExtractor` and :func:`box_pair_info`: the
    object and pair features of IMP and the BGNN family (Motifs-style
    label embeddings and geometry; the pairs' head / tail features gated
    by their 32-d geometry, fused with the union features).

The message-passing predictors gather rows by pair index and sum them
back over segments; :func:`take_rows` and :func:`segment_sum` do both as
products with the (B, N, P) incidence matrix of the pair index, so that
neither the forward nor its backward adds into one address from many
threads (``torch.gather``'s backward and ``index_add_`` do, with float
atomics): two runs on the card are bit-equal.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ....ops.box_ops import encode_box_info
from ....ops.nms import first_argmax, obj_prediction_nms
from ...layers import BatchNorm1d, Dense, LayerNorm
from .lstm import gather_rows


def _attend(q, k, v, mask, heads, d_k, d_v, dtype):
    """Multi-head attention over (B, N, h * d) projections, keys masked by
    (B, N) ``mask`` → (B, N, h * d_v)."""
    b, n, _ = q.shape
    q = q.reshape(b, n, heads, d_k).transpose(1, 2)
    k = k.reshape(b, k.shape[1], heads, d_k).transpose(1, 2)
    v = v.reshape(b, v.shape[1], heads, d_v).transpose(1, 2)
    scale = torch.full((), math.sqrt(float(d_k)), dtype=dtype, device=q.device)
    att = torch.matmul(q, k.transpose(-1, -2)) / scale
    att = torch.where(mask[:, None, None, :], att, -1e9)
    att = torch.softmax(att.float(), dim=-1).to(dtype)
    return torch.matmul(att, v).transpose(1, 2).reshape(b, n, heads * d_v)


class _MHA(nn.Module):
    """Post-LN multi-head self-attention with distinct d_k / d_v."""

    def __init__(self, heads: int, d_model: int, d_k: int, d_v: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.d_k, self.d_v, self.dtype = heads, d_k, d_v, dtype
        self.w_qs = Dense(d_model, heads * d_k, dtype=dtype)
        self.w_ks = Dense(d_model, heads * d_k, dtype=dtype)
        self.w_vs = Dense(d_model, heads * d_v, dtype=dtype)
        self.fc = Dense(heads * d_v, d_model, dtype=dtype)
        self.ln = LayerNorm(d_model)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        kv = x if kv is None else kv
        out = _attend(self.w_qs(x), self.w_ks(kv), self.w_vs(kv), mask,
                      self.heads, self.d_k, self.d_v, self.dtype)
        return self.ln(self.fc(out) + x.to(self.dtype))


class _CrossMHA(_MHA):
    """Post-LN multi-head cross-attention: queries from ``x``, keys and
    values from ``kv``."""

    def forward(self, x, kv, mask):  # noqa: D102
        return super().forward(x, mask, kv)


class _FFN(nn.Module):
    """Post-LN position-wise FFN."""

    def __init__(self, d_model: int, d_inner: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.w1 = Dense(d_model, d_inner, dtype=dtype)
        self.w2 = Dense(d_inner, d_model, dtype=dtype)
        self.ln = LayerNorm(d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.w2(F.relu(self.w1(x)))
        return self.ln(y + x.to(self.dtype))


class MaskedEncoder(nn.Module):
    """``layers`` x (attention, FFN) over the padded proposal axis."""

    def __init__(self, layers: int = 4, heads: int = 8, d_model: int = 512,
                 d_inner: int = 2048, d_k: int = 64, d_v: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"attn{i}", _MHA(heads, d_model, d_k, d_v, dtype))
            self.add_module(f"ffn{i}", _FFN(d_model, d_inner, dtype))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = mask[..., None].to(x.dtype)
        for i in range(self.layers):
            x = getattr(self, f"attn{i}")(x, mask) * m
            x = getattr(self, f"ffn{i}")(x) * m
        return x


class SHAEncoder(nn.Module):
    """Stacked hybrid attention: per layer each stream takes self-attention
    plus cross-attention against the other (each through its FFN), summed;
    the output is the visual stream plus the textual one."""

    def __init__(self, layers: int = 2, heads: int = 8, d_model: int = 512,
                 d_inner: int = 2048, d_k: int = 64, d_v: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            for s in ("txt", "vis"):
                self.add_module(f"sa_{s}{i}", _MHA(heads, d_model, d_k, d_v, dtype))
                self.add_module(f"sa_{s}_ffn{i}", _FFN(d_model, d_inner, dtype))
                self.add_module(f"ca_{s}{i}", _CrossMHA(heads, d_model, d_k, d_v, dtype))
                self.add_module(f"ca_{s}_ffn{i}", _FFN(d_model, d_inner, dtype))

    def forward(self, vis: torch.Tensor, txt: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        m = mask[..., None].to(vis.dtype)

        def stream(s, x, other, i):
            sa = getattr(self, f"sa_{s}_ffn{i}")(getattr(self, f"sa_{s}{i}")(x, mask)) * m
            ca = getattr(self, f"ca_{s}_ffn{i}")(
                getattr(self, f"ca_{s}{i}")(x, other, mask)) * m
            return sa + ca

        for i in range(self.layers):
            txt, vis = stream("txt", txt, vis, i), stream("vis", vis, txt, i)
        return vis + txt


def refined_labels(obj_dists: torch.Tensor, boxes: torch.Tensor,
                   box_mask: torch.Tensor, boxes_per_cls, mode: str,
                   training: bool, later_nms_thres: float) -> torch.Tensor:
    """The contexts' object labels outside PredCls: in SGDet evaluation the
    late NMS over ``boxes_per_cls`` (the boxes tiled over the classes when
    None), relabelling every box; else the argmax foreground."""
    if mode == "sgdet" and not training:
        b, n, c = obj_dists.shape
        bpc = boxes_per_cls if boxes_per_cls is not None else \
            boxes[:, :, None, :].expand(b, n, c, 4)
        return obj_prediction_nms(bpc, obj_dists, later_nms_thres,
                                  valid_mask=box_mask, overwrite=True)
    idx = torch.arange(obj_dists.shape[-1] - 1,
                       device=obj_dists.device).expand(obj_dists.shape[:-1] + (-1,))
    return (first_argmax(obj_dists[..., 1:], idx) + 1).to(torch.int32)


def soft_embed(embed: nn.Embedding, predict_logits: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The class embedding under the box head's softmax: ``softmax(logits)
    @ table`` in the compute dtype."""
    probs = torch.softmax(predict_logits.float(), dim=-1)
    return torch.matmul(probs.to(dtype), embed.weight.to(dtype))


class _AttentionContext(nn.Module):
    """What the Transformer and SHA contexts share: the two class
    embeddings, the 9 → 32 → 128 box geometry, and the object classifier
    ``out_obj`` outside PredCls."""

    def __init__(self, num_obj_classes, embed_dim, hidden_dim, mode,
                 later_nms_thres, dtype):
        super().__init__()
        self.num_obj_classes, self.mode, self.dtype = num_obj_classes, mode, dtype
        self.later_nms_thres = later_nms_thres
        self.obj_embed1 = nn.Embedding(num_obj_classes, embed_dim)
        self.obj_embed2 = nn.Embedding(num_obj_classes, embed_dim)
        self.bbox_fc1 = Dense(9, 32, dtype=dtype)
        self.bbox_fc2 = Dense(32, 128, dtype=dtype)
        if mode != "predcls":
            self.out_obj = Dense(hidden_dim, num_obj_classes, dtype=torch.float32)

    def embed_and_geometry(self, boxes, obj_labels, predict_logits, image_sizes):
        cdt = self.dtype
        if self.mode == "predcls":
            obj_embed = self.obj_embed1(obj_labels.long()).to(cdt)
        else:
            obj_embed = soft_embed(self.obj_embed1, predict_logits, cdt)
        pos = F.relu(self.bbox_fc1(encode_box_info(boxes, image_sizes).to(cdt)))
        return obj_embed, F.relu(self.bbox_fc2(pos))

    def objects(self, obj_feats, obj_labels, boxes, box_mask, boxes_per_cls):
        """(obj_dists, obj_preds, the edge stream's class embedding)."""
        if self.mode == "predcls":
            dists = F.one_hot(obj_labels.long(), self.num_obj_classes).float()
            return dists, obj_labels, self.obj_embed2(obj_labels.long()).to(self.dtype)
        dists = self.out_obj(obj_feats)
        preds = refined_labels(dists, boxes, box_mask, boxes_per_cls, self.mode,
                               self.training, self.later_nms_thres)
        return dists, preds, self.obj_embed2(preds.long()).to(self.dtype)


class TransformerContext(_AttentionContext):
    """Object and edge context: (obj_dists (B, N, C) f32, obj_preds (B, N),
    edge_ctx (B, N, hidden))."""

    def __init__(self, num_obj_classes: int = 151, embed_dim: int = 200,
                 hidden_dim: int = 512, in_dim: int = 4096, obj_layers: int = 4,
                 edge_layers: int = 2, heads: int = 8, inner_dim: int = 2048,
                 k_dim: int = 64, v_dim: int = 64, mode: str = "predcls",
                 later_nms_thres: float = 0.3, dtype: torch.dtype = torch.float32):
        super().__init__(num_obj_classes, embed_dim, hidden_dim, mode,
                         later_nms_thres, dtype)
        enc = (heads, hidden_dim, inner_dim, k_dim, v_dim, dtype)
        self.lin_obj = Dense(in_dim + embed_dim + 128, hidden_dim, dtype=dtype)
        self.context_obj = MaskedEncoder(obj_layers, *enc)
        self.lin_edge = Dense(in_dim + hidden_dim + embed_dim, hidden_dim, dtype=dtype)
        self.context_edge = MaskedEncoder(edge_layers, *enc)

    def forward(self, roi_features, boxes, box_mask, obj_labels, predict_logits,
                image_sizes, boxes_per_cls=None):
        cdt = self.dtype
        obj_embed, pos = self.embed_and_geometry(boxes, obj_labels, predict_logits,
                                                 image_sizes)
        x = roi_features.to(cdt)
        obj_pre = self.lin_obj(torch.cat([x, obj_embed, pos], -1))
        obj_feats = self.context_obj(obj_pre, box_mask)
        dists, preds, e2 = self.objects(obj_feats, obj_labels, boxes, box_mask,
                                        boxes_per_cls)
        edge_pre = self.lin_edge(torch.cat([x, obj_feats, e2], -1))
        return dists, preds, self.context_edge(edge_pre, box_mask)


class SHAContext(_AttentionContext):
    """The hybrid-attention context: visual (roi features + geometry) and
    textual (class embedding) streams, for the objects and for the edges."""

    def __init__(self, num_obj_classes: int = 151, embed_dim: int = 200,
                 hidden_dim: int = 512, in_dim: int = 4096, obj_layers: int = 4,
                 edge_layers: int = 2, heads: int = 8, inner_dim: int = 2048,
                 k_dim: int = 64, v_dim: int = 64, mode: str = "predcls",
                 later_nms_thres: float = 0.3, dtype: torch.dtype = torch.float32):
        super().__init__(num_obj_classes, embed_dim, hidden_dim, mode,
                         later_nms_thres, dtype)
        enc = (heads, hidden_dim, inner_dim, k_dim, v_dim, dtype)
        self.lin_obj_visual = Dense(in_dim + 128, hidden_dim, dtype=dtype)
        self.lin_obj_textual = Dense(embed_dim, hidden_dim, dtype=dtype)
        self.context_obj = SHAEncoder(obj_layers, *enc)
        self.lin_edge_visual = Dense(in_dim + hidden_dim, hidden_dim, dtype=dtype)
        self.lin_edge_textual = Dense(embed_dim, hidden_dim, dtype=dtype)
        self.context_edge = SHAEncoder(edge_layers, *enc)

    def forward(self, roi_features, boxes, box_mask, obj_labels, predict_logits,
                image_sizes, boxes_per_cls=None):
        cdt = self.dtype
        obj_embed, pos = self.embed_and_geometry(boxes, obj_labels, predict_logits,
                                                 image_sizes)
        x = roi_features.to(cdt)
        vis = self.lin_obj_visual(torch.cat([x, pos], -1))
        obj_feats = self.context_obj(vis, self.lin_obj_textual(obj_embed), box_mask)
        dists, preds, e2 = self.objects(obj_feats, obj_labels, boxes, box_mask,
                                        boxes_per_cls)
        edge_vis = self.lin_edge_visual(torch.cat([x, obj_feats], -1))
        edge_ctx = self.context_edge(edge_vis, self.lin_edge_textual(e2), box_mask)
        return dists, preds, edge_ctx


def incidence(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """(B, P) indices into n rows → the (B, N, P) incidence matrix in
    ``dtype``: 1 where ``idx[b, p] == n``."""
    rows = torch.arange(n, device=idx.device)
    return (idx.long()[:, None, :] == rows[None, :, None]).to(dtype)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x`` (B, N, F) at ``idx`` (B, P) along axis 1 (the JAX modules'
    ``_gather``), as the product of the transposed incidence matrix with
    ``x``: exact (one nonzero term a row), and its backward a product too."""
    return torch.matmul(incidence(idx, x.shape[1], x.dtype).transpose(1, 2), x)


def segment_sum(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B, P, F) ``vals`` summed into n rows by ``idx`` (B, P) → (B, N, F)
    (``jax.ops.segment_sum`` vmapped over the batch), as a product with the
    incidence matrix; (B, P) ``vals`` → (B, N)."""
    if vals.dim() == 2:
        return segment_sum(vals[..., None], idx, n)[..., 0]
    return torch.matmul(incidence(idx, n, vals.dtype), vals)


def box_pair_info(boxes: torch.Tensor, image_sizes: torch.Tensor,
                  pair_idx: torch.Tensor) -> torch.Tensor:
    """The 32-d pair geometry (B, P, 32): each box's 12-d normalized info
    (x1, y1, x2, y2, cx, cy, w, h over the image, the area share, the
    aspect (x2 - x1) / (y2 - y1 + 1e-9), two zeros) for the head and the
    tail, then the union's and the intersection's normalized corners."""
    wid = image_sizes.float()[:, None, 0]
    hei = image_sizes.float()[:, None, 1]

    def info(b):
        x1, y1, x2, y2 = b.unbind(-1)
        bw, bh = x2 - x1 + 1.0, y2 - y1 + 1.0
        cx, cy = x1 + bw * 0.5, y1 + bh * 0.5
        zero = torch.zeros_like(x1)
        return torch.stack([x1 / wid, y1 / hei, x2 / wid, y2 / hei, cx / wid,
                            cy / hei, bw / wid, bh / hei, bw * bh / (wid * hei),
                            (x2 - x1) / (y2 - y1 + 1e-9), zero, zero], -1)

    box_info = info(boxes)
    si, oi = pair_idx[..., 0], pair_idx[..., 1]
    hb, tb = gather_rows(boxes, si), gather_rows(boxes, oi)
    extra = torch.stack([
        torch.minimum(hb[..., 0], tb[..., 0]) / wid,
        torch.minimum(hb[..., 1], tb[..., 1]) / hei,
        torch.maximum(hb[..., 2], tb[..., 2]) / wid,
        torch.maximum(hb[..., 3], tb[..., 3]) / hei,
        torch.maximum(hb[..., 0], tb[..., 0]) / wid,
        torch.maximum(hb[..., 1], tb[..., 1]) / hei,
        torch.minimum(hb[..., 2], tb[..., 2]) / wid,
        torch.minimum(hb[..., 3], tb[..., 3]) / hei], -1)
    return torch.cat([gather_rows(box_info, si), gather_rows(box_info, oi), extra], -1)


class PairwiseFeatureExtractor(nn.Module):
    """The object and pair features of IMP and the BGNN family (the JAX
    module's ``rel_feature_type="fusion"`` with the spatial gate and the
    word embeddings, the only setting its predictors use): (augmented
    object features (B, N, pooling_dim), pair features (B, P,
    pooling_dim)).

    Objects: [roi, class embedding (the labels' in PredCls and in training,
    else the box head's soft one), 9 → 32 → BN → 128 geometry] →
    ``obj_hidden_linear``; [embedding of ``pred_labels``, roi, that] is the
    augmented object.  Pairs: its head / tail halves (``pairwise_obj_feat_
    updim_fc``) joined, gated by the pair geometry's 32 → h → 2h net, then
    ``pairwise_rel_feat_finalize_fc`` + the union features.  ``pos_bn``
    keeps flax's momentum 0.999.  The union features arrive
    ``pooling_dim`` wide (``SGGModel`` builds them so), so the JAX
    module's ``rel_feature_up_dim`` is never built."""

    def __init__(self, num_obj_classes: int = 151, embed_dim: int = 200,
                 hidden_dim: int = 512, pooling_dim: int = 4096,
                 in_channels: int = 4096, mode: str = "predcls",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if in_channels != pooling_dim:
            raise ValueError(f"in_channels {in_channels} != pooling_dim "
                             f"{pooling_dim}: the union features come pooling_dim wide")
        self.mode, self.dtype, self.hidden_dim = mode, dtype, hidden_dim
        self.obj_embed_on_prob_dist = nn.Embedding(num_obj_classes, embed_dim)
        self.obj_embed_on_pred_label = nn.Embedding(num_obj_classes, embed_dim)
        self.pos_fc1 = Dense(9, 32, dtype=dtype)
        self.pos_bn = BatchNorm1d(32, momentum=0.999)
        self.pos_fc2 = Dense(32, 128, dtype=dtype)
        self.obj_hidden_linear = Dense(in_channels + embed_dim + 128, hidden_dim,
                                       dtype=dtype)
        full = embed_dim + in_channels + hidden_dim
        self.pairwise_obj_feat_updim_fc = Dense(full, hidden_dim * 2, dtype=dtype)
        self.spt_fc1 = Dense(32, hidden_dim, dtype=dtype)
        self.spt_fc2 = Dense(hidden_dim, hidden_dim * 2, dtype=dtype)
        self.pairwise_rel_feat_finalize_fc = Dense(hidden_dim * 2, pooling_dim,
                                                   dtype=dtype)
        self.obj_feat_aug_finalize_fc = Dense(full, pooling_dim, dtype=dtype)

    def forward(self, roi_features, union_features, boxes, obj_labels,
                predict_logits, pred_labels, pair_idx, image_sizes):
        cdt = self.dtype
        roi = roi_features.to(cdt)
        if self.mode == "predcls" or self.training:
            e_dist = self.obj_embed_on_prob_dist(obj_labels.long()).to(cdt)
        else:
            e_dist = soft_embed(self.obj_embed_on_prob_dist, predict_logits, cdt)
        e_label = self.obj_embed_on_pred_label(pred_labels.long()).to(cdt)
        g = self.pos_bn(self.pos_fc1(encode_box_info(boxes, image_sizes).to(cdt)))
        g = F.relu(self.pos_fc2(g))
        aug = self.obj_hidden_linear(torch.cat([roi, e_dist, g], -1))
        aug_full = torch.cat([e_label, roi, aug], -1)

        h = self.hidden_dim
        fused = self.pairwise_obj_feat_updim_fc(aug_full)
        pair = torch.cat([take_rows(fused[..., :h], pair_idx[..., 0]),
                          take_rows(fused[..., h:], pair_idx[..., 1])], -1)
        geo = box_pair_info(boxes, image_sizes, pair_idx).to(cdt)
        pair = pair * F.relu(self.spt_fc2(F.relu(self.spt_fc1(geo))))
        rel = F.relu(self.pairwise_rel_feat_finalize_fc(pair))
        rel = union_features.to(cdt) + rel
        return F.relu(self.obj_feat_aug_finalize_fc(aug_full)), rel
