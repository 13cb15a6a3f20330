"""Attention contexts of the legacy predictors
(``veto_tpu/models/relation/legacy/context.py``, part 1 and 2 of 3).

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

``PairwiseFeatureExtractor`` (IMP, the BGNN family) comes with them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ....ops.box_ops import encode_box_info
from ....ops.nms import first_argmax, obj_prediction_nms
from ...layers import Dense, LayerNorm


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
