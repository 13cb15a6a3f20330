"""AGRCNN, Graph R-CNN's attentional graph convolution
(``veto_tpu/models/relation/legacy/agcn.py``).

Object and predicate nodes on a bipartite graph collect messages by
per-target multi-head attention over their adjacent nodes: two rounds on
the features (``graph_hidden_dim`` wide), two on the logits.  The JAX
package, and this port, run each collect unit (:class:`AdjacencyMHA`) as
one dense masked attention over the whole (targets, sources) grid, the
adjacency its mask; a target without an incoming edge keeps its features.

The reference's quirks, kept as the JAX module keeps them: every update is
gated on the rel→obj / sub→rel validity sets, not each message's own; the
feature-level predicate update takes the predicate features as both target
and source, so a valid predicate doubles; the update unit is a plain sum.

``use_obj_recls_logits`` (off in every configuration the JAX model builds)
refines the object logits and relabels them by ``obj_prediction_nms`` at
IoU 0.5 outside PredCls.  The JAX model gives AGRCNN no ``pred_labels``,
so the labels it keys the frequency bias on are ``obj_labels``, and the
port's ``pred_labels`` argument is ignored.  The JAX module's
``mp_on_valid_pairs`` filter reads relness scores that no JAX model
passes it; the port has no such filter.  No kernel of its own: the JAX
module runs on XLA outside Pallas.
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn

from ....ops.nms import obj_prediction_nms
from ...layers import Dense
from ..freq_bias import FrequencyBias
from .context import PairwiseFeatureExtractor, incidence
from .predictors import LegacyOutput, pair_classes, valid_pairs

FEAT_UNITS = ("rel2sub", "rel2obj", "sub2rel", "obj2rel", "inst2inst")


class AdjacencyMHA(nn.Module):
    """One collect unit: the sources through ReLU(``trans_fc``), then
    multi-head attention of each target (one query) over the sources its
    row of ``adj`` marks (scores in f32, -1e9 off the graph).  Returns the
    (B, T, dim) message, 0 for a target without an edge, and the (B, T)
    bool of the targets with one."""

    def __init__(self, target_dim: int, source_dim: int, dim: int, heads: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        self.trans_fc = Dense(source_dim, dim, dtype=dtype)
        self.q_proj = Dense(target_dim, dim, dtype=dtype)
        self.k_proj = Dense(dim, dim, dtype=dtype)
        self.v_proj = Dense(dim, dim, dtype=dtype)
        self.out_proj = Dense(dim, dim, dtype=dtype)

    def forward(self, target, source, adj):
        """target (B, T, Dt), source (B, S, Ds), adj (B, T, S): nonzero is an edge."""
        d, h = self.dim, self.heads
        dh = d // h
        src = F.relu(self.trans_fc(source))
        q, k, v = self.q_proj(target), self.k_proj(src), self.v_proj(src)
        b, t, s = q.shape[0], q.shape[1], k.shape[1]
        q = q.reshape(b, t, h, dh).transpose(1, 2)
        k = k.reshape(b, s, h, dh).transpose(1, 2)
        v = v.reshape(b, s, h, dh).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
        edge = adj > 0
        scores = torch.where(edge[:, None], scores.float(), -1e9)
        attn = torch.softmax(scores, dim=-1).to(self.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, d)
        out = self.out_proj(out)
        valid = edge.any(-1)
        return torch.where(valid[..., None], out, 0.0), valid


class GRCNNContext(nn.Module):
    """The GRCNN graph module on the padded layout: (obj_logits (B, N,
    num_obj), rel_logits (B, P, num_rel)), both f32."""

    def __init__(self, num_obj_classes: int = 151, num_rel_classes: int = 51,
                 in_dim: int = 4096, hidden_dim: int = 1024, feat_update_step: int = 2,
                 score_update_step: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        d, no, nr = hidden_dim, num_obj_classes, num_rel_classes
        self.dtype = dtype
        self.feat_update_step = feat_update_step
        self.score_update_step = score_update_step
        for name in ("obj_embedding", "rel_embedding"):
            self.add_module(f"{name}_fc1", Dense(in_dim, d, dtype=dtype))
            self.add_module(f"{name}_fc2", Dense(d, d, dtype=dtype))
        for name in FEAT_UNITS:
            self.add_module(f"collect_feat_{name}", AdjacencyMHA(d, d, d, 4, dtype))
        self.obj_hidden_embedding = Dense(d, no, dtype=torch.float32)
        self.rel_hidden_embedding = Dense(d, nr, dtype=torch.float32)
        f32 = torch.float32
        self.collect_score_inst2inst = AdjacencyMHA(no, no, no, 1, f32)
        self.collect_score_rel2sub = AdjacencyMHA(no, nr, no, 1, f32)
        self.collect_score_rel2obj = AdjacencyMHA(no, nr, no, 1, f32)
        self.collect_score_sub2rel = AdjacencyMHA(nr, no, nr, 1, f32)
        self.collect_score_obj2rel = AdjacencyMHA(nr, no, nr, 1, f32)

    def _mlp(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = getattr(self, f"{name}_fc1")(x)
        return getattr(self, f"{name}_fc2")(F.relu(y))

    def forward(self, obj_feats, rel_feats, box_mask, pair_idx, pair_mask):
        cdt = self.dtype
        n = box_mask.shape[1]
        si, oi = pair_idx[..., 0], pair_idx[..., 1]
        pm = pair_mask.to(cdt)[:, None, :]
        subj_pred_map = incidence(si, n, cdt) * pm  # (B, N, P)
        obj_pred_map = incidence(oi, n, cdt) * pm
        obj_obj = torch.matmul(subj_pred_map, obj_pred_map.transpose(1, 2))
        bm = box_mask.to(cdt)
        obj_obj_map = (((obj_obj + obj_obj.transpose(1, 2)) > 0).to(cdt)
                       * bm[:, :, None] * bm[:, None, :])
        pred_subj_map = subj_pred_map.transpose(1, 2)  # (B, P, N)
        pred_obj_map = obj_pred_map.transpose(1, 2)

        x_obj = self._mlp("obj_embedding", obj_feats)
        x_pred = self._mlp("rel_embedding", rel_feats)
        for _ in range(self.feat_update_step):
            msg_obj, _ = self.collect_feat_inst2inst(x_obj, x_obj, obj_obj_map)
            msg_sub, _ = self.collect_feat_rel2sub(x_obj, x_pred, subj_pred_map)
            msg_o, valid_rel_obj = self.collect_feat_rel2obj(x_obj, x_pred, obj_pred_map)
            ent_msg = (msg_obj + msg_sub + msg_o) / 3.0
            x_obj = torch.where(valid_rel_obj[..., None], x_obj + ent_msg, x_obj)
            # the reference's quirk: the predicate update adds its own
            # features, so of the sub→rel and obj→rel units only the former's
            # validity is read (XLA computes nothing more of them in the JAX
            # step, and neither does the port; their weights get no gradient)
            valid_obj_rel = (pred_subj_map > 0).any(-1)
            x_pred = torch.where(valid_obj_rel[..., None], x_pred + x_pred, x_pred)

        obj_logits = self.obj_hidden_embedding(F.relu(x_obj))
        rel_logits = self.rel_hidden_embedding(F.relu(x_pred))
        for _ in range(self.score_update_step):
            msg_obj, _ = self.collect_score_inst2inst(obj_logits, obj_logits, obj_obj_map)
            msg_sub, _ = self.collect_score_rel2sub(obj_logits, rel_logits, subj_pred_map)
            msg_o, valid_rel_obj = self.collect_score_rel2obj(obj_logits, rel_logits,
                                                              obj_pred_map)
            ent_msg = (msg_obj + msg_sub + msg_o) / 3.0
            obj_logits = torch.where(valid_rel_obj[..., None], obj_logits + ent_msg,
                                     obj_logits)
            msg_s, valid_obj_rel = self.collect_score_sub2rel(rel_logits, obj_logits,
                                                              pred_subj_map)
            msg_t, _ = self.collect_score_obj2rel(rel_logits, obj_logits, pred_obj_map)
            rel_logits = torch.where(valid_obj_rel[..., None],
                                     rel_logits + (msg_s + msg_t) / 2.0, rel_logits)
        return obj_logits, rel_logits


class AGRCNNPredictor(nn.Module):
    """The AGRCNN relation head: the pairwise features (at hidden 512, fixed
    as in the JAX module), the graph context, the 1:1 classifiers
    ``obj_classifier`` (outside PredCls) and ``rel_classifier``, and the
    frequency bias.  In PredCls the object output is the ±1000 one-hot of
    the labels; outside it the proposals' logits (or, with
    ``use_obj_recls_logits``, the refined ones, ``obj_recls_manner``
    ``replace`` or ``add``)."""

    def __init__(self, num_obj_classes: int = 151, num_rel_classes: int = 51,
                 hidden_dim: int = 512, pooling_dim: int = 4096,
                 in_channels: int = 4096, graph_hidden_dim: int = 1024,
                 feat_update_step: int = 2, score_update_step: int = 2,
                 mode: str = "predcls", use_obj_recls_logits: bool = False,
                 obj_recls_manner: str = "replace", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_obj_classes, self.mode = num_obj_classes, mode
        self.use_obj_recls_logits, self.obj_recls_manner = (use_obj_recls_logits,
                                                            obj_recls_manner)
        self.pairwise_feature_extractor = PairwiseFeatureExtractor(
            num_obj_classes, hidden_dim=512, pooling_dim=pooling_dim,
            in_channels=in_channels, mode=mode, dtype=dtype)
        self.context_layer = GRCNNContext(
            num_obj_classes, num_rel_classes, pooling_dim, graph_hidden_dim,
            feat_update_step, score_update_step, dtype)
        if mode != "predcls":
            self.obj_classifier = Dense(num_obj_classes, num_obj_classes,
                                        dtype=torch.float32)
        self.rel_classifier = Dense(num_rel_classes, num_rel_classes, dtype=torch.float32)
        self.freq_bias = FrequencyBias(num_obj_classes, num_rel_classes)

    def forward(self, boxes, box_mask, obj_labels, predict_logits, pair_idx,
                roi_features, union_features, image_sizes, boxes_per_cls=None,
                gumbel=None, forest=None, pair_mask=None,
                pred_labels=None) -> LegacyOutput:
        aug_obj, rel_feats = self.pairwise_feature_extractor(
            roi_features, union_features, boxes, obj_labels, predict_logits,
            obj_labels, pair_idx, image_sizes)
        ctx_obj, ctx_rel = self.context_layer(aug_obj, rel_feats, box_mask, pair_idx,
                                              valid_pairs(pair_mask, pair_idx))
        rel_logits = self.rel_classifier(ctx_rel)
        if self.mode == "predcls":
            out_obj = F.one_hot(obj_labels.long(),
                                self.num_obj_classes).float() * 2000.0 - 1000.0
            labels = obj_labels
        else:
            out_obj, labels = predict_logits.float(), obj_labels
            if self.use_obj_recls_logits:
                refined = self.obj_classifier(ctx_obj)
                out_obj = refined + predict_logits if self.obj_recls_manner == "add" \
                    else refined
                b, n, c = out_obj.shape
                bpc = boxes_per_cls if boxes_per_cls is not None else \
                    boxes[:, :, None, :].expand(b, n, c, 4)
                labels = obj_prediction_nms(bpc, out_obj, 0.5, valid_mask=box_mask)
        rel_logits = rel_logits + self.freq_bias(pair_classes(labels, pair_idx))
        return LegacyOutput(out_obj, rel_logits, labels)
