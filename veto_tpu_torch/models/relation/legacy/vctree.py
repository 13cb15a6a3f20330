"""VCTree (``veto_tpu/models/relation/legacy/vctree.py``): the dynamic-tree
context and its predictor.

The tree of each image is three index arrays (left child, right sibling,
parent) built greedily from the learned pair scores (:func:`build_vctree`:
Prim's maximum spanning tree from the node of best mean score, each
attachment coded in the left-child / right-sibling binary form).  The
TreeLSTMs run in rounds: a node fires once what it waits for is done (its
children leaves-to-root, its parent root-to-leaves), every ready node of
the batch updating in one masked step; N rounds cover any tree.  As in the
JAX package every image takes all N rounds, and each round is a few
batched products and elementwise launches driven from the host, as are
the N - 1 steps of the tree build; the JAX package runs them as XLA loops
outside any Pallas kernel.

The decoder of SGCls and SGDet (:class:`TreeLSTMBwd` with ``num_classes``)
feeds each node its parent's label embedding: at eval the argmax
foreground, at train one sampled with Gumbel noise.  The noise is an input
(``gumbel`` (B, N, C - 1)), drawn by the train step from its generator,
fresh every step; the JAX package draws it from keys split off
``PRNGKey(0)`` at every step (the same noise each step: ROADMAP queue C),
which a test feeds in to compare.

:class:`VCTreeContext` takes an optional ``forest``: the tree build is an
argmax over scores that one ulp can flip, so a comparison of two runs
(the kernels against the plain versions on the card) gives both the same
forest.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ....ops.box_ops import box_area, box_iou, encode_box_info
from ....ops.nms import first_argmax
from ...layers import BatchNorm1d, Dense
from ..freq_bias import FrequencyBias
from .context import soft_embed
from .predictors import LegacyOutput, MeetRelHeads, _PairHead, pair_classes


class BinaryForest(NamedTuple):
    left: torch.Tensor     # (B, N) int64 left child, -1 = none
    right: torch.Tensor    # (B, N) int64 right child (next sibling), -1 = none
    parent: torch.Tensor   # (B, N) int64 binary-tree parent, -1 = root / padding
    root: torch.Tensor     # (B,) int64 root node
    in_tree: torch.Tensor  # (B, N) bool node takes part (a valid proposal)


def _set_where(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
               cond: torch.Tensor) -> torch.Tensor:
    """``x`` (B, N) with ``x[b, idx[b]] = val[b]`` where ``cond[b]``."""
    cur = torch.gather(x, 1, idx[:, None])[:, 0]
    return x.scatter(1, idx[:, None], torch.where(cond, val, cur)[:, None])


def build_vctree(scores: torch.Tensor, mask: torch.Tensor) -> BinaryForest:
    """Greedy maximum-score spanning tree in binary form, batched: (B, N, N)
    scores, (B, N) mask.  The root is the node of highest mean score over
    the valid nodes; each of N - 1 steps attaches the best (tree node,
    outside node) edge (the first in row-major order among ties, as
    ``jnp.argmax``); a node's first child becomes its left child, each
    later child its previous child's right child."""
    b, n = mask.shape
    dev = scores.device
    neg = -1e9
    valid2 = mask[:, :, None] & mask[:, None, :]
    s = torch.where(valid2, scores, neg)
    mean = (torch.where(mask[:, None, :], scores, 0.0).sum(2)
            / torch.clamp(mask.sum(1, keepdim=True), min=1))
    node_scores = torch.where(mask, mean, neg)
    root = first_argmax(node_scores, torch.arange(n, device=dev).expand(b, n))
    ar = torch.arange(n * n, device=dev).expand(b, n * n)
    in_tree = F.one_hot(root, n).bool()
    left = torch.full((b, n), -1, dtype=torch.long, device=dev)
    right, parent, last_child = left.clone(), left.clone(), left.clone()
    for _ in range(n - 1):
        cand = in_tree[:, :, None] & ~in_tree[:, None, :] & valid2
        flat = torch.where(cand, s, neg).reshape(b, n * n)
        best = first_argmax(flat, ar)
        ok = torch.gather(flat, 1, best[:, None])[:, 0] > neg / 2
        u, v = best // n, best % n
        sib = torch.gather(last_child, 1, u[:, None])[:, 0]
        first = sib < 0
        left = _set_where(left, u, v, ok & first)
        right = _set_where(right, sib.clamp(min=0), v, ok & ~first)
        parent = _set_where(parent, v, torch.where(first, u, sib), ok)
        last_child = _set_where(last_child, u, v, ok)
        in_tree = _set_where(in_tree, v, torch.ones_like(ok), ok)
    return BinaryForest(left, right, parent, root, in_tree & mask)


def forest_differences(a: BinaryForest, b: BinaryForest) -> int:
    """Nodes whose left child, right child, parent or root differ."""
    roots = F.one_hot(a.root, a.left.shape[1]) != F.one_hot(b.root, b.left.shape[1])
    return int(((a.left != b.left) | (a.right != b.right) | (a.parent != b.parent)
                | roots).sum())


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per image the rows ``idx`` (B, N) of ``x`` (B, N, D), 0 where idx < 0."""
    got = torch.gather(x, 1, idx.clamp(min=0)[..., None].expand(-1, -1, x.shape[-1]))
    return torch.where((idx >= 0)[..., None], got, torch.zeros((), dtype=x.dtype,
                                                                device=x.device))


def _done_at(done: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(done, 1, idx.clamp(min=0))


class TreeLSTMFwd(nn.Module):
    """Leaves-to-root pass: ``ioffu = W_x x + W_l h_left + W_r h_right`` with
    forget-gate biases 1 for both children and a highway gate ``r`` mixing
    in the projected input.  (B, N, in_dim) → (B, N, h_dim)."""

    def __init__(self, in_dim: int, h_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.h_dim, self.dtype = h_dim, dtype
        self.px_w = nn.Parameter(torch.empty(in_dim, h_dim))
        self.px_b = nn.Parameter(torch.zeros(h_dim))
        self.ioffux_w = nn.Parameter(torch.empty(in_dim, 6 * h_dim))
        self.ioffux_b = nn.Parameter(torch.zeros(6 * h_dim))
        self.ioffuh_left_w = nn.Parameter(torch.empty(h_dim, 6 * h_dim))
        self.ioffuh_right_w = nn.Parameter(torch.empty(h_dim, 6 * h_dim))

    def forward(self, feats: torch.Tensor, forest: BinaryForest) -> torch.Tensor:
        cdt, h = self.dtype, self.h_dim
        b, n, _ = feats.shape
        fb = torch.zeros(6 * h, device=feats.device)
        fb[2 * h:4 * h] = 1.0
        x = feats.to(cdt)
        px = torch.matmul(x, self.px_w.to(cdt)) + self.px_b.to(cdt)
        gx = torch.matmul(x, self.ioffux_w.to(cdt)) + self.ioffux_b.to(cdt) + fb.to(cdt)
        w_l, w_r = self.ioffuh_left_w.to(cdt), self.ioffuh_right_w.to(cdt)
        lc, rc = forest.left, forest.right
        hs = torch.zeros((b, n, h), dtype=cdt, device=feats.device)
        cs = torch.zeros_like(hs)
        done = torch.zeros((b, n), dtype=torch.bool, device=feats.device)
        for _ in range(n):
            ready = (forest.in_tree & ~done & ((lc < 0) | _done_at(done, lc))
                     & ((rc < 0) | _done_at(done, rc)))
            hl, cl, hr, cr = _rows(hs, lc), _rows(cs, lc), _rows(hs, rc), _rows(cs, rc)
            g = gx + torch.matmul(hl, w_l) + torch.matmul(hr, w_r)
            i, o, fl, fr, u, r = g.chunk(6, dim=-1)
            c = (torch.sigmoid(i) * torch.tanh(u) + torch.sigmoid(fl) * cl
                 + torch.sigmoid(fr) * cr)
            hh = torch.sigmoid(o) * torch.tanh(c)
            hh = torch.sigmoid(r) * hh + (1 - torch.sigmoid(r)) * px
            m = ready[..., None]
            hs, cs, done = torch.where(m, hh, hs), torch.where(m, c, cs), done | ready
        return hs


class TreeLSTMBwd(nn.Module):
    """Root-to-leaves pass (``iofu``, forget-gate bias 1, highway gate).
    With ``num_classes`` it is the decoder: each node's input also takes its
    parent's label embedding (the 'start' row 0 for the root), and it
    returns (logits (B, N, C) f32, committed labels (B, N) int32: the argmax
    foreground); the embedding fed on is the committed label at eval, at
    train the argmax of the foreground log-probabilities plus ``gumbel``."""

    def __init__(self, in_dim: int, h_dim: int, num_classes: int = 0,
                 embed_dim: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.h_dim, self.dtype, self.num_classes = h_dim, dtype, num_classes
        self.in_dim = in_dim
        full = in_dim + (embed_dim if num_classes else 0)
        self.px_w = nn.Parameter(torch.empty(full, h_dim))
        self.px_b = nn.Parameter(torch.zeros(h_dim))
        self.iofux_w = nn.Parameter(torch.empty(full, 5 * h_dim))
        self.iofux_b = nn.Parameter(torch.zeros(5 * h_dim))
        self.iofuh_w = nn.Parameter(torch.empty(h_dim, 5 * h_dim))
        if num_classes:
            self.obj_embed = nn.Parameter(torch.empty(num_classes + 1, embed_dim))
            self.out_w = nn.Parameter(torch.empty(h_dim, num_classes))
            self.out_b = nn.Parameter(torch.zeros(num_classes))

    def forward(self, feats: torch.Tensor, forest: BinaryForest,
                gumbel: Optional[torch.Tensor] = None):
        cdt, h, d = self.dtype, self.h_dim, self.in_dim
        b, n, _ = feats.shape
        dev = feats.device
        decode = self.num_classes > 0
        fb = torch.zeros(5 * h, device=dev)
        fb[2 * h:3 * h] = 1.0
        x = feats.to(cdt)
        w_x, w_px = self.iofux_w.to(cdt), self.px_w.to(cdt)
        # the input's own products once; the parent embedding's each round
        gx = torch.matmul(x, w_x[:d]) + self.iofux_b.to(cdt) + fb.to(cdt)
        px = torch.matmul(x, w_px[:d]) + self.px_b.to(cdt)
        w_h = self.iofuh_w.to(cdt)
        p = forest.parent
        is_root = p < 0
        hs = torch.zeros((b, n, h), dtype=cdt, device=dev)
        cs = torch.zeros_like(hs)
        done = torch.zeros((b, n), dtype=torch.bool, device=dev)
        if decode:
            if self.training and gumbel is None:
                raise ValueError("VCTree's training decoder samples its feedback "
                                 "labels: pass its Gumbel noise (B, N, C - 1)")
            table = self.obj_embed.to(cdt)
            embeds = torch.zeros((b, n, table.shape[1]), dtype=cdt, device=dev)
            dists = torch.zeros((b, n, self.num_classes), device=dev)
            labels = torch.zeros((b, n), dtype=torch.long, device=dev)
            cls_idx = torch.arange(self.num_classes - 1, device=dev).expand(b, n, -1)
        for _ in range(n):
            ready = forest.in_tree & ~done & (is_root | _done_at(done, p))
            hp, cp = _rows(hs, p), _rows(cs, p)
            g, px_r = gx, px
            if decode:
                pe = torch.where(is_root[..., None], table[0], _rows(embeds, p))
                g = g + torch.matmul(pe, w_x[d:])
                px_r = px + torch.matmul(pe, w_px[d:])
            g = g + torch.matmul(hp, w_h)
            i, o, f, u, r = g.chunk(5, dim=-1)
            c = torch.sigmoid(i) * torch.tanh(u) + torch.sigmoid(f) * cp
            hh = torch.sigmoid(o) * torch.tanh(c)
            hh = torch.sigmoid(r) * hh + (1 - torch.sigmoid(r)) * px_r
            m = ready[..., None]
            hs, cs = torch.where(m, hh, hs), torch.where(m, c, cs)
            if decode:
                logit = torch.matmul(hh.float(), self.out_w) + self.out_b
                logp = torch.log_softmax(logit, -1)[..., 1:]
                commit = first_argmax(logp, cls_idx) + 1
                samp = (first_argmax(logp + gumbel, cls_idx) + 1 if self.training
                        else commit)
                embeds = torch.where(m, table[samp + 1], embeds)
                dists = torch.where(m, logit, dists)
                labels = torch.where(ready, commit, labels)
            done = done | ready
        if decode:
            return dists, labels.to(torch.int32)
        return hs


class MultiLayerBiTreeLSTM(nn.Module):
    """Stacked bidirectional TreeLSTM: per layer the two passes at
    ``out_dim / 2`` each, concatenated."""

    def __init__(self, in_dim: int, out_dim: int, num_layers: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        d = in_dim
        for layer in range(num_layers):
            self.add_module(f"fwd{layer}", TreeLSTMFwd(d, out_dim // 2, dtype))
            self.add_module(f"bwd{layer}", TreeLSTMBwd(d, out_dim // 2, dtype=dtype))
            d = out_dim

    def forward(self, feats: torch.Tensor, forest: BinaryForest) -> torch.Tensor:
        x = feats
        for layer in range(self.num_layers):
            x = torch.cat([getattr(self, f"fwd{layer}")(x, forest),
                           getattr(self, f"bwd{layer}")(x, forest)], -1)
        return x


def overlap_info(boxes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, N, 6) per-box overlap statistics over the valid boxes: the count
    of overlapping boxes, the summed intersection (over 1024^2), the summed
    IoU, their means over the count, and the box's own area (over 1024^2)."""
    im_scale2 = 1024.0 * 1024.0
    lt = torch.maximum(boxes[:, :, None, :2], boxes[:, None, :, :2])
    rb = torch.minimum(boxes[:, :, None, 2:], boxes[:, None, :, 2:])
    wh = torch.clamp(rb - lt + 1.0, min=0.0)
    valid2 = (mask[:, :, None] & mask[:, None, :]).float()
    inter = wh[..., 0] * wh[..., 1] * valid2
    iou = box_iou(boxes, boxes) * valid2
    i1 = (inter > 0).float().sum(2, keepdim=True)
    i2 = inter.sum(2, keepdim=True) / im_scale2
    i3 = iou.sum(2, keepdim=True)
    return torch.cat([i1, i2, i3, i2 / (i1 + 1e-9), i3 / (i1 + 1e-9),
                      box_area(boxes)[..., None] / im_scale2], -1)


class VCTreeContext(nn.Module):
    """The VCTree context: (obj_dists, obj_preds, edge_ctx (B, N, hidden),
    bi_preds (B, N, N) f32 pair scores before their sigmoid, the forest)."""

    def __init__(self, num_obj_classes: int = 151, embed_dim: int = 200,
                 hidden_dim: int = 512, in_dim: int = 4096, obj_layers: int = 1,
                 edge_layers: int = 1, mode: str = "predcls",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c, e, h = num_obj_classes, embed_dim, hidden_dim
        self.num_obj_classes, self.hidden_dim, self.mode, self.dtype = c, h, mode, dtype
        self.obj_embed1 = nn.Embedding(c, e)
        self.obj_embed2 = nn.Embedding(c, e)
        self.pos_fc1 = Dense(9, 32, dtype=dtype)
        self.pos_bn = BatchNorm1d(32, momentum=0.999)
        self.pos_fc2 = Dense(32, 128, dtype=dtype)
        self.box_fc = Dense(9, 128, dtype=dtype)
        self.box_bn = BatchNorm1d(128, momentum=0.999)
        self.overlap_fc = Dense(6, 128, dtype=dtype)
        self.overlap_bn = BatchNorm1d(128, momentum=0.999)
        self.obj_reduce = Dense(in_dim, 128, dtype=dtype)
        self.emb_reduce = Dense(e, 128, dtype=dtype)
        self.score_pre = Dense(512, h, dtype=dtype)
        self.score_sub = Dense(h, h, dtype=dtype)
        self.score_obj = Dense(h, h, dtype=dtype)
        self.bi_freq_prior = nn.Parameter(torch.empty(c, c))
        self.vision_prior = Dense(3 * h + 1, 1, dtype=torch.float32)
        self.obj_ctx_rnn = MultiLayerBiTreeLSTM(in_dim + e + 128, h, obj_layers, dtype)
        if mode != "predcls":
            self.decoder_rnn = TreeLSTMBwd(h + in_dim + e + 128, h, c, e, dtype)
        self.edge_ctx_rnn = MultiLayerBiTreeLSTM(e + in_dim + h, h, edge_layers, dtype)

    def pair_scores(self, x, obj_embed, binfo, boxes, box_mask, obj_logits_in):
        """The score net: (bi_preds (B, N, N) f32, the tree's scores)."""
        cdt, h = self.dtype, self.hidden_dim
        b, n = box_mask.shape
        box_emb = F.relu(self.box_bn(self.box_fc(binfo)))
        ov = overlap_info(boxes, box_mask).to(cdt)
        ov_emb = F.relu(self.overlap_bn(self.overlap_fc(ov)))
        bi_inp = torch.cat([self.obj_reduce(x.detach()),
                            self.emb_reduce(obj_embed.detach()), box_emb, ov_emb], -1)
        pre = F.relu(self.score_pre(bi_inp))
        sub, obj = F.relu(self.score_sub(pre)), F.relu(self.score_obj(pre))
        dist = torch.softmax(obj_logits_in.detach(), -1)
        co_prior = torch.einsum("bic,cd,bjd->bij", dist, self.bi_freq_prior.float(),
                                dist)
        sub_e, obj_e = sub[:, :, None, :], obj[:, None, :, :]
        pair_feat = torch.cat([(sub_e * obj_e).expand(b, n, n, h),
                               sub_e.expand(b, n, n, h), obj_e.expand(b, n, n, h),
                               co_prior[..., None].to(cdt)], -1)
        vis_prior = self.vision_prior(pair_feat)[..., 0]
        bi_preds = torch.sigmoid(vis_prior) * co_prior
        return bi_preds, torch.sigmoid(bi_preds)

    def forward(self, roi_features, boxes, box_mask, obj_labels, predict_logits,
                image_sizes, gumbel=None, forest: Optional[BinaryForest] = None):
        cdt = self.dtype
        if self.mode == "predcls":
            obj_embed = self.obj_embed1(obj_labels.long()).to(cdt)
            obj_logits_in = F.one_hot(obj_labels.long(), self.num_obj_classes).float()
        else:
            obj_logits_in = predict_logits.float()
            obj_embed = soft_embed(self.obj_embed1, obj_logits_in, cdt)
        binfo = encode_box_info(boxes, image_sizes).to(cdt)
        pos = F.relu(self.pos_fc2(self.pos_bn(self.pos_fc1(binfo))))
        x = roi_features.to(cdt)
        obj_pre = torch.cat([x, obj_embed, pos], -1)

        bi_preds, vc_scores = self.pair_scores(x, obj_embed, binfo, boxes, box_mask,
                                               obj_logits_in)
        if forest is None:
            forest = build_vctree(vc_scores, box_mask)
        obj_ctx = self.obj_ctx_rnn(obj_pre, forest)
        if self.mode == "predcls":
            obj_preds = obj_labels
            obj_dists = F.one_hot(obj_labels.long(), self.num_obj_classes).float()
        else:
            obj_dists, obj_preds = self.decoder_rnn(torch.cat([obj_pre, obj_ctx], -1),
                                                    forest, gumbel)
        edge_pre = torch.cat([self.obj_embed2(obj_preds.long()).to(cdt), x, obj_ctx], -1)
        edge_ctx = self.edge_ctx_rnn(edge_pre, forest)
        return obj_dists, obj_preds, edge_ctx, bi_preds, forest


class VCTreePredictor(_PairHead):
    """VCTree: the tree context, ReLU'd head / tail split, the pair rep
    gated by the union feature into ``ctx_compress``, plus the frequency
    bias; with MEET the group heads on the ungated pair rep.  Returns the
    ``binary_preds`` for the binary loss and the ``forest`` it ran on: the
    one it built, or the one passed in."""

    def __init__(self, num_obj_classes: int = 151, num_rel_classes: int = 51,
                 embed_dim: int = 200, hidden_dim: int = 512, pooling_dim: int = 4096,
                 in_channels: int = 4096, mode: str = "predcls",
                 meet_group_sizes: Optional[Sequence[int]] = None,
                 meet_experts: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__(hidden_dim, pooling_dim, dtype, relu_emb=True)
        self.dtype, self.num_obj_classes = dtype, num_obj_classes
        # the SGCls / SGDet decoder samples its training feedback labels
        self.samples_labels = mode != "predcls"
        self.context_layer = VCTreeContext(num_obj_classes, embed_dim, hidden_dim,
                                           in_channels, mode=mode, dtype=dtype)
        self.meet = meet_group_sizes is not None
        if self.meet:
            self.meet_heads = MeetRelHeads(pooling_dim, meet_group_sizes, meet_experts)
        else:
            self.ctx_compress = Dense(pooling_dim, num_rel_classes, dtype=torch.float32)
            self.freq_bias = FrequencyBias(num_obj_classes, num_rel_classes)

    def forward(self, boxes, box_mask, obj_labels, predict_logits, pair_idx,
                roi_features, union_features, image_sizes, boxes_per_cls=None,
                gumbel=None, forest: Optional[BinaryForest] = None) -> LegacyOutput:
        obj_dists, obj_preds, edge_ctx, bi_preds, forest = self.context_layer(
            roi_features, boxes, box_mask, obj_labels, predict_logits, image_sizes,
            gumbel, forest)
        prod_rep = self.post_cat(self.prod(edge_ctx, pair_idx))
        if self.meet:
            return LegacyOutput(obj_dists, None, obj_preds, bi_preds,
                                group_logits=self.meet_heads(prod_rep), forest=forest)
        ctx_dists = self.ctx_compress(prod_rep * union_features.to(self.dtype))
        rel_dists = ctx_dists + self.freq_bias(pair_classes(obj_preds, pair_idx))
        return LegacyOutput(obj_dists, rel_dists, obj_preds, bi_preds, forest=forest)
