"""The VETO relation predictor (``veto_tpu/models/relation/predictor_veto.py``).

Per-proposal embeddings (class embedding, BatchNorm'd center-xywh position
embedding), pair tokens and the 6-layer fusion transformer, then the
51-way ``rel_out`` classifier; and its training loss, the Rwt
beta-weighted cross-entropy (``beta_class_weights``, ``weighted_ce_loss``).

The JAX package's pair-factorized projections are kept as they are: every
projection is linear in the subject/object concatenation, so each PROPOSAL
is projected once through a subject and an object weight, and a pair's
token is the sum of its subject's and object's halves (plus one bias).
Gathers are plain indexing (the JAX one-hot matmuls select exactly one row,
so the values are identical).

Patchify order matters: pooled maps are NHWC (B, N, 8, 8, C) and each 2x2
patch flattens as (py, px, c) into ``ps*ps*C``, as in the JAX package;
another order would silently mix channels in ``proj_d_*``/``proj_v_*``.

The encoder's matrices are kept (in, out), the JAX layout, because the CUDA
layer kernel reads them so; every other matrix is a ``Dense`` (torch
``(out, in)``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.box_ops import center_xywh, xyxy_to_xywh
from ...ops.fused_encoder import EncoderLayerParams, fused_encoder_layer
from ..layers import Dense


def beta_class_weights(pred_counts, beta: float = 0.999) -> np.ndarray:
    """Rwt class-balanced weights (JAX ``beta_class_weights``):
    ``(1 - beta) / (1 - beta^count)`` per predicate class over the counts
    sorted descending (background first), normalized to sum to the number
    of classes."""
    counts = np.sort(np.asarray(pred_counts, dtype=np.float64))[::-1]
    w = (1.0 - beta) / (1.0 - np.power(beta, counts))
    w *= float(len(w)) / w.sum()
    return w.astype(np.float32)


def weighted_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor,
                     class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean weighted cross-entropy over the valid entries (``mask``):
    ``sum(w_y nll) / max(sum(w_y), 1e-6)``, torch's
    ``CrossEntropyLoss(weight=w)``; labels of masked entries are ignored."""
    safe = torch.where(mask, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    if class_weights is None:
        w = mask.float()
    else:
        w = torch.where(mask, class_weights[safe], 0.0)
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-6)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over valid proposals (the reference's pos_embed BN(4)).

    Eval: the running statistics.  Training: the statistics of the valid
    rows only, in f32 (``cnt = max(sum(mask), 1)``, biased variance), and
    the running ones updated with momentum 0.001 (``0.999 running + 0.001
    batch``).  The normalization runs in the input's dtype, as in the JAX
    module.
    """

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.001):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if self.training:
            m = mask.reshape(-1).float()[:, None]
            flat = x.reshape(-1, x.shape[-1]).float()
            cnt = torch.clamp(m.sum(), min=1.0)
            mean = (flat * m).sum(0) / cnt
            var = ((flat - mean).square() * m).sum(0) / cnt
            with torch.no_grad():
                k = self.momentum
                self.running_mean.copy_((1 - k) * self.running_mean + k * mean)
                self.running_var.copy_((1 - k) * self.running_var + k * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.to(dt)) * torch.rsqrt(var + self.eps).to(dt)
        return y * self.weight.to(dt) + self.bias.to(dt)


class VetoEncoder(nn.Module):
    """CLS + tokens + shared position embedding + PreNorm encoder layers.

    Parameters are declared flat, with the JAX names (``attn{i}_qkv``,
    ``ffn{i}_fc1``, ...), matrices (in, out).  Each layer runs
    :func:`fused_encoder_layer` on (pairs * 19, D) rows — the CUDA kernel
    on the card, its plain version on the CPU.  No token padding: the JAX
    package padded 19 → 20 only for the TPU compiler.
    """

    def __init__(self, dim: int = 576, layers: int = 6, heads: int = 6,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dim, self.layers, self.heads, self.dtype = dim, layers, heads, dtype
        d = dim
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1, d))
        shapes = {
            "attn_norm{}_scale": (d,), "attn_norm{}_bias": (d,),
            "attn{}_qkv": (d, 3 * d), "attn{}_out": (d, d),
            "attn{}_out_bias": (d,), "ffn_norm{}_scale": (d,),
            "ffn_norm{}_bias": (d,), "ffn{}_fc1": (d, 2 * d),
            "ffn{}_fc1_bias": (2 * d,), "ffn{}_fc2": (2 * d, d),
            "ffn{}_fc2_bias": (d,),
        }
        for i in range(layers):
            for fmt, shape in shapes.items():
                init = torch.ones if fmt.endswith("_scale") else torch.zeros
                self.register_parameter(fmt.format(i), nn.Parameter(init(shape)))

    def layer_params(self, i: int) -> EncoderLayerParams:
        """Layer ``i``'s parameters, matrices cast to the compute dtype."""
        g = lambda n: getattr(self, n.format(i))  # noqa: E731
        m = lambda n: g(n).to(self.dtype).contiguous()  # noqa: E731
        return EncoderLayerParams(
            ln1_scale=g("attn_norm{}_scale"), ln1_bias=g("attn_norm{}_bias"),
            w_qkv=m("attn{}_qkv"), w_out=m("attn{}_out"),
            b_out=g("attn{}_out_bias"), ln2_scale=g("ffn_norm{}_scale"),
            ln2_bias=g("ffn_norm{}_bias"), w1=m("ffn{}_fc1"),
            b1=g("ffn{}_fc1_bias"), w2=m("ffn{}_fc2"), b2=g("ffn{}_fc2_bias"))

    def forward(self, patch_tokens: torch.Tensor, loc_token: torch.Tensor,
                cls_token: torch.Tensor) -> torch.Tensor:
        n, d, dt = patch_tokens.shape[0], self.dim, self.dtype
        x = torch.cat([self.cls_token.to(dt).expand(n, 1, d), patch_tokens,
                       loc_token[:, None, :], cls_token[:, None, :]], dim=1)
        x = x + self.pos_embedding.to(dt)
        t = x.shape[1]
        x = x.reshape(n * t, d).contiguous()
        for i in range(self.layers):
            x = fused_encoder_layer(x, self.layer_params(i), self.heads, t, t)
        return x.view(n, t, d)[:, 0]


class VetoTrunk(nn.Module):
    """Embeddings → pair tokens → fusion transformer → per-pair CLS feature.
    PredCls only: the class embedding looks up the GT label."""

    def __init__(self, num_obj_classes: int = 151, embed_dim: int = 200,
                 dim: int = 576, layers: int = 6, heads: int = 6,
                 patch_size: int = 2, depth_proj_dim: int = 512,
                 visual_proj_dim: int = 64, rgb_channels: int = 256,
                 depth_channels: int = 256, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype, self.patch_size, self.dim = dtype, patch_size, dim
        pp = patch_size * patch_size
        self.obj_embed = nn.Embedding(num_obj_classes, embed_dim)
        self.pos_bn = MaskedBatchNorm(4)
        self.pos_fc = Dense(4, 128, dtype=dtype)
        self.loc_proj_subj = Dense(128, dim, bias=False, dtype=dtype)
        self.loc_proj_obj = Dense(128, dim, bias=False, dtype=dtype)
        self.loc_proj_bias = nn.Parameter(torch.zeros(dim))
        self.class_proj_subj = Dense(embed_dim, dim, bias=False, dtype=dtype)
        self.class_proj_obj = Dense(embed_dim, dim, bias=False, dtype=dtype)
        self.class_proj_bias = nn.Parameter(torch.zeros(dim))
        self.proj_d_subj = Dense(pp * depth_channels, depth_proj_dim, bias=False,
                                 dtype=dtype)
        self.proj_d_obj = Dense(pp * depth_channels, depth_proj_dim, bias=False,
                                dtype=dtype)
        self.proj_d_bias = nn.Parameter(torch.zeros(depth_proj_dim))
        self.proj_v_subj = Dense(pp * rgb_channels, visual_proj_dim, bias=False,
                                 dtype=dtype)
        self.proj_v_obj = Dense(pp * rgb_channels, visual_proj_dim, bias=False,
                                dtype=dtype)
        self.proj_v_bias = nn.Parameter(torch.zeros(visual_proj_dim))
        self.fusion_transformer = VetoEncoder(dim, layers, heads, dtype)

    def _patchify(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, H, W, C) → (B, N, H/ps * W/ps, ps*ps*C), (py, px, c) order."""
        b, n, h, w, c = x.shape
        ps = self.patch_size
        x = x.reshape(b, n, h // ps, ps, w // ps, ps, c).transpose(3, 4)
        return x.reshape(b, n, (h // ps) * (w // ps), ps * ps * c)

    def forward(self, boxes: torch.Tensor, box_mask: torch.Tensor,
                obj_labels: torch.Tensor, pair_idx: torch.Tensor,
                roi_features: torch.Tensor,
                depth_features: torch.Tensor) -> torch.Tensor:
        b, p = pair_idx.shape[:2]
        dt = self.dtype
        obj_embed = self.obj_embed.weight.to(dt)[obj_labels.long()]
        pos = self.pos_bn(center_xywh(xyxy_to_xywh(boxes)).to(dt), box_mask)
        pos = F.relu(self.pos_fc(pos))                                # (B, N, 128)
        vis = self._patchify(roi_features.to(dt))
        dep = self._patchify(depth_features.to(dt))

        rows = torch.arange(b, device=pair_idx.device)[:, None]
        si, oi = pair_idx[..., 0].long(), pair_idx[..., 1].long()

        def gso(subj: Dense, obj: Dense, x: torch.Tensor) -> torch.Tensor:
            return subj(x)[rows, si] + obj(x)[rows, oi]

        loc_tok = F.relu(gso(self.loc_proj_subj, self.loc_proj_obj, pos)
                         + self.loc_proj_bias.to(dt))
        cls_tok = F.relu(gso(self.class_proj_subj, self.class_proj_obj, obj_embed)
                         + self.class_proj_bias.to(dt))
        patch_tok = torch.cat([
            gso(self.proj_d_subj, self.proj_d_obj, dep) + self.proj_d_bias.to(dt),
            gso(self.proj_v_subj, self.proj_v_obj, vis) + self.proj_v_bias.to(dt),
        ], dim=-1)                                                    # (B, P, 16, D)
        cls = self.fusion_transformer(
            patch_tok.reshape(b * p, -1, self.dim),
            loc_tok.reshape(b * p, self.dim), cls_tok.reshape(b * p, self.dim))
        return cls.reshape(b, p, self.dim)


class VetoPredictorOutput(NamedTuple):
    rel_logits: torch.Tensor  # (B, P, num_rel) f32
    obj_dists: torch.Tensor   # (B, N, num_obj) one-hot f32


class VetoPredictor(nn.Module):
    """Relation logits from proposals and pooled 8x8 RGB/depth maps."""

    def __init__(self, num_obj_classes: int = 151, num_rel_classes: int = 51,
                 embed_dim: int = 200, dim: int = 576, layers: int = 6,
                 heads: int = 6, patch_size: int = 2, depth_proj_dim: int = 512,
                 visual_proj_dim: int = 64, rgb_channels: int = 256,
                 depth_channels: int = 256, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_obj_classes = num_obj_classes
        self.trunk = VetoTrunk(num_obj_classes, embed_dim, dim, layers, heads,
                               patch_size, depth_proj_dim, visual_proj_dim,
                               rgb_channels, depth_channels, dtype)
        self.rel_out = Dense(dim, num_rel_classes, dtype=torch.float32)

    def forward(self, boxes, box_mask, obj_labels, pair_idx, roi_features,
                depth_features) -> VetoPredictorOutput:
        rel_feat = self.trunk(boxes, box_mask, obj_labels, pair_idx,
                              roi_features, depth_features)
        obj_dists = F.one_hot(obj_labels.long(), self.num_obj_classes).float()
        return VetoPredictorOutput(self.rel_out(rel_feat), obj_dists)
