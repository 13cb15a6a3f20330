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

The encoder has the JAX package's implementations (``encoder_impl``), over
the same parameters: ``fused`` (the fused layer, B1 with B2 or B5 on the
card), ``pair_attn`` (``VetoEncoder._xla_layer``: plain PyTorch
projections, LayerNorms and FFN around the pair-attention kernels B4a/B4b)
and ``xla`` (``_xla_layer`` in plain PyTorch alone).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...engine import distributed
from ...ops.box_ops import center_xywh, xyxy_to_xywh
from ...ops.fused_encoder import (
    EncoderLayerParams, _gelu_exact, _gelu_grad, _ln, fused_encoder_layer,
)
from ...ops.pair_attention import pair_attention_qkv
from ..layers import Dense

ENCODER_IMPLS = ("fused", "pair_attn", "xla")


def resolve_encoder_impl(impl: str) -> str:
    """``veto.encoder_impl`` → the encoder's implementation: ``auto`` is
    ``fused``, the port's main path; anything outside ``ENCODER_IMPLS``
    raises (the JAX package would run ``xla`` for a typo)."""
    impl = "fused" if impl == "auto" else impl
    if impl not in ENCODER_IMPLS:
        raise ValueError(f"veto.encoder_impl={impl!r}: expected auto or one "
                         f"of {ENCODER_IMPLS}")
    return impl


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
                     class_weights: Optional[torch.Tensor] = None,
                     dp=None) -> torch.Tensor:
    """Mean weighted cross-entropy over the valid entries (``mask``):
    ``sum(w_y nll) / max(sum(w_y), 1e-6)``, torch's
    ``CrossEntropyLoss(weight=w)``; labels of masked entries are ignored.
    Under data parallelism (``dp``) the denominator is the global batch's:
    this rank's share of the global loss."""
    safe = torch.where(mask, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    if class_weights is None:
        w = mask.float()
    else:
        w = torch.where(mask, class_weights[safe], 0.0)
    return (nll * w).sum() / torch.clamp(distributed.total(dp, w.sum()), min=1e-6)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over valid proposals (the reference's pos_embed BN(4)).

    Eval: the running statistics.  Training: the statistics of the valid
    rows only, in f32 (``cnt = max(sum(mask), 1)``, biased variance), and
    the running ones updated with momentum 0.001 (``0.999 running + 0.001
    batch``).  The normalization runs in the input's dtype, as in the JAX
    module.  Under data parallelism (``dp``, set by
    ``distributed.attach``) the statistics are the global batch's: the
    count and both sums are all-reduced, the gradient flowing back through
    the reductions.
    """

    dp = None

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
            if self.dp is None:
                cnt = torch.clamp(m.sum(), min=1.0)
                mean = (flat * m).sum(0) / cnt
                var = ((flat - mean).square() * m).sum(0) / cnt
            else:
                sums = self.dp.sum(torch.cat([(flat * m).sum(0), m.sum().reshape(1)]))
                cnt = torch.clamp(sums[-1], min=1.0)
                mean = sums[:-1] / cnt
                var = self.dp.sum(((flat - mean).square() * m).sum(0)) / cnt
            with torch.no_grad():
                k = self.momentum
                self.running_mean.copy_((1 - k) * self.running_mean + k * mean)
                self.running_var.copy_((1 - k) * self.running_var + k * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.to(dt)) * torch.rsqrt(var + self.eps).to(dt)
        return y * self.weight.to(dt) + self.bias.to(dt)


class _Gelu(torch.autograd.Function):
    """The rational-erf GELU on f32, keeping only its input for the
    backward (``Phi(z) + z phi(z)``, ``_gelu_grad``): autograd through
    ``_gelu_exact`` would keep a dozen f32 intermediates of f1's size per
    layer.  The analytic derivative differs from JAX's autodiff of the same
    formula by f32 rounding (~1e-7)."""

    @staticmethod
    def forward(ctx, z):
        ctx.save_for_backward(z)
        return _gelu_exact(z)

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        return g * _gelu_grad(z)


class VetoEncoder(nn.Module):
    """CLS + tokens + shared position embedding + PreNorm encoder layers.

    Parameters are declared flat, with the JAX names (``attn{i}_qkv``,
    ``ffn{i}_fc1``, ...), matrices (in, out), the same for every ``impl``
    (see :func:`resolve_encoder_impl`).  ``fused``: each layer runs
    :func:`fused_encoder_layer` on (pairs * 19, D) rows — the CUDA kernels
    on the card, their plain versions on the CPU.  ``pair_attn`` / ``xla``:
    each layer runs :meth:`_xla_layer`.  No token padding: the JAX package
    padded 19 → 20 only for the TPU compiler.
    """

    def __init__(self, dim: int = 576, layers: int = 6, heads: int = 6,
                 dtype: torch.dtype = torch.bfloat16, impl: str = "fused"):
        super().__init__()
        self.dim, self.layers, self.heads, self.dtype = dim, layers, heads, dtype
        self.impl = resolve_encoder_impl(impl)
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
        if self.impl != "fused":
            for i in range(self.layers):
                x = self._xla_layer(x, self.layer_params(i),
                                    fused_attn=self.impl == "pair_attn")
            return x[:, 0]
        t = x.shape[1]
        x = x.reshape(n * t, d).contiguous()
        for i in range(self.layers):
            x = fused_encoder_layer(x, self.layer_params(i), self.heads, t, t)
        return x.view(n, t, d)[:, 0]

    def _xla_layer(self, x: torch.Tensor, p: EncoderLayerParams,
                   fused_attn: bool = False) -> torch.Tensor:
        """One layer on x (n, t, D) in plain tensor ops that autograd
        differentiates, at the JAX ``_xla_layer``'s own rounding points (not
        the fused kernel's): qkv rounded to the compute dtype; the out- and
        FFN-projections rounded, then their f32 bias added and rounded
        again; GELU on f32.  Attention: :func:`pair_attention_qkv` (B4a/B4b
        on the card) when ``fused_attn``, else per head with f32 scores and
        softmax, the probabilities rounded, f32 sums rounded; no mask, all
        tokens are real."""
        cdt = self.dtype
        h1 = _ln(x, p.ln1_scale, p.ln1_bias).to(cdt)
        qkv = h1 @ p.w_qkv
        if fused_attn:
            att = pair_attention_qkv(qkv, self.heads)
        else:
            n, t, d3 = qkv.shape
            dh = d3 // 3 // self.heads
            q, k, v = (qkv.reshape(n, t, 3, self.heads, dh)
                       .permute(2, 0, 3, 1, 4).float().unbind(0))
            s = (q @ k.transpose(-1, -2)) * dh ** -0.5
            pr = torch.softmax(s, dim=-1).to(cdt).float()
            att = (pr @ v).to(cdt).transpose(1, 2).reshape(n, t, d3 // 3)
        x1 = x + (att @ p.w_out + p.b_out).to(cdt)
        h2 = _ln(x1, p.ln2_scale, p.ln2_bias).to(cdt)
        g = _Gelu.apply((h2 @ p.w1 + p.b1).float()).to(cdt)
        return x1 + (g @ p.w2 + p.b2).to(cdt)


class VetoTrunk(nn.Module):
    """Embeddings → pair tokens → fusion transformer → per-pair CLS feature.

    The class embedding: in PredCls, and in every mode with
    ``hard_label_embed`` (MEET's, which embeds the hard label: outside
    PredCls the predicted one), a lookup of the given label; otherwise the
    softmax of the box head's logits times the table,
    ``softmax(logits in f32)`` rounded to the compute dtype, then a product
    in that dtype, as the JAX trunk computes it (so ``obj_embed`` gets a
    dense gradient, not a gather's)."""

    def __init__(self, num_obj_classes: int = 151, embed_dim: int = 200,
                 dim: int = 576, layers: int = 6, heads: int = 6,
                 patch_size: int = 2, depth_proj_dim: int = 512,
                 visual_proj_dim: int = 64, rgb_channels: int = 256,
                 depth_channels: int = 256, dtype: torch.dtype = torch.bfloat16,
                 encoder_impl: str = "fused", mode: str = "predcls",
                 hard_label_embed: bool = False):
        super().__init__()
        self.dtype, self.patch_size, self.dim = dtype, patch_size, dim
        self.mode, self.hard_label_embed = mode, hard_label_embed
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
        self.fusion_transformer = VetoEncoder(dim, layers, heads, dtype,
                                              encoder_impl)

    def _patchify(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, H, W, C) → (B, N, H/ps * W/ps, ps*ps*C), (py, px, c) order."""
        b, n, h, w, c = x.shape
        ps = self.patch_size
        x = x.reshape(b, n, h // ps, ps, w // ps, ps, c).transpose(3, 4)
        return x.reshape(b, n, (h // ps) * (w // ps), ps * ps * c)

    def forward(self, boxes: torch.Tensor, box_mask: torch.Tensor,
                obj_labels: torch.Tensor, pair_idx: torch.Tensor,
                roi_features: torch.Tensor, depth_features: torch.Tensor,
                obj_logits: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, p = pair_idx.shape[:2]
        dt = self.dtype
        if self.mode == "predcls" or self.hard_label_embed:
            obj_embed = self.obj_embed.weight.to(dt)[obj_labels.long()]
        else:
            probs = torch.softmax(obj_logits.float(), dim=-1).to(dt)
            obj_embed = probs @ self.obj_embed.weight.to(dt)
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
    """Relation logits from proposals and pooled 8x8 RGB/depth maps.

    ``obj_dists`` is the one-hot of the labels it is given (the GT labels
    in PredCls, the NMS's predicted labels in SGCls), as in the JAX
    predictor: it carries no gradient."""

    def __init__(self, num_obj_classes: int = 151, num_rel_classes: int = 51,
                 embed_dim: int = 200, dim: int = 576, layers: int = 6,
                 heads: int = 6, patch_size: int = 2, depth_proj_dim: int = 512,
                 visual_proj_dim: int = 64, rgb_channels: int = 256,
                 depth_channels: int = 256, dtype: torch.dtype = torch.bfloat16,
                 encoder_impl: str = "fused", mode: str = "predcls"):
        super().__init__()
        self.num_obj_classes = num_obj_classes
        self.trunk = VetoTrunk(num_obj_classes, embed_dim, dim, layers, heads,
                               patch_size, depth_proj_dim, visual_proj_dim,
                               rgb_channels, depth_channels, dtype, encoder_impl,
                               mode)
        self.rel_out = Dense(dim, num_rel_classes, dtype=torch.float32)

    def forward(self, boxes, box_mask, obj_labels, pair_idx, roi_features,
                depth_features, obj_logits=None) -> VetoPredictorOutput:
        rel_feat = self.trunk(boxes, box_mask, obj_labels, pair_idx,
                              roi_features, depth_features, obj_logits)
        obj_dists = F.one_hot(obj_labels.long(), self.num_obj_classes).float()
        return VetoPredictorOutput(self.rel_out(rel_feat), obj_dists)
