"""The scene-graph model, PredCls mode (``veto_tpu/models/sgg.py``).

Frozen ResNeXt-FPN detector body, trainable depth ResNet-18, multi-level
8x8 ROI pooling of the GT boxes (P2-P5) and of the depth map (1/16), and
the VETO relation predictor.  SGCls, SGDet, MEET and the legacy predictors
come in later slices and raise ``NotImplementedError`` here.

Training: the detector body is frozen (the JAX package's
``FROZEN_DETECTOR``, ``tools/relation_train_net.py:297``): its parameters
never require a gradient, it runs under ``torch.no_grad()`` (so autograd
keeps none of its activations, as ``stop_gradient`` does in JAX) and it
stays in eval mode when the model is put in train mode.  The depth
backbone and the predictor train.

Layout: NHWC images, (B, N) padded boxes, (B, P) padded pairs — the JAX
package's, so the two take the same batch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..ops.roi_align_windowed import multilevel_roi_align_batched
from .backbone.depth_resnet import DepthResNet18
from .backbone.resnet import ResNetFPNBackbone
from .relation.predictor_veto import VetoPredictor


class SGGForward(NamedTuple):
    rel_logits: torch.Tensor      # (B, P, num_rel) f32
    obj_dists: torch.Tensor       # (B, N, num_obj) f32
    pred_labels: torch.Tensor     # (B, N)
    predict_logits: torch.Tensor  # (B, N, num_obj) ±1000 GT injection


class SGGModel(nn.Module):
    def __init__(self, num_obj_classes: int = 151, num_rel_classes: int = 51,
                 mode: str = "predcls",
                 stage_blocks: Sequence[int] = (3, 4, 23, 3), groups: int = 32,
                 width_per_group: int = 8, stride_in_1x1: bool = False,
                 fpn_channels: int = 256, pooler_resolution: int = 8,
                 pooler_scales: Tuple[float, ...] = (0.25, 0.125, 0.0625, 0.03125),
                 pooler_sampling_ratio: int = 2, depth_scale: float = 0.0625,
                 veto_dim: int = 576, veto_layers: int = 6, veto_heads: int = 6,
                 veto_patch_size: int = 2, veto_depth_proj_dim: int = 512,
                 veto_visual_proj_dim: int = 64, embed_dim: int = 200,
                 fold_bn: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if mode != "predcls":
            raise NotImplementedError(
                f"mode {mode!r}: this port slice runs PredCls; SGCls and SGDet "
                "come in later slices")
        self.num_obj_classes = num_obj_classes
        self.pooler_resolution = pooler_resolution
        self.pooler_scales = tuple(pooler_scales)
        self.pooler_sampling_ratio = pooler_sampling_ratio
        self.depth_scale = depth_scale
        self.backbone = ResNetFPNBackbone(stage_blocks, groups, width_per_group,
                                          fpn_channels, fold_bn, stride_in_1x1,
                                          dtype)
        self.depth_backbone = DepthResNet18(dtype)
        self.relation = VetoPredictor(
            num_obj_classes, num_rel_classes, embed_dim, veto_dim, veto_layers,
            veto_heads, veto_patch_size, veto_depth_proj_dim,
            veto_visual_proj_dim, rgb_channels=fpn_channels, depth_channels=256,
            dtype=dtype)
        self.backbone.requires_grad_(False)

    def train(self, mode: bool = True) -> "SGGModel":
        super().train(mode)
        self.backbone.eval()  # the frozen detector never trains
        return self

    def extract_features(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Frozen FPN pyramid (P2..P6), NHWC, outside autograd."""
        with torch.no_grad():
            return self.backbone(images)

    def _pool_boxes(self, feats, boxes: torch.Tensor) -> torch.Tensor:
        levels = [f.contiguous() for f in feats[: len(self.pooler_scales)]]
        return multilevel_roi_align_batched(
            levels, boxes, self.pooler_scales, self.pooler_resolution,
            self.pooler_sampling_ratio)

    def relate(self, feats, depth, boxes, box_mask, obj_labels, pair_idx):
        depth_feat = self.depth_backbone(depth).contiguous()
        roi_feats = self._pool_boxes(feats, boxes)
        depth_roi = multilevel_roi_align_batched(
            [depth_feat], boxes, (self.depth_scale,), self.pooler_resolution,
            self.pooler_sampling_ratio)
        return self.relation(boxes, box_mask, obj_labels, pair_idx, roi_feats,
                             depth_roi)

    def forward(self, images, depth, boxes, box_mask, obj_labels, obj_logits,
                pair_idx, pair_mask) -> SGGForward:
        """The JAX ``SGGModel.__call__`` signature; ``obj_logits`` and
        ``pair_mask`` are unused in PredCls (padded pairs are masked later,
        in post-processing)."""
        feats = self.extract_features(images)
        # ±1000 GT-logit injection so eval softmax obj scores are exactly 1
        predict_logits = F.one_hot(obj_labels.long(),
                                   self.num_obj_classes).float() * 2000.0 - 1000.0
        out = self.relate(feats, depth, boxes, box_mask, obj_labels, pair_idx)
        return SGGForward(rel_logits=out.rel_logits, obj_dists=out.obj_dists,
                          pred_labels=obj_labels, predict_logits=predict_logits)


def build_model(cfg, device=None, seed: int = None) -> SGGModel:
    """SGGModel for a config, on ``device`` (default ``cuda``; raises when no
    GPU is present unless ``device="cpu"``), in eval mode, with weights
    drawn from ``seed`` (default ``cfg.solver.seed``)."""
    dev = resolve_device(device)
    if cfg.relation.mode != "predcls":
        raise NotImplementedError(
            f"mode {cfg.relation.mode!r}: SGCls and SGDet come in later slices")
    if cfg.relation.predictor != "VETOPredictor":
        raise NotImplementedError(
            f"predictor {cfg.relation.predictor!r}: this slice ports "
            "VETOPredictor only")
    if cfg.ensemble.enabled:
        raise NotImplementedError("MEET comes in a later slice")
    if not cfg.model.backbone.endswith("-FPN") or any(cfg.model.stage_with_dcn):
        raise NotImplementedError(
            f"backbone {cfg.model.backbone!r}: this slice ports the ResNet-FPN "
            "bodies without deformable convs")
    model = SGGModel(
        num_obj_classes=cfg.model.num_obj_classes,
        num_rel_classes=cfg.relation.num_classes,
        stage_blocks=cfg.model.stage_blocks, groups=cfg.model.resnet_groups,
        width_per_group=cfg.model.resnet_width_per_group,
        fpn_channels=cfg.model.fpn_channels,
        pooler_resolution=cfg.relation.pooler_resolution,
        pooler_scales=cfg.relation.pooler_scales,
        pooler_sampling_ratio=cfg.relation.pooler_sampling_ratio,
        veto_dim=cfg.veto.t_input_dim, veto_layers=cfg.veto.enc_layers,
        veto_heads=cfg.veto.nheads, veto_patch_size=cfg.veto.patch_size,
        veto_depth_proj_dim=cfg.veto.depth_proj_dim,
        veto_visual_proj_dim=cfg.veto.visual_proj_dim,
        fold_bn=cfg.model.fold_bn,
        dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
    ).to(dev)
    init_weights(model, cfg.solver.seed if seed is None else seed)
    return model.eval()


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """Seeded random weights, drawn on the model's device with one
    ``torch.Generator``: LeCun-normal matrices and conv kernels (fan-in
    over the kernel window and group), Xavier-uniform ``rel_out``, N(0, 1)
    CLS/position tokens, N(0, 1/embed_dim) embeddings, unit scales, zero
    biases and BN statistics of a unit normal."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("rel_out.weight"):
            bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            p.uniform_(-bound, bound, generator=gen)
        elif leaf in ("cls_token", "pos_embedding"):
            p.normal_(0.0, 1.0, generator=gen)
        elif name.endswith("obj_embed.weight"):
            p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
        elif p.dim() == 4:          # conv (O, I/G, kh, kw)
            p.normal_(0.0, (p[0].numel()) ** -0.5, generator=gen)
        elif p.dim() == 2:
            # Dense weights are (out, in); the encoder's matrices (in, out)
            fan_in = p.shape[0] if "fusion_transformer" in name else p.shape[1]
            p.normal_(0.0, fan_in ** -0.5, generator=gen)
        elif leaf == "weight" or leaf.endswith("_scale"):
            p.fill_(1.0)
        else:
            p.zero_()
    for name, buf in model.named_buffers():
        if name.endswith("running_var"):
            buf.fill_(1.0)
        elif name.endswith("running_mean"):
            buf.zero_()
