"""The scene-graph model, all three task modes (``veto_tpu/models/sgg.py``).

Frozen ResNeXt-FPN detector body, trainable depth ResNet-18, multi-level
8x8 ROI pooling of the GT boxes (P2-P5) and of the depth map (1/16), and
the VETO relation predictor.

The detector body may instead be the legacy single-scale VGG-16
(``backbone_type="VGG-16"``, ``backbone/vgg.py``): one 512-channel map at
1/16, which the JAX tool pairs with the non-FPN geometry that
:func:`build_model` derives as it does (every anchor size on the one
stride-16 grid, so ``len(ratios) * len(sizes)`` anchors a position; one
pooler scale, 1/16, so every box pools from that map, one B3 launch as
on P2-P5).  Every width that reads the FPN's channels reads the body's
512 then: the RPN conv, the box head's fc6, the VETO trunk's RGB
projections, the legacy heads' box and union MLPs.

The mode sets the object labels and logits the predictor sees:

  * ``predcls``: the GT labels, and ±1000 one-hot logits for the
    post-processor;
  * ``sgcls``: the frozen box head (its own 7x7 multi-level pool of the GT
    boxes, fc6/fc7 and ``cls_score``) gives the logits, and
    ``obj_prediction_nms`` over the boxes tiled across classes (IoU 0.5)
    the labels;
  * ``sgdet``: no GT boxes.  :meth:`SGGModel.detect` runs the whole frozen
    cascade (body → RPN head → proposals → box head → box post-processing:
    80 padded detections with their ``boxes_per_cls``), and
    :meth:`SGGModel.relate` the relation head over the detections, with
    the detections' labels and the box head's logits (the soft class
    embedding).  Pairs are built or sampled outside the model
    (``engine/``).  ``detect`` is a chain of stage methods
    (:meth:`~SGGModel.rpn_maps`, :meth:`~SGGModel.propose`,
    :meth:`~SGGModel.box_head`, :meth:`~SGGModel.postprocess_boxes`), each
    callable on its own.

With ``meet_group_sizes`` the relation head is MEET's
(:class:`~.relation.predictor_meet.MeetPredictor`: the trunk embedding the
hard labels, G per-group heads per expert), and the nested per-expert,
per-group logits ride in :class:`SGGForward`'s ``rel_logits`` slot, as in
the JAX package.

The legacy predictors (``predictor`` one of :data:`LEGACY_PORTED`: Motifs,
VCTree, Transformer, TransLike, with ``meet_group_sizes`` their MEET
heads; IMP, BGNN, GPSNet, MSDN, BGNN and MSDN with the
relation-confidence pre-classifier under ``bgnn_rel_aware``) take the JAX
package's legacy route through the model: no depth backbone; the boxes
pooled 7x7 on P2-P5 into a trainable copy of the box MLP
(``rel_box_extractor``, ``context_pooling_dim`` wide), the pairs' union
boxes pooled 7x7 into the union features (``union_extractor``), so two B3
launches a forward (three in SGCls, with the box head's own pool);
the predictor gets the GT labels (teacher-forced by the Motifs decoder in
training) and the proposals' logits, and refines the object labels
itself (IMP also embeds ``pred_labels``: in SGCls the box head's NMS
labels, in SGDet the detections').  :class:`SGGForward` then carries the
predictor's refined ``obj_dists`` and labels, VCTree's ``binary_preds``
and the relness pre-classifier's ``relness_logits``.  Image sizes
default to the padded input's, as in the JAX model; SGDet passes the
true ones and the detections' ``boxes_per_cls``.  The other legacy names
raise ``NotImplementedError`` (:func:`resolve_predictor`).

Training: the detector is frozen (the JAX package's ``FROZEN_DETECTOR``,
``tools/relation_train_net.py:297``), the RPN and box head included: its
parameters never require a gradient, it runs under ``torch.no_grad()`` (so
autograd keeps none of its activations, as ``stop_gradient`` does in JAX)
and it stays in eval mode when the model is put in train mode.  The depth
backbone and the predictor train.

Detector pretraining (``train_detector=True``, ``engine/pretrain.py``): the
RPN and the box head are built in every mode, as the JAX model always has
them, nothing is frozen, and :meth:`SGGModel.detector_forward` and
:meth:`SGGModel.box_forward` run the body, the RPN head and the box head
inside autograd (the JAX package's methods of those names, without
``stop_gradient``); the box pool's gradient reaches P2-P5 through the
ROIAlign backward.

The detector's other heads, built as the JAX model builds them:

  * ``attribute_on``: :class:`~.detector.attribute_head.AttributePredictor`
    over the box head's fc7 features of the GT boxes
    (:meth:`SGGModel.attribute_forward`: the box head's own 7x7 pool, one
    more B3 launch, and the frozen fc6/fc7, so no gradient reaches the
    maps); the forward's ``attribute_logits``.  The box head's fc6/fc7 are
    built for it in every mode, frozen in relation training as the JAX
    package freezes them; ``att_score`` trains.
  * ``mask_on`` and ``keypoint_on``: the mask and keypoint heads
    (:meth:`SGGModel.mask_forward`, :meth:`SGGModel.keypoint_forward`),
    each with its own 14x14 pool of the rois on P2-P5 (a B3 launch each,
    whose backward B3-bwd takes their gradient into the maps), trained in
    detector pretraining (``engine/pretrain.py``).

Layout: NHWC images, (B, N) padded boxes, (B, P) padded pairs — the JAX
package's, so the two take the same batch.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..ops.nms import obj_prediction_nms
from ..ops.roi_align_windowed import multilevel_roi_align_batched
from .backbone.depth_resnet import DepthResNet18
from .backbone.resnet import ResNetFPNBackbone
from .backbone.vgg import OUT_CHANNELS as VGG_CHANNELS
from .backbone.vgg import VGG16Body
from .detector.attribute_head import AttributePredictor
from .detector.box_head import (
    BoxFeatureExtractor, BoxPredictor, Detections, box_postprocess,
    decode_candidates,
)
from .detector.keypoint_head import KeypointFeatureExtractor, KeypointPredictor
from .detector.mask_head import MaskFeatureExtractor, MaskPredictor
from .detector.rpn import (
    Proposals, RPNHead, flatten_level, level_anchors, rpn_select_proposals,
)
from .relation.legacy import MEET_CAPABLE, REL_AWARE
from .relation.legacy import PREDICTORS as LEGACY_PORTED
from .relation.legacy.bgnn import SCALING_WEIGHT
from .relation.predictor_meet import MeetPredictor
from .relation.predictor_veto import VetoPredictor
from .relation.union_features import UnionFeatureExtractor

MODES = ("predcls", "sgcls", "sgdet")
# the JAX model's legacy predictors (``SGGModel.LEGACY_PREDICTORS``) and,
# for those still missing, the slice of the port that brings each
LEGACY_PREDICTORS = ("TransformerPredictor", "TransLikePredictor", "IMPPredictor",
                     "MotifPredictor", "VCTreePredictor", "BGNNPredictor",
                     "GPSNetPredictor", "MSDNPredictor", "CausalAnalysisPredictor",
                     "KERNPredictor", "NaivePredictor", "RelatednessTestPredictor",
                     "AGRCNNPredictor")
_KERN_ETC = "the slice of KERN, AGRCNN, Naive and RelatednessTest"
_LEGACY_TO_COME = {
    "CausalAnalysisPredictor": "the CausalPredictor slice "
                               "(LSTMContext.effect_analysis)",
    "KERNPredictor": _KERN_ETC, "AGRCNNPredictor": _KERN_ETC,
    "NaivePredictor": _KERN_ETC, "RelatednessTestPredictor": _KERN_ETC,
}


def check_mode(mode: str) -> None:
    """Raise ``ValueError`` for a name that is not a task mode."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")


class SGGForward(NamedTuple):
    rel_logits: torch.Tensor      # (B, P, num_rel) f32; MEET: [e][k] (B, P, gs + 2)
    obj_dists: torch.Tensor       # (B, N, num_obj) f32
    pred_labels: torch.Tensor     # (B, N)
    predict_logits: torch.Tensor  # (B, N, num_obj) ±1000 GT injection
    # (B, N, num_attributes) f32 with ``attribute_on``, else None
    attribute_logits: Optional[torch.Tensor] = None
    # (B, N, N) f32 VCTree pair-relatedness logits, else None
    binary_preds: Optional[torch.Tensor] = None
    # VCTree: the forest its contexts ran on, else None
    forest: Optional[object] = None
    # (B, P, C) f32 relness pre-classifier logits (BGNN / MSDN with
    # rel_aware), else None
    relness_logits: Optional[torch.Tensor] = None


class DetectOutput(NamedTuple):
    features: Tuple[torch.Tensor, ...]  # the FPN maps, NHWC
    detections: Detections              # (B, D, ...) fields
    predict_logits: torch.Tensor        # (B, D, num_obj) f32 box-head logits


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
                 fold_bn: bool = True, dtype: torch.dtype = torch.bfloat16,
                 veto_encoder_impl: str = "fused",
                 box_pooler_resolution: int = 7, box_mlp_dim: int = 4096,
                 anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512),
                 anchor_strides: Tuple[int, ...] = (4, 8, 16, 32, 64),
                 aspect_ratios: Tuple[float, ...] = (0.23232838, 0.63365731,
                                                     1.28478321, 3.15089189),
                 rpn_pre_nms_top_n: int = 6000, rpn_post_nms_top_n: int = 1000,
                 rpn_nms_thresh: float = 0.7, rpn_fpn_post_nms_top_n: int = 1000,
                 rpn_min_size: float = 0.0, box_score_thresh: float = 0.01,
                 box_nms_thresh: float = 0.3, box_post_nms_per_cls_topn: int = 300,
                 nms_filter_duplicates: bool = True, detections_per_img: int = 80,
                 meet_group_sizes: Optional[Sequence[int]] = None,
                 meet_experts: int = 1, train_detector: bool = False,
                 attribute_on: bool = False, num_attributes: int = 201,
                 mask_on: bool = False,
                 mask_conv_layers: Sequence[int] = (256, 256, 256, 256),
                 mask_pooler_resolution: int = 14, keypoint_on: bool = False,
                 num_keypoints: int = 17,
                 keypoint_conv_layers: Sequence[int] = (512,) * 8,
                 keypoint_pooler_resolution: int = 14,
                 predictor: str = "VETOPredictor", context_hidden_dim: int = 512,
                 context_pooling_dim: int = 4096, backbone_type: str = "R-101-FPN",
                 bgnn_rel_aware: bool = False, bgnn_mp_valid_pairs: int = 200):
        super().__init__()
        check_mode(mode)
        if resolve_predictor(predictor) != predictor:
            raise ValueError(f"predictor {predictor!r}: give the base name "
                             f"{resolve_predictor(predictor)!r}")
        self.mode = mode
        self.predictor = predictor
        self.legacy = predictor in LEGACY_PORTED
        self.num_obj_classes, self.num_rel_classes = num_obj_classes, num_rel_classes
        self.anchor_sizes = tuple(anchor_sizes)
        self.anchor_strides = tuple(anchor_strides)
        self.aspect_ratios = tuple(aspect_ratios)
        self.rpn_cfg = dict(pre_nms_top_n=rpn_pre_nms_top_n,
                            post_nms_top_n=rpn_post_nms_top_n,
                            nms_thresh=rpn_nms_thresh,
                            fpn_post_nms_top_n=rpn_fpn_post_nms_top_n,
                            min_size=rpn_min_size)
        self.box_cfg = dict(score_thresh=box_score_thresh,
                            nms_thresh=box_nms_thresh,
                            post_nms_per_cls_topn=box_post_nms_per_cls_topn,
                            nms_filter_duplicates=nms_filter_duplicates,
                            detections_per_img=detections_per_img)
        self._anchors: Dict[tuple, list] = {}
        self.box_pooler_resolution = box_pooler_resolution
        self.pooler_resolution = pooler_resolution
        self.pooler_scales = tuple(pooler_scales)
        self.pooler_sampling_ratio = pooler_sampling_ratio
        self.depth_scale = depth_scale
        if backbone_type == "VGG-16":
            self.backbone = VGG16Body(dtype)
            channels = VGG_CHANNELS  # the single level's
        else:
            self.backbone = ResNetFPNBackbone(stage_blocks, groups, width_per_group,
                                              fpn_channels, fold_bn, stride_in_1x1,
                                              dtype)
            channels = fpn_channels
        if not self.legacy:  # the legacy route reads no depth
            self.depth_backbone = DepthResNet18(dtype)
        self.frozen = [self.backbone]
        if mode == "sgdet" or train_detector:
            # FPN: one size a level, so len(ratios) anchors a position; a
            # single level takes every size: len(ratios) * len(sizes)
            sz = self.anchor_sizes[0]
            sizes = len(sz) if isinstance(sz, (tuple, list)) else 1
            self.rpn = RPNHead(channels, 256, len(self.aspect_ratios) * sizes)
            self.frozen.append(self.rpn)
        box_head = mode in ("sgcls", "sgdet") or train_detector
        if box_head or attribute_on:  # the attribute head reads fc7
            self.box_extractor = BoxFeatureExtractor(
                box_pooler_resolution ** 2 * channels, box_mlp_dim, dtype)
            self.frozen.append(self.box_extractor)
        if box_head:
            self.box_predictor = BoxPredictor(box_mlp_dim, num_obj_classes)
            self.frozen.append(self.box_predictor)
        self.attribute_on, self.mask_on, self.keypoint_on = (
            attribute_on, mask_on, keypoint_on)
        if attribute_on:
            self.attribute_predictor = AttributePredictor(box_mlp_dim,
                                                          num_attributes, dtype)
        if mask_on:
            self.mask_pooler_resolution = mask_pooler_resolution
            self.mask_extractor = MaskFeatureExtractor(
                channels, mask_conv_layers, dtype=dtype)
            self.mask_predictor = MaskPredictor(
                mask_conv_layers[-1], num_obj_classes, mask_conv_layers[-1], dtype)
        if keypoint_on:
            self.keypoint_pooler_resolution = keypoint_pooler_resolution
            self.keypoint_extractor = KeypointFeatureExtractor(
                channels, keypoint_conv_layers, dtype)
            self.keypoint_predictor = KeypointPredictor(
                keypoint_conv_layers[-1], num_keypoints, dtype)
        if train_detector:
            self.frozen = []
        trunk = dict(embed_dim=embed_dim, dim=veto_dim, layers=veto_layers,
                     heads=veto_heads, patch_size=veto_patch_size,
                     depth_proj_dim=veto_depth_proj_dim,
                     visual_proj_dim=veto_visual_proj_dim,
                     rgb_channels=channels, depth_channels=256, dtype=dtype,
                     encoder_impl=veto_encoder_impl, mode=mode)
        if self.legacy:
            extra = {}
            if meet_group_sizes is not None:
                if predictor not in MEET_CAPABLE:
                    raise ValueError(f"predictor {predictor!r} has no MEET heads (in "
                                     f"either package): those of {MEET_CAPABLE} do")
                extra = dict(meet_group_sizes=meet_group_sizes, meet_experts=meet_experts)
            if predictor in REL_AWARE:
                extra = dict(rel_aware=bgnn_rel_aware, mp_valid_pairs=bgnn_mp_valid_pairs)
            self.relation = LEGACY_PORTED[predictor](
                num_obj_classes=num_obj_classes, num_rel_classes=num_rel_classes,
                hidden_dim=context_hidden_dim, pooling_dim=context_pooling_dim,
                in_channels=context_pooling_dim, mode=mode, dtype=dtype, **extra)
            # the trainable relation copy of the box MLP, and the union features
            self.rel_box_extractor = BoxFeatureExtractor(
                box_pooler_resolution ** 2 * channels, context_pooling_dim, dtype)
            self.union_extractor = UnionFeatureExtractor(
                box_pooler_resolution, self.pooler_scales, pooler_sampling_ratio,
                context_pooling_dim, channels, dtype)
        elif meet_group_sizes is not None:
            self.relation = MeetPredictor(meet_group_sizes, meet_experts,
                                          num_obj_classes, **trunk)
        else:
            self.relation = VetoPredictor(num_obj_classes, num_rel_classes,
                                          **trunk)
        for m in self.frozen:
            m.requires_grad_(False)

    def train(self, mode: bool = True) -> "SGGModel":
        super().train(mode)
        for m in self.frozen:  # the frozen detector never trains
            m.eval()
        return self

    def extract_features(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Frozen FPN pyramid (P2..P6), NHWC, outside autograd (VGG-16: its
        one 1/16 map)."""
        with torch.no_grad():
            return self.backbone(images)

    def _pool_boxes(self, feats, boxes: torch.Tensor,
                    resolution: int) -> torch.Tensor:
        """Multi-level P x P pooling of the boxes on P2-P5 (one B3 launch
        on the card); with one pooler scale (VGG-16) every box pools from
        the one map, as the JAX model's single-level ``roi_align``."""
        levels = [f.contiguous() for f in feats[: len(self.pooler_scales)]]
        return multilevel_roi_align_batched(
            levels, boxes, self.pooler_scales, resolution,
            self.pooler_sampling_ratio)

    def _box_logits(self, feats, boxes: torch.Tensor) -> torch.Tensor:
        """The frozen box head's f32 class logits (B, N, num_obj): its own
        7x7 pool, fc6/fc7 and ``cls_score``, outside autograd.  SGCls never
        decodes the box deltas (the JAX step drops them, and XLA never
        computes what is dropped), so ``bbox_pred`` is not run here."""
        with torch.no_grad():
            pooled = self._pool_boxes(feats, boxes, self.box_pooler_resolution)
            return self.box_predictor.cls_score(self.box_extractor(pooled))

    def _predict_labels(self, boxes, logits, box_mask) -> torch.Tensor:
        """SGCls labels: ``obj_prediction_nms`` over the boxes tiled across
        the classes, at IoU 0.5 (the reference's ``add_predict_info``)."""
        b, n = boxes.shape[:2]
        tiled = boxes[:, :, None, :].expand(b, n, self.num_obj_classes, 4)
        return obj_prediction_nms(tiled, logits, 0.5, valid_mask=box_mask)

    # ------------------------------------------------ the SGDet cascade
    def anchors(self, map_sizes, device) -> list:
        """Per-level anchors for maps of ``map_sizes`` ((H_l, W_l) per level,
        ``ceil(H / stride_l)`` of the padded image), made once per size."""
        key = (tuple(tuple(int(v) for v in hw) for hw in map_sizes), str(device))
        if key not in self._anchors:
            self._anchors[key] = level_anchors(
                key[0], self.anchor_sizes, self.anchor_strides,
                self.aspect_ratios, device)
        return self._anchors[key]

    def rpn_maps(self, feats):
        """The RPN head on every FPN level, its maps cast to f32: NHWC
        (B, H, W, A) objectness and (B, H, W, 4A) deltas per level."""
        with torch.no_grad():
            obj, reg = self.rpn(feats)
        return (tuple(m.float() for m in obj), tuple(m.float() for m in reg))

    def propose(self, obj_maps, reg_maps, image_sizes: torch.Tensor) -> Proposals:
        """The RPN's proposals of every image from its maps; ``image_sizes``
        (B, 2) = (w, h) before padding."""
        anchors = self.anchors([m.shape[1:3] for m in obj_maps],
                               obj_maps[0].device)
        flat = [flatten_level(o, r) for o, r in zip(obj_maps, reg_maps)]
        return rpn_select_proposals([f[0] for f in flat], [f[1] for f in flat],
                                    anchors, image_sizes.float(), **self.rpn_cfg)

    def box_head(self, feats, boxes: torch.Tensor):
        """The frozen box head on (B, P, 4) rois: f32 class logits (B, P, C)
        and box deltas (B, P, 4C), outside autograd."""
        with torch.no_grad():
            pooled = self._pool_boxes(feats, boxes, self.box_pooler_resolution)
            return self.box_predictor(self.box_extractor(pooled))

    def postprocess_boxes(self, logits, deltas, proposals: Proposals,
                          image_sizes: torch.Tensor) -> Detections:
        """Decode, per-class NMS and the duplicate filter: the detections."""
        return box_postprocess(logits, deltas, proposals.boxes, proposals.mask,
                               image_sizes.float(), **self.box_cfg)

    def _cascade(self, images: torch.Tensor, image_sizes: torch.Tensor):
        """The cascade up to the box filter, outside autograd: the FPN maps,
        the proposals and the box head's logits and deltas on them."""
        with torch.no_grad():
            feats = self.extract_features(images)
            obj, reg = self.rpn_maps(feats)
            proposals = self.propose(obj, reg, image_sizes)
            logits, deltas = self.box_head(feats, proposals.boxes)
            return feats, proposals, logits, deltas

    def detect_candidates(self, images: torch.Tensor, image_sizes: torch.Tensor):
        """The detection candidates before the box filter, for the test-time
        augmentation (``engine/bbox_aug.py``): the FPN maps, every
        proposal's softmax scores (B, P, C), its clipped per-class boxes
        (B, P, C, 4) and the proposal mask (B, P), outside autograd."""
        feats, proposals, logits, deltas = self._cascade(images, image_sizes)
        with torch.no_grad():
            prob, boxes_per_cls = decode_candidates(logits, deltas, proposals.boxes,
                                                    image_sizes.float())
        return feats, prob, boxes_per_cls, proposals.mask

    # ------------------------------------------------ detector pretraining
    def detector_forward(self, images: torch.Tensor):
        """The trainable FPN pyramid (P2..P6) and the RPN head's raw maps
        in the model's dtype, inside autograd."""
        feats = self.backbone(images)
        obj, reg = self.rpn(feats)
        return feats, obj, reg

    def box_forward(self, feats, rois: torch.Tensor):
        """The trainable box head on (B, R, 4) rois: f32 class logits
        (B, R, C) and deltas (B, R, 4C), inside autograd (the 7x7 pool's
        gradient reaches the maps through the ROIAlign backward)."""
        pooled = self._pool_boxes(feats, rois, self.box_pooler_resolution)
        logits, deltas = self.box_predictor(self.box_extractor(pooled))
        return logits.float(), deltas.float()

    def _roi_head(self, feats, rois: torch.Tensor, resolution: int,
                  extractor, predictor) -> torch.Tensor:
        """(B, R, 4) rois → the head's (B, R, ...) output from its own
        ``resolution`` pool (one B3 launch), inside autograd."""
        pooled = self._pool_boxes(feats, rois, resolution)
        b, r = pooled.shape[:2]
        out = predictor(extractor(pooled.reshape((b * r,) + pooled.shape[2:])))
        return out.reshape((b, r) + out.shape[1:])

    def mask_forward(self, feats, rois: torch.Tensor) -> torch.Tensor:
        """The mask head on (B, R, 4) rois: (B, R, 2M, 2M, num_obj) f32
        logits (M = ``mask_pooler_resolution``)."""
        return self._roi_head(feats, rois, self.mask_pooler_resolution,
                              self.mask_extractor, self.mask_predictor)

    def keypoint_forward(self, feats, rois: torch.Tensor) -> torch.Tensor:
        """The keypoint head on (B, R, 4) rois: (B, R, 4M, 4M, K) f32 heatmap
        logits (M = ``keypoint_pooler_resolution``)."""
        return self._roi_head(feats, rois, self.keypoint_pooler_resolution,
                              self.keypoint_extractor, self.keypoint_predictor)

    def attribute_forward(self, feats, boxes: torch.Tensor) -> torch.Tensor:
        """(B, N, 4) boxes → (B, N, num_attributes) f32 attribute logits from
        the box head's fc7 features (its own 7x7 pool).  In relation training
        the maps and fc6/fc7 are frozen, so only ``att_score`` records a
        gradient."""
        pooled = self._pool_boxes(feats, boxes, self.box_pooler_resolution)
        return self.attribute_predictor(self.box_extractor(pooled))

    def detect(self, images: torch.Tensor,
               image_sizes: torch.Tensor) -> DetectOutput:
        """NHWC images (B, H, W, 3) and their (B, 2) = (w, h) sizes → the FPN
        maps, the padded detections and their box-head logits (gathered by
        ``orig_idx``), all outside autograd."""
        feats, proposals, logits, deltas = self._cascade(images, image_sizes)
        with torch.no_grad():
            dets = self.postprocess_boxes(logits, deltas, proposals, image_sizes)
            idx = dets.orig_idx.long()[..., None].expand(-1, -1, logits.shape[-1])
            return DetectOutput(feats, dets, torch.gather(logits, 1, idx))

    def relate(self, feats, depth, boxes, box_mask, obj_labels, pair_idx,
               obj_logits=None, image_sizes=None, boxes_per_cls=None, gumbel=None,
               forest=None, pair_mask=None, pred_labels=None):
        """The relation head over (B, N) boxes and (B, P) pairs.  The legacy
        predictors also take the (B, 2) = (w, h) ``image_sizes`` (default:
        the padded input's, from ``depth``), SGDet's ``boxes_per_cls``,
        VCTree's training decoder's ``gumbel`` noise (B, N, C - 1), a
        ``forest`` for VCTree to run on in place of the one it would build
        (its output's ``forest``), the message-passing predictors'
        ``pair_mask`` (B, P) (all pairs when None) and IMP's ``pred_labels``
        (``obj_labels`` when None); VETO's read none of these."""
        if self.legacy:
            if image_sizes is None:
                h, w = depth.shape[1:3]
                image_sizes = torch.tensor([[w, h]], dtype=torch.float32,
                                           device=boxes.device).expand(boxes.shape[0], 2)
            image_sizes = image_sizes.float()
            pooled = self._pool_boxes(feats, boxes, self.box_pooler_resolution)
            roi_vec = self.rel_box_extractor(pooled)
            union = self.union_extractor(feats, boxes, pair_idx, image_sizes)
            return self.relation(boxes, box_mask, obj_labels, obj_logits, pair_idx,
                                 roi_vec, union, image_sizes, boxes_per_cls,
                                 gumbel=gumbel, forest=forest, pair_mask=pair_mask,
                                 pred_labels=pred_labels)
        depth_feat = self.depth_backbone(depth).contiguous()
        roi_feats = self._pool_boxes(feats, boxes, self.pooler_resolution)
        depth_roi = multilevel_roi_align_batched(
            [depth_feat], boxes, (self.depth_scale,), self.pooler_resolution,
            self.pooler_sampling_ratio)
        return self.relation(boxes, box_mask, obj_labels, pair_idx, roi_feats,
                             depth_roi, obj_logits)

    def forward(self, images, depth, boxes, box_mask, obj_labels, obj_logits,
                pair_idx, pair_mask, gumbel=None, forest=None) -> SGGForward:
        """The JAX ``SGGModel.__call__`` signature; ``obj_logits`` is unused,
        and ``pair_mask`` is read by the message-passing legacy predictors
        only (VETO's padded pairs are masked later, in post-processing).
        ``gumbel`` and ``forest``: VCTree's training decoder noise and the
        forest to run on (see :meth:`relate`)."""
        feats = self.extract_features(images)
        if self.mode == "sgcls":
            predict_logits = self._box_logits(feats, boxes)
            pred_labels = self._predict_labels(boxes, predict_logits, box_mask)
        else:
            # ±1000 GT-logit injection so eval softmax obj scores are exactly 1
            predict_logits = F.one_hot(
                obj_labels.long(), self.num_obj_classes).float() * 2000.0 - 1000.0
            pred_labels = obj_labels
        att_logits = (self.attribute_forward(feats, boxes) if self.attribute_on
                      else None)
        if self.legacy:
            # the legacy contexts embed the GT labels (and refine their own)
            out = self.relate(feats, depth, boxes, box_mask, obj_labels, pair_idx,
                              predict_logits, gumbel=gumbel, forest=forest,
                              pair_mask=pair_mask, pred_labels=pred_labels)
            return SGGForward(rel_logits=out.rel_logits, obj_dists=out.obj_dists,
                              pred_labels=out.obj_preds,
                              predict_logits=predict_logits,
                              attribute_logits=att_logits,
                              binary_preds=out.binary_preds, forest=out.forest,
                              relness_logits=out.relness_logits)
        out = self.relate(feats, depth, boxes, box_mask, pred_labels, pair_idx,
                          predict_logits)
        return SGGForward(rel_logits=out.rel_logits, obj_dists=out.obj_dists,
                          pred_labels=pred_labels, predict_logits=predict_logits,
                          attribute_logits=att_logits)


def resolve_predictor(name: str) -> str:
    """A ``relation.predictor`` name → the base predictor, as the JAX tool
    resolves it: a ``*_MEET`` name selects its base (the ensemble heads
    come with ``ensemble.enabled``, not with the name), and
    ``TransLike_MEET`` is ``TransLikePredictor``.  The port has VETO's and
    the legacy predictors of :data:`LEGACY_PORTED`; another legacy name
    raises ``NotImplementedError`` naming the slice that brings it, an
    unknown one ``ValueError``."""
    base = name[: -len("_MEET")] if name.endswith("_MEET") else name
    if base == "TransLike":
        base = "TransLikePredictor"
    if base == "VETOPredictor" or base in LEGACY_PORTED:
        return base
    if base in _LEGACY_TO_COME:
        raise NotImplementedError(
            f"predictor {name!r}: the port has VETOPredictor and "
            f"{', '.join(LEGACY_PORTED)}; {base} comes "
            f"with {_LEGACY_TO_COME[base]}, ROADMAP queue A14")
    raise ValueError(f"predictor {name!r}: no such relation predictor (the JAX "
                     f"model's: VETOPredictor, {', '.join(LEGACY_PREDICTORS)})")


def build_model(cfg, device=None, seed: int = None,
                train_detector: bool = False) -> SGGModel:
    """SGGModel for a config, on ``device`` (default ``cuda``; raises when no
    GPU is present unless ``device="cpu"``), in eval mode, with weights
    drawn from ``seed`` (default ``cfg.solver.seed``) and the encoder that
    ``veto.encoder_impl`` names (raises ``ValueError`` on a name it does not
    know).  With ``ensemble.enabled`` the relation head is MEET's
    (:func:`~..tools.relation_train_net.build_meet_config`);
    ``train_detector`` builds it for detector pretraining (see the module
    docstring).  ``model.backbone=VGG-16`` takes the JAX tool's non-FPN
    geometry (``tools/relation_train_net.py``): the config's anchor sizes as
    one level's, stride 16, pooler scale 1/16.  ``relation.rel_aware`` and
    ``relation.mp_valid_pairs`` configure BGNN's and MSDN's relation
    confidence."""
    from ..tools.relation_train_net import build_meet_config

    dev = resolve_device(device)
    check_mode(cfg.relation.mode)
    predictor = resolve_predictor(cfg.relation.predictor)
    meet = build_meet_config(cfg)
    vgg = cfg.model.backbone == "VGG-16"
    if not (vgg or cfg.model.backbone.endswith("-FPN")) or any(cfg.model.stage_with_dcn):
        raise NotImplementedError(
            f"backbone {cfg.model.backbone!r} with stage_with_dcn "
            f"{cfg.model.stage_with_dcn}: the port has the ResNet-FPN bodies and "
            "VGG-16, without deformable convs (ROADMAP queue A14 item 10)")
    m = cfg.model
    model = SGGModel(
        num_obj_classes=cfg.model.num_obj_classes,
        num_rel_classes=cfg.relation.num_classes, mode=cfg.relation.mode,
        stage_blocks=cfg.model.stage_blocks, groups=cfg.model.resnet_groups,
        width_per_group=cfg.model.resnet_width_per_group,
        fpn_channels=cfg.model.fpn_channels,
        pooler_resolution=cfg.relation.pooler_resolution,
        pooler_scales=(0.0625,) if vgg else cfg.relation.pooler_scales,
        pooler_sampling_ratio=cfg.relation.pooler_sampling_ratio,
        veto_dim=cfg.veto.t_input_dim, veto_layers=cfg.veto.enc_layers,
        veto_heads=cfg.veto.nheads, veto_patch_size=cfg.veto.patch_size,
        veto_depth_proj_dim=cfg.veto.depth_proj_dim,
        veto_visual_proj_dim=cfg.veto.visual_proj_dim,
        fold_bn=cfg.model.fold_bn,
        dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
        veto_encoder_impl=cfg.veto.encoder_impl,
        box_pooler_resolution=cfg.model.box_pooler_resolution,
        box_mlp_dim=cfg.model.box_mlp_head_dim,
        # the RPN and box-head budgets as the JAX tool builds the model
        # (tools/relation_train_net.py:260-272): the test budgets in
        # training too, the fpn post-NMS budget = the post-NMS one
        anchor_sizes=(tuple(m.anchor_sizes),) if vgg else m.anchor_sizes,
        anchor_strides=(16,) if vgg else m.anchor_strides,
        aspect_ratios=cfg.model.aspect_ratios,
        rpn_pre_nms_top_n=cfg.model.rpn_pre_nms_top_n_test,
        rpn_post_nms_top_n=cfg.model.rpn_post_nms_top_n_test,
        rpn_nms_thresh=cfg.model.rpn_nms_thresh,
        rpn_fpn_post_nms_top_n=cfg.model.rpn_post_nms_top_n_test,
        box_score_thresh=cfg.model.box_score_thresh,
        box_nms_thresh=cfg.model.box_nms_thresh,
        nms_filter_duplicates=cfg.model.nms_filter_duplicates,
        detections_per_img=cfg.model.box_detections_per_img,
        meet_group_sizes=meet.group_sizes if meet else None,
        meet_experts=meet.experts_per_group if meet else 1,
        train_detector=train_detector,
        attribute_on=m.attribute_on, num_attributes=m.num_attributes,
        mask_on=m.mask_on, mask_conv_layers=m.mask_conv_layers,
        mask_pooler_resolution=m.mask_pooler_resolution,
        keypoint_on=m.keypoint_on, num_keypoints=m.num_keypoints,
        keypoint_conv_layers=m.keypoint_conv_layers,
        keypoint_pooler_resolution=m.keypoint_pooler_resolution,
        predictor=predictor,
        context_hidden_dim=cfg.relation.context_hidden_dim,
        context_pooling_dim=cfg.relation.context_pooling_dim,
        backbone_type=cfg.model.backbone,
        bgnn_rel_aware=cfg.relation.rel_aware,
        bgnn_mp_valid_pairs=cfg.relation.mp_valid_pairs,
    ).to(dev)
    init_weights(model, cfg.solver.seed if seed is None else seed)
    return model.eval()


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """Seeded random weights, drawn on the model's device with one
    ``torch.Generator``: LeCun-normal matrices and conv kernels (fan-in
    over the kernel window and group), Xavier-uniform ``rel_out`` (and
    MEET's ``rel_out_e{e}_g{k}``), the box
    predictor's N(0, 0.01^2) ``cls_score`` and N(0, 0.001^2) ``bbox_pred``,
    the legacy heads' explicit (in, out) matrices (``*_w``, ``bi_freq_prior``)
    LeCun-normal over their first axis, their class embeddings N(0, 1), the
    frequency bias zero and BGNN's ``relness_alpha`` 2.5, as the JAX model
    builds it,
    the RPN head's N(0, 0.01^2) convolutions and the attribute head's
    N(0, 0.01^2) ``att_score`` (flax's ``normal`` initializers), the mask
    and keypoint heads' kernels He-normal over their fan-out, truncated at
    2 sigma (flax's ``variance_scaling(2, "fan_out", "truncated_normal")``),
    N(0, 1) CLS/position tokens,
    N(0, 1/embed_dim) embeddings, unit scales, zero biases and BN
    statistics of a unit normal."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and name.split(".")[-2].startswith("rel_out"):
            bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            p.uniform_(-bound, bound, generator=gen)
        elif name == "box_predictor.cls_score.weight":
            p.normal_(0.0, 0.01, generator=gen)
        elif name == "box_predictor.bbox_pred.weight":
            p.normal_(0.0, 0.001, generator=gen)
        elif (name.startswith("rpn.") and leaf == "weight"
              or name == "attribute_predictor.att_score.weight"):
            p.normal_(0.0, 0.01, generator=gen)
        elif name.startswith(("mask_", "keypoint_")) and leaf == "weight":
            # (O, I, kh, kw), a transposed convolution's (I, O, kh, kw)
            out_ch = p.shape[1] if "conv5_mask" in name or "kps_score" in name \
                else p.shape[0]
            std = math.sqrt(2.0 / (out_ch * p.shape[2] * p.shape[3])) / .87962566103423978
            nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=gen).mul_(std)
        elif leaf in ("cls_token", "pos_embedding", "obj_embed") or name.endswith(
                ("obj_embed1.weight", "obj_embed2.weight", "obj_sem_embed.weight",
                 "obj_embed_on_prob_dist.weight", "obj_embed_on_pred_label.weight")):
            p.normal_(0.0, 1.0, generator=gen)
        elif leaf == "relness_alpha":
            p.fill_(SCALING_WEIGHT[0])
        elif leaf.endswith("_w") or leaf == "bi_freq_prior":
            # the legacy heads' explicit (in, out) matrices
            p.normal_(0.0, p.shape[0] ** -0.5, generator=gen)
        elif leaf.endswith("_b") or leaf == "obj_baseline":
            p.zero_()
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
