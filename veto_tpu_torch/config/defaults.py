"""Configuration tree for veto_tpu_torch.

The port's own copy of ``veto_tpu/config/defaults.py``: the same typed
dataclasses, the same YAML files and the same dotted ``key=value``
overrides, so one config drives either package.  It is copied rather than
imported so that the port never loads a module of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


@dataclass
class VetoTransformerConfig:
    """VETO relation transformer hyperparameters.

    Mirrors MODEL.ROI_RELATION_HEAD.VETOTRANSFORMER
    (reference defaults.py:331-338, configs/VETO_final.yaml:75-81).
    """

    patch_size: int = 2
    t_input_dim: int = 576
    enc_layers: int = 6
    nheads: int = 6
    emb_dropout: float = 0.0
    t_dropout: float = 0.0
    # patch-projection output dims (reference model_veto.py:105-106)
    depth_proj_dim: int = 512
    visual_proj_dim: int = 64
    # encoder implementation: auto (= fused) | fused (the fused layer
    # kernels) | pair_attn (plain PyTorch layer around the pair-attention
    # kernels) | xla (plain PyTorch layer); any other value raises
    encoder_impl: str = "auto"
    # rematerialize the encoder in backward (memory for compute); the fused
    # kernel already recomputes flash-style, so off is the fast default
    remat: bool = False


@dataclass
class EnsembleConfig:
    """MEET mutually-exclusive-expert ensemble settings.

    Mirrors ENSEMBLE_LEARNING.* (reference defaults.py:860-864).
    """

    enabled: bool = False
    num_models: int = 3
    type: Tuple[str, ...] = ()
    expert_group: bool = False
    voting: str = "C"  # 'C' consensus | 'U' unanimous
    zero_label_padding_mode: str = "rand_insert"
    # GCL group split strategy (reference SHA_GCL_extra/group_chosen_function.py)
    group_split: str = "divide4"


@dataclass
class RelationConfig:
    """Relation head settings (MODEL.ROI_RELATION_HEAD.*)."""

    predictor: str = "VETOPredictor"
    use_gt_box: bool = True
    use_gt_object_label: bool = True
    num_classes: int = 51  # VG: 50 predicates + background
    # pair sampling (reference sampling.py:10-29, defaults BATCH_SIZE_PER_IMAGE)
    batch_size_per_image: int = 1024
    positive_fraction: float = 0.25
    max_proposal_pairs: int = 2048
    num_sample_per_gt_rel: int = 4
    require_box_overlap: bool = False
    fg_iou_threshold: float = 0.5
    # feature pooling
    pooler_resolution: int = 8
    pooler_scales: Tuple[float, ...] = (0.25, 0.125, 0.0625, 0.03125)
    pooler_sampling_ratio: int = 2
    # embeddings
    embed_dim: int = 200
    context_hidden_dim: int = 512
    context_pooling_dim: int = 4096
    # losses
    beta_loss: bool = True
    beta: float = 0.999
    use_bias: bool = False
    label_smoothing: bool = False
    # relation loss variant (the reference's RelationLossComputation
    # branches, loss.py:13-120): weighted_ce | label_smoothing | ldam |
    # balanced_norm.  label_smoothing=True above is honored as an alias.
    loss_variant: str = "weighted_ce"
    ldam_max_m: float = 0.5
    ldam_s: float = 30.0
    # causal analysis (MODEL.ROI_RELATION_HEAD.CAUSAL.*)
    causal_effect_type: str = "none"  # none | TDE | NIE | TE
    causal_fusion_type: str = "sum"   # sum | gate
    # BGNN/MSDN relation-confidence-aware mode
    # (MODEL.ROI_RELATION_HEAD.RELATION_PROPOSAL_MODEL.SET_ON +
    #  BGNN_MODULE.RELNESS_MP_WEIGHTING)
    rel_aware: bool = False
    mp_valid_pairs: int = 200  # BGNN_MODULE.MP_VALID_PAIRS_NUM
    # post-processing
    later_nms_prediction_thres: float = 0.3

    @property
    def mode(self) -> str:
        """Task mode from the two GT bits (reference relation_train_net.py:735-741)."""
        if self.use_gt_box:
            return "predcls" if self.use_gt_object_label else "sgcls"
        return "sgdet"


@dataclass
class DetectorConfig:
    """Backbone / RPN / box-head settings (subset of MODEL.*)."""

    backbone: str = "R-101-FPN"
    # torch checkpoint of the pretrained detector (reference
    # MODEL.PRETRAINED_DETECTOR_CKPT_VG / _GQA, VETO_final.yaml:4-5)
    pretrained_detector_ckpt: str = ""
    stage_blocks: Tuple[int, ...] = (3, 4, 23, 3)  # R-101; R-50 = (3,4,6,3)
    resnet_groups: int = 32  # ResNeXt 32x8d (reference defaults.py:613-616)
    resnet_width_per_group: int = 8
    freeze_conv_body_at: int = 2
    # fold the frozen backbone's BN affines into the conv weights at
    # build/import time (models/backbone/resnet.py fold_frozen_bn_params)
    fold_bn: bool = True
    fpn_channels: int = 256
    use_depth: bool = True  # depth R-18 backbone (reference backbone.py:83-93)
    # deformable conv stages (MODEL.RESNETS.STAGE_WITH_DCN etc.,
    # reference defaults.py RESNETS section)
    stage_with_dcn: Tuple[bool, ...] = (False, False, False, False)
    dcn_modulated: bool = True
    dcn_deformable_groups: int = 1
    # mask head (MODEL.MASK_ON + ROI_MASK_HEAD.*, reference
    # defaults.py:263-280; FPN variant with own pooling)
    mask_on: bool = False
    mask_conv_layers: Tuple[int, ...] = (256, 256, 256, 256)
    mask_pooler_resolution: int = 14
    # keypoint head (MODEL.KEYPOINT_ON + ROI_KEYPOINT_HEAD.*,
    # reference defaults.py:282-292)
    keypoint_on: bool = False
    num_keypoints: int = 17
    keypoint_conv_layers: Tuple[int, ...] = tuple(512 for _ in range(8))
    keypoint_pooler_resolution: int = 14
    # per-image roi budget for the mask/keypoint heads in pretraining
    head_rois_per_image: int = 64
    # attribute head (MODEL.ATTRIBUTE_ON + ROI_ATTRIBUTE_HEAD.*,
    # reference defaults.py:34, 251-262)
    attribute_on: bool = False
    num_attributes: int = 201
    attribute_loss_weight: float = 0.1
    attribute_bgfg_sample: bool = True
    attribute_bgfg_ratio: int = 3
    attribute_use_binary_loss: bool = True
    attribute_pos_weight: float = 5.0
    # anchors (reference anchor_generator.py:34, neural-motifs ratios)
    anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    anchor_strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    aspect_ratios: Tuple[float, ...] = (0.23232838, 0.63365731, 1.28478321, 3.15089189)
    # RPN budgets (reference defaults.py RPN section)
    rpn_pre_nms_top_n_train: int = 6000
    rpn_pre_nms_top_n_test: int = 6000
    rpn_post_nms_top_n_train: int = 1000
    rpn_post_nms_top_n_test: int = 1000
    rpn_nms_thresh: float = 0.7
    rpn_fpn_post_nms_per_image: bool = False  # train: per-batch top-N
    rpn_batch_size_per_image: int = 256
    rpn_positive_fraction: float = 0.5
    rpn_fg_iou_threshold: float = 0.7
    rpn_bg_iou_threshold: float = 0.3
    rpn_straddle_thresh: int = 0
    # box head
    box_batch_size_per_image: int = 512
    box_positive_fraction: float = 0.25
    box_fg_iou_threshold: float = 0.5
    box_bg_iou_threshold: float = 0.3
    box_score_thresh: float = 0.01
    box_nms_thresh: float = 0.3
    box_detections_per_img: int = 80  # VETO_final.yaml:35
    box_reg_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)
    nms_filter_duplicates: bool = True
    num_obj_classes: int = 151  # VG: 150 + background
    box_pooler_resolution: int = 7
    box_mlp_head_dim: int = 4096
    # multi-level pooler implementation: auto (windowed Pallas kernel on
    # TPU, separable matmuls elsewhere) | windowed | separable
    pooler_impl: str = "auto"


@dataclass
class DataConfig:
    """Dataset + input pipeline settings (DATASETS.*, INPUT.*, DATALOADER.*)."""

    dataset: str = "VG_stanford_filtered_with_attribute"
    data_dir: str = ""
    use_depth: bool = True
    box_scale: int = 1024  # VG h5 boxes are at 1024-px scale (visual_genome.py:23)
    num_val_images: int = 5000
    filter_empty_relations: bool = True
    filter_duplicate_relations: bool = True
    filter_non_overlap: bool = True
    reorder_freq_based: bool = True  # predicate frequency reorder (yaml :91)
    # resampling (bi_lvl_rsmp.py)
    resampling: bool = False
    repeat_factor: float = 0.13
    instance_drop_rate: float = 1.6
    # input transforms (reference transforms/build.py)
    min_size_train: int = 800
    max_size_train: int = 1333
    min_size_test: int = 800
    max_size_test: int = 1333
    flip_prob_train: float = 0.5
    pixel_mean: Tuple[float, ...] = (102.9801, 115.9465, 122.7717)  # BGR
    pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0)
    to_bgr255: bool = True
    size_divisibility: int = 32
    # static padding budgets (TPU: compile-once shapes)
    max_boxes: int = 80
    max_rels: int = 1024
    image_buckets: Tuple[Tuple[int, int], ...] = ((800, 1344), (1344, 800), (1024, 1024))


@dataclass
class SolverConfig:
    """Optimizer + schedule (SOLVER.*, configs/VETO_final.yaml:94-126)."""

    optimizer: str = "adam"
    base_lr: float = 1e-4
    bias_lr_factor: float = 1.0
    weight_decay: float = 1e-5
    weight_decay_bias: float = 0.0
    momentum: float = 0.9
    grad_clip_norm: float = 5.0
    max_iter: int = 125000
    ims_per_batch: int = 12
    # lr is multiplied by ims_per_batch (reference solver/build.py:30-33)
    scale_lr_by_batch: bool = True
    # warmup
    warmup_factor: float = 0.1
    warmup_iters: int = 3000
    warmup_method: str = "linear"
    # schedule: "WarmupMultiStepLR" | "WarmupReduceLROnPlateau"
    schedule: str = "WarmupReduceLROnPlateau"
    steps: Tuple[int, ...] = (10000, 16000)
    gamma: float = 0.1
    # plateau scheduler (reference lr_scheduler.py:56)
    plateau_factor: float = 0.1
    plateau_patience: int = 2
    plateau_threshold: float = 1e-4
    plateau_cooldown: int = 1
    max_decay_step: int = 3
    checkpoint_period: int = 5000
    val_period: int = 5000
    seed: int = 1


@dataclass
class TestConfig:
    ims_per_batch: int = 1
    relation_require_overlap: bool = False
    sync_gather: bool = True
    iou_threshold: float = 0.5
    # zero-shot recall over triples unseen in training (the reference always
    # evaluates zR via its shipped zeroshot_triplet.pytorch; here the set is
    # derived from the datasets and cached — sgg_eval.py:346-366)
    zeroshot_eval: bool = True
    # optional path to the reference's zeroshot_triplet.pytorch (original
    # predicate order — only valid with data.reorder_freq_based=false)
    zeroshot_file: str = ""
    # head/body/tail recall splits (LONGTAIL_PART_DICT, defaults.py:545-548)
    longtail_eval: bool = True
    # stage-wise diagnostic recall (SGStagewiseRecall, sgg_eval.py:582-1207)
    stagewise_eval: bool = False
    # dump per-image predictions for visualization (the reference's
    # visual_info.json, vg_eval.py:431-456)
    save_visual_info: bool = False
    # diagnostic PNGs: rel_freq_dist.png at startup and
    # rel_freq_dist2recall-{mode}-{n}.png after each eval (reference
    # visual_genome.py:236-295, vg_eval.py:208-248; utils/viz.py)
    save_plots: bool = False
    # detection test-time augmentation (TEST.BBOX_AUG.*, engine/bbox_aug.py)
    bbox_aug_enabled: bool = False
    bbox_aug_h_flip: bool = True
    bbox_aug_scales: Tuple[float, ...] = ()


@dataclass
class Config:
    """Root config."""

    model: DetectorConfig = field(default_factory=DetectorConfig)
    relation: RelationConfig = field(default_factory=RelationConfig)
    veto: VetoTransformerConfig = field(default_factory=VetoTransformerConfig)
    ensemble: EnsembleConfig = field(default_factory=EnsembleConfig)
    data: DataConfig = field(default_factory=DataConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    test: TestConfig = field(default_factory=TestConfig)
    output_dir: str = "./output"
    dtype: str = "bfloat16"  # compute dtype; params are always f32
    glove_dir: str = ""
    pred_counts_path: str = ""  # reference hard-codes this; here a config key
    # collect rel-PN relness diagnostics into utils/global_buffer and dump
    # inter_data_buffer.pkl at exit (reference _C.GLOBAL_BUFFER_ON,
    # config/defaults.py:24)
    global_buffer_on: bool = False
    # also mirror scalar metrics into a TensorBoard event file
    # (utils/tb_writer.py — dependency-free TFRecord writer; the reference
    # uses torch's SummaryWriter)
    tensorboard_on: bool = False

    # ------------------------------------------------------------------
    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)

    def override(self, dotted: str, value: Any) -> "Config":
        """Return a new Config with ``section.key`` replaced by ``value``."""
        parts = dotted.split(".")
        if len(parts) == 1:
            return dataclasses.replace(self, **{parts[0]: _coerce(self, parts[0], value)})
        node = getattr(self, parts[0])
        for p in parts[1:-1]:
            node = getattr(node, p)
        new_leaf = dataclasses.replace(node, **{parts[-1]: _coerce(node, parts[-1], value)})
        # rebuild from the leaf upwards
        obj: Any = new_leaf
        for i in range(len(parts) - 2, 0, -1):
            parent = getattr(self, parts[0])
            for p in parts[1:i]:
                parent = getattr(parent, p)
            obj = dataclasses.replace(parent, **{parts[i]: obj})
        return dataclasses.replace(self, **{parts[0]: obj})

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)


def _coerce(obj: Any, name: str, value: Any) -> Any:
    """Coerce a string override to the annotated field type."""
    current = getattr(obj, name)
    if isinstance(value, list) and isinstance(current, tuple):
        # YAML sequences land as lists; tuple fields must stay hashable
        # (configs are compared and hashed as plain values)
        return tuple(tuple(v) if isinstance(v, list) else v for v in value)
    if isinstance(value, str):
        if isinstance(current, bool):
            return value.lower() in ("1", "true", "yes", "on")
        if isinstance(current, int):
            return int(value)
        if isinstance(current, float):
            return float(value)
        if isinstance(current, tuple):
            items = [v.strip() for v in value.strip("()[] ").split(",") if v.strip()]
            # an empty default names its element type only in the annotation
            # (test.bbox_aug_scales: floats, not the strings of the command)
            elem = (type(current[0]) if current else
                    typing.get_args(typing.get_type_hints(type(obj))[name])[0])
            return tuple(elem(v) for v in items)
    return value


def _apply_mapping(cfg: Config, mapping: dict, prefix: str = "") -> Config:
    for k, v in mapping.items():
        dotted = f"{prefix}{k}" if not prefix else f"{prefix}.{k}"
        if isinstance(v, dict):
            cfg = _apply_mapping(cfg, v, dotted)
        else:
            cfg = cfg.override(dotted, v)
    return cfg


def load_config(
    yaml_path: Optional[str] = None, opts: Optional[List[str]] = None
) -> Config:
    """Build a Config from an optional YAML file plus ``key=value`` overrides.

    Replaces the reference's ``cfg.merge_from_file`` + ``merge_from_list``
    (tools/relation_train_net.py:731-732).
    """
    cfg = Config()
    if yaml_path:
        import yaml  # lazy: pyyaml ships with the baked-in deps

        with open(yaml_path) as f:
            mapping = yaml.safe_load(f) or {}
        cfg = _apply_mapping(cfg, mapping)
    for opt in opts or []:
        key, _, value = opt.partition("=")
        cfg = cfg.override(key.strip(), value.strip())
    return cfg
