"""The detector pretraining step (``veto_tpu/engine/pretrain.py``
``make_detector_train_step``).

One step trains the whole detector: the body and the RPN head forward
inside autograd (:meth:`SGGModel.detector_forward`), the RPN's anchor
matching, balanced sample and losses on f32 casts of its maps, the
proposal selection on the detached maps (``rpn_select_proposals`` with the
training budgets, no minimum size, no GT boxes added; kernel N1 on the
card), the Fast R-CNN sampler's 512 rois an image, the box head on them
(:meth:`SGGModel.box_forward`: the 7x7 pool, B3, whose backward B3-bwd
takes the gradient into P2-P5), its losses, the backward and the clipped
SGD update of every parameter (nothing is frozen: the depth ResNet and the
relation head take zero gradients and still decay).

With the model's mask or keypoint head (``model.mask_on``,
``model.keypoint_on``), the step also takes ``head_rois_per_image`` of the
sampled rois an image, the positives first in their sampled order (a
stable selection; negatives that fill the budget weigh nothing), matches
them to the GT boxes again at ``box_fg_iou`` as the reference's mask and
keypoint losses do, and adds ``loss_mask`` (each image's mean weighted by
its ``num_pos * M^2`` elements) and ``loss_kp`` (weighted by its valid
keypoints).  Each head pools its rois at 14 x 14 in its own B3 launch,
whose backward B3-bwd takes the gradient into P2-P5.

The samplers' uniforms come from ``state.generator`` on the model's
device, the RPN's two (B, A) draws first, then the box sampler's two
(B, P); ``draws=`` passes them in instead (a test passes the JAX
package's ``jax.random`` draws).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..models.detector.box_head import assign_labels_to_proposals
from ..models.detector.keypoint_head import keypoint_loss
from ..models.detector.losses import (
    fastrcnn_losses, fastrcnn_sample, rpn_losses,
)
from ..models.detector.mask_head import mask_loss
from ..models.detector.rpn import flatten_level, rpn_select_proposals
from ..solver.optim import make_optimizer
from .train import TrainState

LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier",
          "loss_box_reg")


class DetectorBudgets(NamedTuple):
    """The step's samplers, proposal selection and the mask and keypoint
    heads' roi budget (``model.rpn_*``, ``model.box_*``,
    ``model.head_rois_per_image`` of the config: :func:`detector_budgets`)."""
    rpn_batch_size: int
    rpn_positive_fraction: float
    rpn_fg_iou: float
    rpn_bg_iou: float
    box_batch_size: int
    box_positive_fraction: float
    box_fg_iou: float
    box_bg_iou: float
    rpn_pre_nms_top_n: int
    rpn_post_nms_top_n: int
    rpn_fpn_post_nms_top_n: int
    rpn_nms_thresh: float
    head_rois_per_image: int


def detector_budgets(cfg) -> DetectorBudgets:
    """The budgets of a config, as the JAX tool passes them (the training
    post-NMS budget also over all levels)."""
    m = cfg.model
    return DetectorBudgets(
        m.rpn_batch_size_per_image, m.rpn_positive_fraction,
        m.rpn_fg_iou_threshold, m.rpn_bg_iou_threshold,
        m.box_batch_size_per_image, m.box_positive_fraction,
        m.box_fg_iou_threshold, m.box_bg_iou_threshold,
        m.rpn_pre_nms_top_n_train, m.rpn_post_nms_top_n_train,
        m.rpn_post_nms_top_n_train, m.rpn_nms_thresh, m.head_rois_per_image)


class DetectorDraws(NamedTuple):
    """The samplers' uniforms in [0, 1)."""
    rpn_pos: torch.Tensor  # (B, A) over every level's anchors
    rpn_neg: torch.Tensor
    box_pos: torch.Tensor  # (B, P) over the proposals
    box_neg: torch.Tensor


def create_detector_state(model: torch.nn.Module, solver_cfg,
                          seed: Optional[int] = None) -> TrainState:
    """The pretraining state: ``solver_cfg``'s optimizer over every
    parameter of ``model`` (built with ``train_detector=True``), and the
    samplers' generator on its device, seeded by ``seed`` (default
    ``solver_cfg.seed``)."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(
        solver_cfg.seed if seed is None else seed)
    return TrainState(model, make_optimizer(solver_cfg, model, frozen_prefixes=()),
                      generator=gen)


def _uniform(state: TrainState, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=state.generator, device=device)


def detector_losses(state: TrainState, batch, budgets: DetectorBudgets,
                    draws: Optional[DetectorDraws] = None
                    ) -> Dict[str, torch.Tensor]:
    """The step's forward: the four losses (means over the images), and
    ``loss_mask`` / ``loss_kp`` with the model's mask / keypoint head,
    inside autograd."""
    model = state.model
    images = batch.images
    b, h, w = images.shape[:3]
    feats, obj_maps, reg_maps = model.detector_forward(images)
    flat = [flatten_level(o.float(), r.float()) for o, r in zip(obj_maps, reg_maps)]
    level_anchors = model.anchors([o.shape[1:3] for o in obj_maps], images.device)
    anchors = torch.cat(level_anchors)
    # fully inside the padded image (straddle_thresh 0)
    visibility = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
                  & (anchors[:, 2] < w) & (anchors[:, 3] < h))
    if draws is None:
        rpn_draws = [_uniform(state, (b, anchors.shape[0]), images.device)
                     for _ in range(2)]
    else:
        rpn_draws = [draws.rpn_pos, draws.rpn_neg]
    rpn = rpn_losses(torch.cat([f[0] for f in flat], 1),
                     torch.cat([f[1] for f in flat], 1), anchors, visibility,
                     batch.boxes, batch.box_mask, *rpn_draws,
                     batch_size=budgets.rpn_batch_size,
                     positive_fraction=budgets.rpn_positive_fraction,
                     high=budgets.rpn_fg_iou, low=budgets.rpn_bg_iou)
    with torch.no_grad():  # on the detached maps
        proposals = rpn_select_proposals(
            [f[0] for f in flat], [f[1] for f in flat], level_anchors,
            batch.sizes.float(), budgets.rpn_pre_nms_top_n,
            budgets.rpn_post_nms_top_n, budgets.rpn_nms_thresh,
            budgets.rpn_fpn_post_nms_top_n)
    if draws is None:
        box_draws = [_uniform(state, proposals.mask.shape, images.device)
                     for _ in range(2)]
    else:
        box_draws = [draws.box_pos, draws.box_neg]
    with torch.no_grad():
        samples = fastrcnn_sample(
            proposals.boxes, proposals.mask, batch.boxes, batch.labels,
            batch.box_mask, *box_draws, batch_size=budgets.box_batch_size,
            positive_fraction=budgets.box_positive_fraction,
            high=budgets.box_fg_iou, low=budgets.box_bg_iou)
        rois = torch.gather(proposals.boxes, 1,
                            samples.idx[..., None].expand(-1, -1, 4))
    logits, deltas = model.box_forward(feats, rois)
    box = fastrcnn_losses(logits, deltas, samples)
    losses = dict(zip(LOSSES, (rpn.objectness.mean(), rpn.box.mean(),
                               box.classifier.mean(), box.box_reg.mean())))
    if model.mask_on or model.keypoint_on:
        losses.update(_head_losses(model, feats, batch, samples, rois, budgets))
    return losses


def _head_losses(model, feats, batch, samples, rois,
                 budgets: DetectorBudgets) -> Dict[str, torch.Tensor]:
    """``loss_mask`` and ``loss_kp`` on ``head_rois_per_image`` of the
    sampled rois, the positives first."""
    for on, field in ((model.mask_on, "masks"), (model.keypoint_on, "keypoints")):
        if on and getattr(batch, field) is None:
            raise ValueError(f"the model's {field[:-1]} head trains on the batch's "
                             f"{field}, and this batch carries none (the COCO, VOC "
                             "and VG readers give none; the synthetic corpus does)")
    with torch.no_grad():
        pos = samples.mask & (samples.labels > 0)
        order = torch.sort((~pos).int(), dim=1, stable=True)[1][
            :, :budgets.head_rois_per_image]
        sel_pos = torch.gather(pos, 1, order)
        sel_rois = torch.gather(rois, 1, order[..., None].expand(-1, -1, 4))
        labels, matched = assign_labels_to_proposals(
            sel_rois, sel_pos, batch.boxes, batch.labels, batch.box_mask,
            fg_iou_threshold=budgets.box_fg_iou)
    out = {}
    if model.mask_on:
        logits = model.mask_forward(feats, sel_rois)
        ml = mask_loss(logits, labels, matched, batch.masks, sel_rois, sel_pos)
        wts = (ml.num_pos * logits.shape[2] ** 2).float()
        out["loss_mask"] = (ml.loss * wts).sum() / torch.clamp(wts.sum(), min=1.0)
    if model.keypoint_on:
        logits = model.keypoint_forward(feats, sel_rois)
        kps = torch.gather(batch.keypoints, 1, matched.clamp(min=0).long()[
            ..., None, None].expand((-1, -1) + batch.keypoints.shape[2:]))
        kl = keypoint_loss(logits, kps, sel_rois, sel_pos & (matched >= 0))
        wts = kl.num_valid.float()
        out["loss_kp"] = (kl.loss * wts).sum() / torch.clamp(wts.sum(), min=1.0)
    return out


def detector_forward_backward(state: TrainState, batch, budgets: DetectorBudgets,
                              draws: Optional[DetectorDraws] = None
                              ) -> Dict[str, torch.Tensor]:
    """Train-mode forward and backward: every parameter's ``.grad`` holds
    the step's gradient.  Returns ``loss`` (the sum) and the step's losses,
    detached."""
    state.model.train()
    state.optimizer.zero_grad()
    losses = detector_losses(state, batch, budgets, draws)
    loss = sum(losses.values())
    loss.backward()
    return {"loss": loss.detach(), **{k: v.detach() for k, v in losses.items()}}


def detector_train_step(state: TrainState, batch, lr_scale: float,
                        budgets: DetectorBudgets,
                        draws: Optional[DetectorDraws] = None
                        ) -> Dict[str, torch.Tensor]:
    """One pretraining step on a device batch: the losses, ``grad_norm``
    (before clipping) and the update at ``lr_scale``."""
    metrics = detector_forward_backward(state, batch, budgets, draws)
    grad_norm = state.optimizer.step(lr_scale)
    state.step += 1
    return {**metrics, "grad_norm": grad_norm.detach()}
