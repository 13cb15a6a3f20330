"""The detector pretraining step (``veto_tpu/engine/pretrain.py``
``make_detector_train_step``, without the mask and keypoint heads).

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

The samplers' uniforms come from ``state.generator`` on the model's
device, the RPN's two (B, A) draws first, then the box sampler's two
(B, P); ``draws=`` passes them in instead (a test passes the JAX
package's ``jax.random`` draws).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..models.detector.losses import (
    fastrcnn_losses, fastrcnn_sample, rpn_losses,
)
from ..models.detector.rpn import flatten_level, rpn_select_proposals
from ..solver.optim import make_optimizer
from .train import TrainState

LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier",
          "loss_box_reg")


class DetectorBudgets(NamedTuple):
    """The step's samplers and proposal selection (``model.rpn_*``,
    ``model.box_*`` of the config: :func:`detector_budgets`)."""
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


def detector_budgets(cfg) -> DetectorBudgets:
    """The budgets of a config, as the JAX tool passes them (the training
    post-NMS budget also over all levels)."""
    m = cfg.model
    if m.mask_on or m.keypoint_on:
        raise NotImplementedError(
            "model.mask_on / model.keypoint_on: the mask and keypoint heads "
            "come with slice A14")
    return DetectorBudgets(
        m.rpn_batch_size_per_image, m.rpn_positive_fraction,
        m.rpn_fg_iou_threshold, m.rpn_bg_iou_threshold,
        m.box_batch_size_per_image, m.box_positive_fraction,
        m.box_fg_iou_threshold, m.box_bg_iou_threshold,
        m.rpn_pre_nms_top_n_train, m.rpn_post_nms_top_n_train,
        m.rpn_post_nms_top_n_train, m.rpn_nms_thresh)


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
    """The step's forward: the four losses (means over the images), inside
    autograd."""
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
    return dict(zip(LOSSES, (rpn.objectness.mean(), rpn.box.mean(),
                             box.classifier.mean(), box.box_reg.mean())))


def detector_forward_backward(state: TrainState, batch, budgets: DetectorBudgets,
                              draws: Optional[DetectorDraws] = None
                              ) -> Dict[str, torch.Tensor]:
    """Train-mode forward and backward: every parameter's ``.grad`` holds
    the step's gradient.  Returns ``loss`` (the sum) and the four losses,
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
