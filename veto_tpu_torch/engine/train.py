"""The train steps (``veto_tpu/engine/train.py`` ``make_train_step`` and
``make_sgdet_train_step``), weighted cross-entropy variant.

PredCls and SGCls: one step samples the training pairs of each image's GT
boxes (``gtbox_relsample``), runs the model in train mode, takes the Rwt
beta-weighted cross-entropy over the sampled pairs (and, in SGCls, the
object loss), back-propagates (through the encoder's and the ROIAlign's
backward kernels on the card) and applies the clipped Adam update.

SGDet: the frozen cascade detects (``SGGModel.detect``, outside autograd),
each detection takes the label of its GT box (``assign_labels_to_proposals``),
the pairs are sampled over the detections (``detect_relsample``), and the
relation head trains on them, embedding the detections' own labels; the
object loss is taken against the GT-assigned labels.

The step is split in two so that a test can feed the JAX package's own
samples (and, in SGDet, detections) to the second half:

    samples = sample_pairs(batch, generator)        # SGDet: sample_detections
    metrics = train_on_pairs(state, batch, samples, lr_scale)

``metrics`` holds ``loss``, ``rel_loss``, outside PredCls ``obj_loss``, and
``grad_norm`` (the global norm of all gradients before clipping, as
``optax.global_norm``) as 0-d tensors on the device, and ``batch_stats``,
copies of the BatchNorm running statistics after the step.

MEET (``create_train_state(meet=)``, in every mode): ``rel_loss`` gives way
to one plain cross-entropy per (expert, group) head,
``group_{k}{e+1}_CE_loss``, over the pairs routed to it; the routing draws
from ``state.generator`` after the pair sampler's draws of the same step
(the JAX package folds the step's key instead), so a resumed run stays
bit-equal.  The other loss variants (label smoothing, LDAM, balanced
norm) raise ``NotImplementedError``.

The legacy predictors (Motifs, VCTree, Transformer, TransLike, and their
MEET heads), as in the JAX package: their refined ``obj_dists`` carry a
gradient, so ``obj_loss`` (SGCls, SGDet) trains their object classifier;
in SGDet the predictor embeds the GT-assigned labels of the detections
(the Motifs decoder teacher-forces them), with the true image sizes and
the detections' ``boxes_per_cls``; VCTree adds ``binary_loss``, the
masked mean BCE of its pair scores against the GT relatedness of the
valid boxes.  VCTree's SGCls / SGDet decoder samples its feedback labels
with Gumbel noise, drawn from ``state.generator`` after the pair sampler
and before MEET's routing, fresh every step (``forward_backward(...,
gumbel=)`` takes it instead).  Their BatchNorms (the union features'
rect convs, the position and score nets) update their running
statistics in the forward, and ``batch_stats`` reports them with the
rest.

IMP, BGNN, GPSNet and MSDN read the pair mask (their messages skip the
padded pairs); IMP also embeds ``pred_labels`` (the box head's NMS labels
in SGCls, the detections' own in SGDet).  BGNN and MSDN with
``rel_aware`` add ``pre_rel_classify_loss`` in PredCls and SGCls, the
focal loss of their relness pre-classifier against the sampled pairs'
labels (``rel_proposal.rel_aware_focal_loss``); the JAX SGDet step adds
none, and neither does the port's.

Attributes (a model with ``attribute_on``, PredCls and SGCls, as in the
JAX package): ``attribute_loss`` over every box's attribute list joins the
losses, with ``state.attribute_cfg`` (``create_train_state(attribute_cfg=)``,
the tools pass ``model.attribute_*``); its negatives rank one uniform a
box drawn from ``state.generator`` after the other draws of the step (or
``attribute_draws=``).  ``att_score`` trains; the frozen box head's fc6 /
fc7 under it take no gradient, and ``grad_norm`` counts none for them
(the JAX step's global norm counts the gradient its attribute loss sends
into that frozen box head: ROADMAP queue C).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Union

import torch
from torch import nn

from ..models.detector.attribute_head import attribute_loss
from ..models.detector.box_head import assign_labels_to_proposals
from ..models.relation.predictor_meet import MeetConfig, meet_losses
from ..models.relation.predictor_veto import weighted_ce_loss
from ..models.relation.rel_proposal import rel_aware_focal_loss
from ..models.relation.sampling import (
    DetRelSample, RelSample, binary_relatedness, detect_relsample, gtbox_relsample,
)
from ..models.sgg import DetectOutput, check_mode
from ..solver.optim import FROZEN_DETECTOR, Optimizer, make_optimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    class_weights: Optional[torch.Tensor] = None  # (num_rel,) or None
    step: int = 0  # updates applied so far
    generator: Optional[torch.Generator] = None  # the pair sampler's
    meet: Optional[MeetConfig] = None  # its constants on the model's device
    attribute_cfg: Optional[dict] = None  # attribute_loss's keyword arguments


def create_train_state(model: nn.Module, solver_cfg, class_weights=None,
                       mode: str = "predcls", loss_variant: str = "weighted_ce",
                       meet=None, attribute_cfg: Optional[dict] = None) -> TrainState:
    """The state of a training run over ``model``'s parameters; ``meet`` (a
    :class:`MeetConfig`) trains MEET's per-group losses, and then the
    class weights are not used; ``attribute_cfg`` holds
    :func:`attribute_loss`'s keyword arguments (its defaults when None)
    for a model with ``attribute_on``."""
    check_mode(mode)
    if mode != model.mode:
        raise ValueError(f"mode {mode!r} for a model built for {model.mode!r}")
    if loss_variant != "weighted_ce":
        raise NotImplementedError(f"loss variant {loss_variant!r}: the port "
                                  "trains with the weighted cross-entropy")
    dev = next(model.parameters()).device
    cw = None if class_weights is None else torch.as_tensor(
        class_weights, dtype=torch.float32, device=dev)
    if meet is not None:
        meet = meet._replace(
            incre_idx=torch.as_tensor(meet.incre_idx, device=dev),
            sample_rate=torch.as_tensor(meet.sample_rate, device=dev))
    return TrainState(model, make_optimizer(solver_cfg, model), cw, meet=meet,
                      attribute_cfg=attribute_cfg)


def sample_pairs(batch, generator: torch.Generator,
                 batch_size_per_image: int = 1024,
                 positive_fraction: float = 0.25) -> RelSample:
    """The step's training pairs of each image of ``batch`` (tensors)."""
    return gtbox_relsample(batch.rel_matrix, batch.box_mask, generator,
                           batch_size_per_image, positive_fraction)


class DetSample(NamedTuple):
    """SGDet's half-step input: the detections and the pairs over them."""
    det: DetectOutput
    gt_labels: torch.Tensor  # (B, D) int32 labels of the matched GT boxes
    pairs: DetRelSample


def sample_detections(model: nn.Module, batch, generator: torch.Generator,
                      batch_size_per_image: int = 1024,
                      positive_fraction: float = 0.25,
                      num_sample_per_gt_rel: int = 4,
                      require_overlap: bool = False) -> DetSample:
    """SGDet: detect, assign GT labels to the detections and sample the
    step's pairs over them (``relation.num_sample_per_gt_rel``,
    ``relation.require_box_overlap``)."""
    det = model.detect(batch.images, batch.sizes)
    dets = det.detections
    gt_labels, _ = assign_labels_to_proposals(dets.boxes, dets.mask, batch.boxes,
                                              batch.labels, batch.box_mask)
    pairs = detect_relsample(
        batch.rel_matrix, batch.rel_matrix, batch.boxes, batch.labels,
        batch.box_mask, dets.boxes, gt_labels, dets.scores, dets.mask,
        generator, batch_size=batch_size_per_image,
        positive_fraction=positive_fraction,
        num_sample_per_gt_rel=num_sample_per_gt_rel,
        require_overlap=require_overlap)
    return DetSample(det, gt_labels, pairs)


def batch_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Copies of the running statistics of the trainable BatchNorms."""
    return {name: buf.detach().clone() for name, buf in model.named_buffers()
            if name.rsplit(".", 1)[-1] in ("running_mean", "running_var")
            and not name.startswith(FROZEN_DETECTOR)}


def _rel_losses(state: TrainState, rel_logits, labels, mask,
                member=None) -> Dict[str, torch.Tensor]:
    """``rel_loss``, the Rwt weighted cross-entropy; with MEET the per-group
    cross-entropies instead, routed by ``member`` when given, else by a
    draw from ``state.generator``."""
    if state.meet is None:
        return {"rel_loss": weighted_ce_loss(rel_logits, labels, mask,
                                             state.class_weights)}
    if member is None and state.generator is None:
        raise ValueError("MEET's routing draws from state.generator: set it")
    m = state.meet
    return meet_losses(state.generator, rel_logits, labels, mask, m.incre_idx,
                       m.sample_rate, m.group_sizes, member=member)


def _binary_loss(bi_preds: torch.Tensor, binary_rel: torch.Tensor,
                 box_mask: torch.Tensor) -> torch.Tensor:
    """VCTree's auxiliary pair-relatedness loss: the BCE of the (B, N, N)
    logits against ``binary_rel > 0``, the mean over the pairs of valid
    boxes."""
    y = (binary_rel > 0).float()
    logits = bi_preds.float()
    bce = (torch.clamp(logits, min=0) - logits * y
           + torch.log1p(torch.exp(-logits.abs())))
    m2 = (box_mask[:, :, None] & box_mask[:, None, :]).float()
    return (bce * m2).sum() / torch.clamp(m2.sum(), min=1.0)


def draw_gumbel(model: nn.Module, num_boxes: int, batch_size: int,
                generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
    """VCTree's training decoder noise (B, N, C - 1), ``-log(-log(u))`` of
    uniforms from ``generator`` (as ``jax.random.gumbel`` draws it), for a
    model whose predictor samples; None for every other model."""
    head = model.relation
    if not getattr(head, "samples_labels", False):
        return None
    if generator is None:
        raise ValueError("VCTree's decoder noise draws from state.generator: set it")
    dev = next(model.parameters()).device
    u = torch.rand((batch_size, num_boxes, head.num_obj_classes - 1),
                   generator=generator, device=dev)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def _attribute_loss(state: TrainState, logits, batch,
                    draws: Optional[torch.Tensor]) -> torch.Tensor:
    """The attribute loss of every box of the batch, its negatives ranked by
    ``draws`` ((B * N,) uniforms), else by a draw from ``state.generator``."""
    b, n = batch.box_mask.shape
    if draws is None:
        if state.generator is None:
            raise ValueError("the attribute loss draws from state.generator: set it")
        draws = torch.rand(b * n, generator=state.generator, device=logits.device)
    return attribute_loss(logits.reshape(b * n, -1), batch.attributes.reshape(b * n, -1),
                          batch.box_mask.reshape(-1), draws,
                          **(state.attribute_cfg or {})).loss


def forward_backward(state: TrainState, batch,
                     samples: Union[RelSample, DetSample],
                     member: Optional[torch.Tensor] = None,
                     attribute_draws: Optional[torch.Tensor] = None,
                     gumbel: Optional[torch.Tensor] = None,
                     forest=None) -> Dict[str, torch.Tensor]:
    """Train-mode forward and the loss's backward on the given pairs: the
    trainable parameters' ``.grad`` hold the step's gradients.  Returns the
    losses, detached: ``loss`` (their sum), ``rel_loss`` (with MEET the
    ``group_*`` losses instead; ``member``, (B, P, G) bool, routes the
    pairs in place of a draw), with ``attribute_on`` ``attribute_loss``
    (``attribute_draws``, (B * N,) uniforms, rank its negatives in place of
    a draw), outside PredCls ``obj_loss`` and for VCTree ``binary_loss``
    (its SGCls / SGDet decoder's noise ``gumbel`` (B, N, C - 1) in place of
    a draw; ``forest`` in place of the one it builds)."""
    model = state.model
    model.train()
    state.optimizer.zero_grad()
    legacy = getattr(model, "legacy", False)
    if isinstance(samples, DetSample):
        det, pairs = samples.det, samples.pairs
        dets = det.detections
        if gumbel is None:
            gumbel = draw_gumbel(model, dets.boxes.shape[1], dets.boxes.shape[0],
                                 state.generator)
        # VETO embeds the detections' own (NMS-reduced) labels, the legacy
        # contexts their GT-assigned ones
        out = model.relate(det.features, batch.depth, dets.boxes, dets.mask,
                           samples.gt_labels if legacy else dets.labels,
                           pairs.pair_idx, det.predict_logits,
                           image_sizes=batch.sizes, boxes_per_cls=dets.boxes_per_cls,
                           gumbel=gumbel, forest=forest, pair_mask=pairs.mask,
                           pred_labels=dets.labels)
        losses = _rel_losses(state, out.rel_logits, pairs.labels, pairs.mask,
                             member)
        binary_preds = getattr(out, "binary_preds", None)  # VCTree's
        if binary_preds is not None:
            losses["binary_loss"] = _binary_loss(binary_preds, pairs.binary_rel,
                                                 dets.mask)
        # VETO's obj_dists is the one-hot of the detections' labels: this
        # term moves the loss value, not the update; a legacy predictor's
        # refined logits train on it
        losses["obj_loss"] = weighted_ce_loss(out.obj_dists, samples.gt_labels,
                                              dets.mask, None)
    else:
        if gumbel is None:
            gumbel = draw_gumbel(model, batch.boxes.shape[1], batch.boxes.shape[0],
                                 state.generator)
        out = model(batch.images, batch.depth, batch.boxes, batch.box_mask,
                    batch.labels, batch.obj_logits, samples.pair_idx,
                    samples.mask, gumbel=gumbel, forest=forest)
        losses = _rel_losses(state, out.rel_logits, samples.labels,
                             samples.mask, member)
        if out.binary_preds is not None:
            losses["binary_loss"] = _binary_loss(
                out.binary_preds, binary_relatedness(batch.rel_matrix, batch.box_mask),
                batch.box_mask)
        if out.relness_logits is not None:  # BGNN's relness pre-classifier
            losses["pre_rel_classify_loss"] = rel_aware_focal_loss(
                out.relness_logits, samples.labels, samples.mask,
                model.num_rel_classes)
        if out.attribute_logits is not None:
            losses["attribute_loss"] = _attribute_loss(
                state, out.attribute_logits, batch, attribute_draws)
        if model.mode != "predcls":
            # the cross-entropy of the predictor's obj_dists against the GT
            # labels.  VETO's obj_dists is the one-hot of the NMS's labels
            # and carries no gradient, in the JAX package as here: this term
            # moves the loss value, not the update; a legacy predictor's
            # refined logits train on it.
            losses["obj_loss"] = weighted_ce_loss(out.obj_dists, batch.labels,
                                                  batch.box_mask, None)
    loss = sum(losses.values())
    loss.backward()
    return {"loss": loss.detach(), **{k: v.detach() for k, v in losses.items()}}


def train_on_pairs(state: TrainState, batch,
                   samples: Union[RelSample, DetSample], lr_scale: float,
                   member: Optional[torch.Tensor] = None,
                   attribute_draws: Optional[torch.Tensor] = None,
                   gumbel: Optional[torch.Tensor] = None) -> Dict[str, object]:
    """Forward, loss, backward and update on the given pairs (with MEET
    routed by ``member``, the attribute loss's negatives ranked by
    ``attribute_draws``, VCTree's decoder fed ``gumbel``, when given)."""
    metrics = forward_backward(state, batch, samples, member, attribute_draws,
                               gumbel)
    grad_norm = state.optimizer.step(lr_scale)
    state.step += 1
    return {**metrics, "grad_norm": grad_norm.detach(),
            "batch_stats": batch_stats(state.model)}


def train_step(state: TrainState, batch, generator: torch.Generator,
               lr_scale: float, batch_size_per_image: int = 1024,
               positive_fraction: float = 0.25, num_sample_per_gt_rel: int = 4,
               require_overlap: bool = False) -> Dict[str, object]:
    """One whole step: sample the pairs (in SGDet: detect, then sample over
    the detections with ``num_sample_per_gt_rel`` and ``require_overlap``),
    then train on them."""
    if state.model.mode == "sgdet":
        samples = sample_detections(state.model, batch, generator,
                                    batch_size_per_image, positive_fraction,
                                    num_sample_per_gt_rel, require_overlap)
    else:
        samples = sample_pairs(batch, generator, batch_size_per_image,
                               positive_fraction)
    return train_on_pairs(state, batch, samples, lr_scale)
