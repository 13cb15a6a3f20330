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
bit-equal.

The loss variants (``create_train_state(loss_variant=)``, the tools'
``relation.loss_variant``, ``relation.label_smoothing=True`` an alias of
``label_smoothing``): ``rel_loss`` is then the label-smoothed
cross-entropy, LDAM's margin cross-entropy (``ldam_margins`` from the
predicate counts, the Rwt class weights) or the balanced norm's NLL (the
class weights too), as ``ops/losses.py`` computes them.  The balanced norm
keeps its running labeling probability in ``state.loss_state`` (C,) f32,
0.03 with the background pinned at 1 at the start, moved by each step's
forward without a gradient; the checkpoint carries it.  MEET's losses
override the variant, as in the JAX step.

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
padded pairs); IMP, Naive and RelatednessTest also embed ``pred_labels``
(the box head's NMS labels in SGCls, the detections' own in SGDet).  BGNN
and MSDN with ``rel_aware``, and RelatednessTest, add
``pre_rel_classify_loss`` in PredCls and SGCls, the focal loss of their
relness pre-classifier against the sampled pairs' labels
(``rel_proposal.rel_aware_focal_loss``); the JAX SGDet step adds none, and
neither does the port's.  The causal predictor with an effect updates its
untreated moving averages (buffers) in the forward, and ``batch_stats``
reports them beside the BatchNorms' statistics.

Attributes (a model with ``attribute_on``, PredCls and SGCls, as in the
JAX package): ``attribute_loss`` over every box's attribute list joins the
losses, with ``state.attribute_cfg`` (``create_train_state(attribute_cfg=)``,
the tools pass ``model.attribute_*``); its negatives rank one uniform a
box drawn from ``state.generator`` after the other draws of the step (or
``attribute_draws=``).  ``att_score`` trains; the frozen box head's fc6 /
fc7 under it take no gradient, and ``grad_norm`` counts none for them
(the JAX step's global norm counts the gradient its attribute loss sends
into that frozen box head: ROADMAP queue C).

Data parallelism (``create_train_state(dp=)``, a
``distributed.DataParallel``; the step takes the ranks from its state):
each of W ranks runs the step on its ``1/W`` of the global batch, and the
W ranks compute what one process computes on the whole of it.  The
samplers and MEET's routing draw at the global batch's size and keep this
rank's rows; the BatchNorms take the global batch's statistics; every
loss divides this rank's numerator by the global denominator; after the
backward one flattened f32 all-reduce sums the gradients and the losses
over the ranks (a sum, not DDP's mean), so ``loss``, ``grad_norm``, the
clip and the update are the global step's, alike on every rank.

``collect_diagnostics`` (the tools' ``global_buffer_on``) adds, for a
predictor with relness logits (BGNN or MSDN with ``relation.rel_aware``,
RelatednessTest),
the JAX step's diagnostics under ``buffer``: ``rel_pn-train_y`` (the
sampled pairs' foreground), ``rel_pn-train_pred`` (the sigmoid of the
relness logit) and ``mask``, this rank's rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Union

import torch
from torch import nn

from ..models.detector.attribute_head import attribute_loss
from ..models.detector.box_head import assign_labels_to_proposals
from ..models.relation.legacy.causal import UNTREATED
from ..models.relation.predictor_meet import MeetConfig, meet_losses
from ..models.relation.predictor_veto import weighted_ce_loss
from ..models.relation.rel_proposal import rel_aware_focal_loss
from ..models.relation.sampling import (
    DetRelSample, RelSample, binary_relatedness, detect_relsample, gtbox_relsample,
)
from ..models.sgg import DetectOutput, check_mode
from ..ops.losses import (
    balanced_norm_nll, balanced_norm_probs, label_smoothing_ce, ldam_loss,
)
from ..solver.optim import FROZEN_DETECTOR, Optimizer, make_optimizer
from .distributed import DataParallel, all_reduce_grads, attach

LOSS_VARIANTS = ("weighted_ce", "label_smoothing", "ldam", "balanced_norm")


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    class_weights: Optional[torch.Tensor] = None  # (num_rel,) or None
    step: int = 0  # updates applied so far
    generator: Optional[torch.Generator] = None  # the pair sampler's
    meet: Optional[MeetConfig] = None  # its constants on the model's device
    attribute_cfg: Optional[dict] = None  # attribute_loss's keyword arguments
    dp: Optional[DataParallel] = None  # the ranks of a data-parallel step
    loss_variant: str = "weighted_ce"  # one of LOSS_VARIANTS
    ldam_margins: Optional[torch.Tensor] = None  # (num_rel,) with "ldam"
    # the balanced norm's running labeling probability (num_rel,) f32
    loss_state: Optional[torch.Tensor] = None


def create_train_state(model: nn.Module, solver_cfg, class_weights=None,
                       mode: str = "predcls", loss_variant: str = "weighted_ce",
                       meet=None, attribute_cfg: Optional[dict] = None,
                       dp: Optional[DataParallel] = None,
                       ldam_margins=None) -> TrainState:
    """The state of a training run over ``model``'s parameters; ``meet`` (a
    :class:`MeetConfig`) trains MEET's per-group losses, and then the
    class weights are not used; ``attribute_cfg`` holds
    :func:`attribute_loss`'s keyword arguments (its defaults when None)
    for a model with ``attribute_on``; ``dp`` the ranks of a data-parallel
    step (its BatchNorms are given them).  ``loss_variant`` is one of
    :data:`LOSS_VARIANTS`; ``"ldam"`` needs ``ldam_margins`` (C,)
    (``ops.losses.ldam_margins`` of the predicate counts), and
    ``"balanced_norm"`` starts ``loss_state`` at 0.03, the background's
    at 1."""
    check_mode(mode)
    if mode != model.mode:
        raise ValueError(f"mode {mode!r} for a model built for {model.mode!r}")
    if loss_variant not in LOSS_VARIANTS:
        raise ValueError(f"loss variant {loss_variant!r}: expected one of "
                         f"{LOSS_VARIANTS}")
    if loss_variant == "ldam" and ldam_margins is None:
        raise ValueError("the ldam loss variant needs ldam_margins")
    dev = next(model.parameters()).device
    cw = None if class_weights is None else torch.as_tensor(
        class_weights, dtype=torch.float32, device=dev)
    margins = None if ldam_margins is None else torch.as_tensor(
        ldam_margins, dtype=torch.float32, device=dev)
    loss_state = None
    if loss_variant == "balanced_norm":
        loss_state = torch.full((model.num_rel_classes,), 0.03, device=dev)
        loss_state[0] = 1.0
    if meet is not None:
        meet = meet._replace(
            incre_idx=torch.as_tensor(meet.incre_idx, device=dev),
            sample_rate=torch.as_tensor(meet.sample_rate, device=dev))
    attach(model, dp)
    return TrainState(model, make_optimizer(solver_cfg, model), cw, meet=meet,
                      attribute_cfg=attribute_cfg, dp=dp, loss_variant=loss_variant,
                      ldam_margins=margins, loss_state=loss_state)


def sample_pairs(batch, generator: torch.Generator,
                 batch_size_per_image: int = 1024,
                 positive_fraction: float = 0.25,
                 dp: Optional[DataParallel] = None) -> RelSample:
    """The step's training pairs of each image of ``batch`` (tensors); under
    ``dp`` this rank's rows of the global batch's draw."""
    return gtbox_relsample(batch.rel_matrix, batch.box_mask, generator,
                           batch_size_per_image, positive_fraction, dp)


class DetSample(NamedTuple):
    """SGDet's half-step input: the detections and the pairs over them."""
    det: DetectOutput
    gt_labels: torch.Tensor  # (B, D) int32 labels of the matched GT boxes
    pairs: DetRelSample


def sample_detections(model: nn.Module, batch, generator: torch.Generator,
                      batch_size_per_image: int = 1024,
                      positive_fraction: float = 0.25,
                      num_sample_per_gt_rel: int = 4,
                      require_overlap: bool = False,
                      dp: Optional[DataParallel] = None) -> DetSample:
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
        require_overlap=require_overlap, dp=dp)
    return DetSample(det, gt_labels, pairs)


def batch_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Copies of the running statistics of the trainable BatchNorms and of
    the causal predictor's untreated averages (the JAX step's
    ``batch_stats``)."""
    return {name: buf.detach().clone() for name, buf in model.named_buffers()
            if name.rsplit(".", 1)[-1] in ("running_mean", "running_var") + UNTREATED
            and not name.startswith(FROZEN_DETECTOR)}


def _rel_losses(state: TrainState, rel_logits, labels, mask,
                member=None) -> Dict[str, torch.Tensor]:
    """``rel_loss``: the Rwt weighted cross-entropy, or the state's loss
    variant (the balanced norm moves ``state.loss_state``); with MEET the
    per-group cross-entropies instead, routed by ``member`` when given,
    else by a draw from ``state.generator``."""
    if state.meet is None:
        cw, variant = state.class_weights, state.loss_variant
        if variant == "label_smoothing":
            loss = label_smoothing_ce(rel_logits, torch.where(mask, labels, 0), mask=mask)
        elif variant == "ldam":
            loss = ldam_loss(rel_logits, labels, mask, state.ldam_margins,
                             class_weights=cw)
        elif variant == "balanced_norm":
            probs, state.loss_state = balanced_norm_probs(
                rel_logits, labels, mask, state.loss_state, train=True)
            loss = balanced_norm_nll(probs, labels, mask, cw)
        else:
            loss = weighted_ce_loss(rel_logits, labels, mask, cw, state.dp)
        return {"rel_loss": loss}
    if member is None and state.generator is None:
        raise ValueError("MEET's routing draws from state.generator: set it")
    m = state.meet
    return meet_losses(state.generator, rel_logits, labels, mask, m.incre_idx,
                       m.sample_rate, m.group_sizes, member=member, dp=state.dp)


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
                     forest=None,
                     collect_diagnostics: bool = False) -> Dict[str, object]:
    """Train-mode forward and the loss's backward on the given pairs: the
    trainable parameters' ``.grad`` hold the step's gradients.  Returns the
    losses, detached: ``loss`` (their sum), ``rel_loss`` (with MEET the
    ``group_*`` losses instead; ``member``, (B, P, G) bool, routes the
    pairs in place of a draw), with ``attribute_on`` ``attribute_loss``
    (``attribute_draws``, (B * N,) uniforms, rank its negatives in place of
    a draw), outside PredCls ``obj_loss`` and for VCTree ``binary_loss``
    (its SGCls / SGDet decoder's noise ``gumbel`` (B, N, C - 1) in place of
    a draw; ``forest`` in place of the one it builds); with
    ``collect_diagnostics`` and relness logits, the ``buffer``
    diagnostics.  Under ``state.dp`` the losses are this rank's shares."""
    model = state.model
    model.train()
    state.optimizer.zero_grad()
    legacy = getattr(model, "legacy", False)
    diagnostics = None
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
                                              dets.mask, None, state.dp)
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
        if out.relness_logits is not None:  # the relness pre-classifier
            losses["pre_rel_classify_loss"] = rel_aware_focal_loss(
                out.relness_logits, samples.labels, samples.mask,
                model.num_rel_classes, dp=state.dp)
            if collect_diagnostics:
                diagnostics = {
                    "rel_pn-train_y": samples.labels > 0,
                    "rel_pn-train_pred": torch.sigmoid(
                        out.relness_logits[..., -1].detach().float()),
                    "mask": samples.mask}
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
                                                  batch.box_mask, None, state.dp)
    loss = sum(losses.values())
    loss.backward()
    metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in losses.items()}}
    if diagnostics is not None:
        metrics["buffer"] = diagnostics
    return metrics


def train_on_pairs(state: TrainState, batch,
                   samples: Union[RelSample, DetSample], lr_scale: float,
                   member: Optional[torch.Tensor] = None,
                   attribute_draws: Optional[torch.Tensor] = None,
                   gumbel: Optional[torch.Tensor] = None,
                   collect_diagnostics: bool = False) -> Dict[str, object]:
    """Forward, loss, backward and update on the given pairs (with MEET
    routed by ``member``, the attribute loss's negatives ranked by
    ``attribute_draws``, VCTree's decoder fed ``gumbel``, when given).
    Under ``state.dp`` the samples are this rank's rows, and the gradients
    and losses are summed over the ranks before the update."""
    metrics = forward_backward(state, batch, samples, member, attribute_draws,
                               gumbel, collect_diagnostics=collect_diagnostics)
    if state.dp is not None:
        names = [k for k in metrics if k != "buffer"]
        summed = all_reduce_grads(state.optimizer.params, state.dp.group,
                                  extra=[metrics[k] for k in names])
        metrics.update(zip(names, summed))
    grad_norm = state.optimizer.step(lr_scale)
    state.step += 1
    return {**metrics, "grad_norm": grad_norm.detach(),
            "batch_stats": batch_stats(state.model)}


def train_step(state: TrainState, batch, generator: torch.Generator,
               lr_scale: float, batch_size_per_image: int = 1024,
               positive_fraction: float = 0.25, num_sample_per_gt_rel: int = 4,
               require_overlap: bool = False,
               collect_diagnostics: bool = False) -> Dict[str, object]:
    """One whole step: sample the pairs (in SGDet: detect, then sample over
    the detections with ``num_sample_per_gt_rel`` and ``require_overlap``),
    then train on them; under ``state.dp`` the ranks' step over the global
    batch."""
    if state.model.mode == "sgdet":
        samples = sample_detections(state.model, batch, generator,
                                    batch_size_per_image, positive_fraction,
                                    num_sample_per_gt_rel, require_overlap,
                                    state.dp)
    else:
        samples = sample_pairs(batch, generator, batch_size_per_image,
                               positive_fraction, state.dp)
    return train_on_pairs(state, batch, samples, lr_scale,
                          collect_diagnostics=collect_diagnostics)
