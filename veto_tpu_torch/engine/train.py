"""The PredCls train step (``veto_tpu/engine/train.py`` ``make_train_step``),
weighted cross-entropy variant.

One step samples the training pairs of each image (``gtbox_relsample``),
runs the model in train mode, takes the Rwt beta-weighted cross-entropy
over the sampled pairs, back-propagates (through the encoder's and the
ROIAlign's backward kernels on the card) and applies the clipped Adam
update.  The step is split in two so that a test can feed the JAX
package's own samples to the second half:

    samples = sample_pairs(batch, generator)
    metrics = train_on_pairs(state, batch, samples, lr_scale)

``metrics`` holds ``loss``, ``rel_loss`` and ``grad_norm`` (the global norm
of all gradients before clipping, as ``optax.global_norm``) as 0-d tensors
on the device, and ``batch_stats``, copies of the BatchNorm running
statistics after the step.  The other loss variants (label smoothing, LDAM,
balanced norm) and MEET raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..models.relation.predictor_veto import weighted_ce_loss
from ..models.relation.sampling import RelSample, gtbox_relsample
from ..solver.optim import FROZEN_DETECTOR, Optimizer, make_optimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    class_weights: Optional[torch.Tensor] = None  # (num_rel,) or None
    step: int = 0  # updates applied so far
    generator: Optional[torch.Generator] = None  # the pair sampler's


def create_train_state(model: nn.Module, solver_cfg, class_weights=None,
                       mode: str = "predcls", loss_variant: str = "weighted_ce",
                       meet=None) -> TrainState:
    """The state of a PredCls training run over ``model``'s parameters."""
    if mode != "predcls":
        raise NotImplementedError(f"mode {mode!r}: SGCls and SGDet training "
                                  "come in later slices")
    if meet is not None:
        raise NotImplementedError("MEET training comes in a later slice")
    if loss_variant != "weighted_ce":
        raise NotImplementedError(f"loss variant {loss_variant!r}: the port "
                                  "trains with the weighted cross-entropy")
    dev = next(model.parameters()).device
    cw = None if class_weights is None else torch.as_tensor(
        class_weights, dtype=torch.float32, device=dev)
    return TrainState(model, make_optimizer(solver_cfg, model), cw)


def sample_pairs(batch, generator: torch.Generator,
                 batch_size_per_image: int = 1024,
                 positive_fraction: float = 0.25) -> RelSample:
    """The step's training pairs of each image of ``batch`` (tensors)."""
    return gtbox_relsample(batch.rel_matrix, batch.box_mask, generator,
                           batch_size_per_image, positive_fraction)


def batch_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Copies of the running statistics of the trainable BatchNorms."""
    return {name: buf.detach().clone() for name, buf in model.named_buffers()
            if name.rsplit(".", 1)[-1] in ("running_mean", "running_var")
            and not name.startswith(FROZEN_DETECTOR)}


def forward_backward(state: TrainState, batch, samples: RelSample) -> torch.Tensor:
    """Train-mode forward and the loss's backward on the given pairs: the
    trainable parameters' ``.grad`` hold the step's gradients.  Returns the
    relation loss (with VETO in PredCls, the whole loss)."""
    model = state.model
    model.train()
    state.optimizer.zero_grad()
    out = model(batch.images, batch.depth, batch.boxes, batch.box_mask,
                batch.labels, batch.obj_logits, samples.pair_idx, samples.mask)
    rel_loss = weighted_ce_loss(out.rel_logits, samples.labels, samples.mask,
                                state.class_weights)
    rel_loss.backward()
    return rel_loss.detach()


def train_on_pairs(state: TrainState, batch, samples: RelSample,
                   lr_scale: float) -> Dict[str, object]:
    """Forward, loss, backward and update on the given pairs."""
    rel_loss = loss = forward_backward(state, batch, samples)
    grad_norm = state.optimizer.step(lr_scale)
    state.step += 1
    return {"loss": loss, "rel_loss": rel_loss, "grad_norm": grad_norm.detach(),
            "batch_stats": batch_stats(state.model)}


def train_step(state: TrainState, batch, generator: torch.Generator,
               lr_scale: float, batch_size_per_image: int = 1024,
               positive_fraction: float = 0.25) -> Dict[str, object]:
    """One whole step: sample the pairs, then train on them."""
    samples = sample_pairs(batch, generator, batch_size_per_image,
                           positive_fraction)
    return train_on_pairs(state, batch, samples, lr_scale)
