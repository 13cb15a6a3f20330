"""The ROI attribute head (``veto_tpu/models/detector/attribute_head.py``;
``model.attribute_on``): one linear ``att_score`` over the box head's fc7
features, and a multi-label loss over the Visual Genome attribute
vocabulary (201 ids, 10 padded slots a box).

Fixed shapes, as in the JAX package: every box keeps a row; the rows with
an attribute weigh 1, the sampled negatives weigh 1 (at most
``bgfg_ratio`` times the positives, 1 when there are none), every other row
0, and the loss is the weighted sum over the count of selected rows.  The
negatives are the live rows without attributes whose uniforms rank lowest:
the caller passes the uniforms (the train step draws them from its
generator; a test passes the JAX package's ``jax.random`` draw).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Dense


class AttributePredictor(nn.Module):
    """``att_score``: (..., in_features) → (..., num_attributes) f32 logits,
    the product in ``dtype``."""

    def __init__(self, in_features: int, num_attributes: int = 201,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.att_score = Dense(in_features, num_attributes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.att_score(x).float()


def attribute_targets(attributes: torch.Tensor,
                      num_attributes: int = 201) -> torch.Tensor:
    """(N, 10) padded attribute ids → (N, A) f32 multi-hot of the ids before
    the first 0 slot (the cumulative live mask: an id after a 0 counts
    not)."""
    live = torch.cumprod((attributes != 0).int(), dim=-1).bool()
    onehot = F.one_hot(attributes.long(), num_attributes).float()
    return torch.where(live[..., None], onehot, 0.0).amax(dim=-2)


class AttributeLossOut(NamedTuple):
    loss: torch.Tensor
    num_pos: torch.Tensor


def attribute_loss(logits: torch.Tensor, attributes: torch.Tensor,
                   valid: torch.Tensor, uniforms: Optional[torch.Tensor] = None,
                   loss_weight: float = 0.1, bgfg_sample: bool = True,
                   bgfg_ratio: int = 3, use_binary_loss: bool = True,
                   pos_weight: float = 5.0) -> AttributeLossOut:
    """(N, A) logits, (N, 10) attribute ids, (N,) live rows and, with
    ``bgfg_sample``, (N,) uniforms in [0, 1) that rank the negatives → the
    loss times ``loss_weight``, and the count of rows with an attribute.

    Binary (``use_binary_loss``): BCE with logits, the positive entries'
    ``-log sigmoid`` term weighted ``pos_weight``, each row's mean over the
    A columns.  Otherwise the soft cross-entropy: rows without an
    attribute target column 0, each row's ``-log_softmax`` weighted by its
    targets over their sum."""
    targets = attribute_targets(attributes, logits.shape[-1])
    has_attr = (targets.sum(-1) > 0) & valid
    is_neg = ~has_attr & valid
    num_pos = has_attr.sum()
    if bgfg_sample:
        budget = torch.where(num_pos > 0, bgfg_ratio * num_pos, 1)
        keyed = torch.where(is_neg, uniforms.float(), torch.inf)
        rank = torch.argsort(torch.argsort(keyed, stable=True), stable=True)
        neg_sel = is_neg & (rank < budget)
    else:
        neg_sel = is_neg
    selected = has_attr | neg_sel
    n_sel = torch.clamp(selected.sum(), min=1)
    logits = logits.float()
    if use_binary_loss:
        bce = (torch.clamp(logits, min=0) - logits * targets
               + torch.log1p(torch.exp(-logits.abs())))
        bce = bce + (pos_weight - 1.0) * targets * -F.logsigmoid(logits)
        per_row = bce.mean(-1)
    else:
        col0 = torch.where(has_attr, targets[:, 0], 1.0)
        soft = torch.cat([col0[:, None], targets[:, 1:]], 1)
        per_row = -(torch.log_softmax(logits, -1) * soft).sum(-1) / torch.clamp(
            soft.sum(-1), min=1e-12)
    loss = torch.where(selected, per_row, 0.0).sum() / n_sel
    return AttributeLossOut(loss * loss_weight, num_pos)
