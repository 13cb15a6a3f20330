"""The relation loss variants (``veto_tpu/ops/losses.py``): label
smoothing, LDAM and the balanced norm, which ``relation.loss_variant``
selects in place of the weighted cross-entropy (the engine's
``_rel_losses``).  Each takes (..., C) f32 logits, (...,) labels and a
(...,) bool mask of the valid pairs, and returns a 0-d f32 loss; the
balanced norm also the new running labeling probability.  Plain PyTorch:
the JAX package computes them with XLA, outside Pallas.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _weighted_mean(nll: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                   class_weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Σ w nll / max(Σ w, 1e-6), ``w`` the mask, or the class weights of the
    labels on the valid pairs."""
    if class_weights is None:
        w = mask.float()
    else:
        w = torch.where(mask, class_weights[labels], 0.0)
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-6)


def label_smoothing_ce(logits: torch.Tensor, targets: torch.Tensor, e: float = 0.01,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The cross-entropy against ``(1 - e)`` one-hot + ``e / C`` (the
    reference's ``Label_Smoothing_Regression``), the mean over the valid
    pairs (at least one counted), or over all without a mask."""
    c = logits.shape[-1]
    smooth = F.one_hot(targets.long(), c).float() * (1.0 - e) + e / c
    nll = -(smooth * torch.log_softmax(logits.float(), dim=-1)).sum(-1)
    if mask is None:
        return nll.mean()
    w = mask.float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def ldam_margins(counts, max_m: float = 0.5) -> np.ndarray:
    """Per-class LDAM margins from the training counts: ``1 / c^(1/4)``,
    scaled so that the largest is ``max_m`` (float32)."""
    m = 1.0 / np.sqrt(np.sqrt(np.asarray(counts, np.float64)))
    return (m * (max_m / np.max(m))).astype(np.float32)


def ldam_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
              margins: torch.Tensor, s: float = 30.0,
              class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The label-distribution-aware-margin cross-entropy: the target class's
    margin taken off its logit, the (class-weighted) cross-entropy of ``s``
    times the logits over the valid pairs."""
    safe = torch.where(mask, labels, 0).long()
    onehot = F.one_hot(safe, logits.shape[-1]).float()
    x = logits.float() - onehot * margins[safe][..., None]
    logp = torch.log_softmax(s * x, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return _weighted_mean(nll, safe, mask, class_weights)


class LearnableBalancedNorm(nn.Module):
    """The relation softmax divided by a learnable per-class labeling
    probability (``sigmoid(labeling_prob_theta)``; the background's fixed
    at 1) + ``eps``; with ``normalized_probs`` the background column
    becomes 1 minus the foreground's sum."""

    def __init__(self, num_fg_classes: int = 50, eps: float = 1e-5,
                 normalized_probs: bool = False):
        super().__init__()
        self.eps, self.normalized_probs = eps, normalized_probs
        self.labeling_prob_theta = nn.Parameter(torch.zeros(num_fg_classes))

    def forward(self, relation_logits: torch.Tensor) -> torch.Tensor:
        theta = self.labeling_prob_theta
        prob = torch.cat([theta.new_ones(1), torch.sigmoid(theta)]) + self.eps
        norm = torch.softmax(relation_logits.float(), -1) / prob
        if self.normalized_probs:
            norm = torch.cat([1.0 - norm[..., 1:].sum(-1, keepdim=True),
                              norm[..., 1:]], -1)
        return norm


def balanced_norm_probs(logits: torch.Tensor, labels: torch.Tensor,
                        mask: torch.Tensor, running_prob: torch.Tensor,
                        momentum: float = 0.1, eps: float = 1e-5, train: bool = False,
                        normalized_probs: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The running-statistics balanced norm: (the softmax divided by the
    labeling probability + ``eps``, the new (C,) running probability).  In
    training each class seen among the valid foreground pairs moves its
    running probability by ``momentum`` toward the mean softmax mass the
    batch puts on it where it is the label; the background's stays 1.  The
    update carries no gradient."""
    probs = torch.softmax(logits.float(), dim=-1)
    new_prob = running_prob
    if train:
        with torch.no_grad():
            c = probs.shape[-1]
            fg = (mask & (labels > 0)).float().reshape(-1)
            safe = torch.where(mask, labels, 0).reshape(-1).long()
            onehot = F.one_hot(safe, c).float() * fg[:, None]
            mass = (probs.reshape(-1, c) * onehot).sum(0)
            cnt = onehot.sum(0)
            batch = mass / torch.clamp(cnt, min=1.0)
            new_prob = torch.where(cnt > 0, momentum * batch
                                   + (1 - momentum) * running_prob, running_prob)
            new_prob = torch.cat([new_prob.new_ones(1), new_prob[1:]])
    norm = probs / (new_prob + eps)
    if normalized_probs:
        norm = torch.cat([1.0 - norm[..., 1:].sum(-1, keepdim=True), norm[..., 1:]], -1)
    return norm, new_prob


def balanced_norm_nll(probs_norm: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor,
                      class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (class-weighted) negative log-likelihood of the renormalized
    probabilities (their log, clipped at 1e-12) over the valid pairs."""
    safe = torch.where(mask, labels, 0).long()
    logp = torch.log(torch.clamp(probs_norm, min=1e-12))
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return _weighted_mean(nll, safe, mask, class_weights)
