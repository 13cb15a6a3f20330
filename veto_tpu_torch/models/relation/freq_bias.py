"""Frequency bias (``veto_tpu/models/relation/freq_bias.py``): a trainable
table of predicate logits keyed by the (subject class, object class) pair,
the reference's ``FrequencyBias`` (an ``nn.Embedding`` over class pairs).

The JAX model builds it without dataset statistics, so it starts at zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FrequencyBias(nn.Module):
    """``obj_baseline`` (C * C, R): row ``s * C + o`` is the pair's bias."""

    def __init__(self, num_obj_classes: int = 151, num_rel_classes: int = 51):
        super().__init__()
        n = self.num_obj_classes = num_obj_classes
        self.num_rel_classes = num_rel_classes
        self.obj_baseline = nn.Parameter(torch.zeros(n * n, num_rel_classes))

    def forward(self, pair_labels: torch.Tensor) -> torch.Tensor:
        """(..., 2) integer (subject, object) classes → (..., R) f32 logits."""
        idx = (pair_labels[..., 0].long() * self.num_obj_classes
               + pair_labels[..., 1].long())
        return F.embedding(idx, self.obj_baseline).float()

    def index_with_probability(self, pair_prob: torch.Tensor) -> torch.Tensor:
        """The soft lookup: (..., C, 2) subject (channel 0) and object
        (channel 1) class distributions contracted with the table → (..., R)."""
        n = self.num_obj_classes
        w = self.obj_baseline.reshape(n, n, self.num_rel_classes).float()
        ps, po = pair_prob[..., 0].float(), pair_prob[..., 1].float()
        return torch.einsum("...s,sor,...o->...r", ps, w, po)
