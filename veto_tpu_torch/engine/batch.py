"""The batch container (``veto_tpu/engine/batch.py`` ``SGGBatch``).

Fixed-shape, mask-carrying arrays, padded by the loader to static budgets.
Host side it holds numpy arrays; :meth:`SGGBatch.to` makes the torch
tensors a step runs on.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch


@dataclass
class SGGBatch:
    images: Any      # (B, H, W, 3) float32, normalized
    depth: Any       # (B, H, W, 1) float32
    boxes: Any       # (B, N, 4) xyxy in padded-image pixel coords
    box_mask: Any    # (B, N) bool
    labels: Any      # (B, N) int32 object classes (0 = bg/pad)
    obj_logits: Any  # (B, N, num_obj) detector logits (PredCls: one-hot)
    rel_matrix: Any  # (B, N, N) int32 GT predicate matrix (0 = none)
    sizes: Any       # (B, 2) int32 (width, height) before padding

    def to(self, device) -> "SGGBatch":
        """The same batch as torch tensors on ``device``."""
        return SGGBatch(**{f.name: torch.as_tensor(getattr(self, f.name)).to(device)
                           for f in dataclasses.fields(self)})
