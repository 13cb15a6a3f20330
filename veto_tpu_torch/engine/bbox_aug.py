"""Detection test-time augmentation (``veto_tpu/engine/bbox_aug.py``,
``test.bbox_aug_*``).

The detection cascade runs on the identity batch, its horizontal flip
(each image mirrored within its own width; the JAX package mirrors the
padded batch whole, which moves a narrower image into the padding) and
each rescale; every run's candidates (softmax scores and clipped per-class
boxes of every proposal, :meth:`SGGModel.detect_candidates`) are mapped
back to the identity frame, concatenated along the proposal axis, and the
box filter (``filter_decoded_boxes``: per-class NMS, the duplicate
filter) runs once on the merged set, the reference's merge-then-filter
order.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.detector.box_head import Detections, filter_decoded_boxes


def hflip_images(images: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """A (B, H, W, C) batch padded on the right, each image mirrored within
    its own width (``widths``, (B,)) and its padding left in place: the
    batch of the images flipped before padding.  (Flipping the padded
    batch whole would move image ``i`` to columns ``[W - w_i, W)``, off the
    frame its size and ``hflip_boxes`` assume.)"""
    out = images.clone()
    for i, w in enumerate(widths.round().long().tolist()):
        out[i, :, :w] = torch.flip(images[i, :, :w], dims=[1])
    return out


def hflip_boxes(boxes: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """Mirror xyxy boxes (..., 4) in images of ``widths`` (broadcast against
    the boxes' leading axes): ``x' = W - 1 - x`` (``BoxList.transpose``)."""
    w = widths.reshape(widths.shape + (1,) * (boxes.dim() - widths.dim() - 1))
    return torch.stack([w - 1.0 - boxes[..., 2], boxes[..., 1],
                        w - 1.0 - boxes[..., 0], boxes[..., 3]], dim=-1)


def resize_images(images: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) → (B, h, w, C) linear resampling with half-pixel centres
    that antialiases when it shrinks: ``jax.image.resize(..., "linear")``."""
    x = F.interpolate(images.permute(0, 3, 1, 2), size=size, mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def detect_tta(model, images: torch.Tensor, image_sizes: torch.Tensor,
               hflip: bool = True, scales: Sequence[float] = ()
               ) -> Tuple[Tuple[torch.Tensor, ...], Detections, torch.Tensor]:
    """The identity batch's FPN maps, the merged detections and their
    logits (``log`` of the merged scores, clipped at 1e-12) for NHWC
    ``images`` and their (B, 2) = (w, h) sizes, outside autograd.  A scale
    ``s`` runs the padded batch resized to ``round(H s) x round(W s)``
    with sizes ``s`` times the originals, and its boxes divided by ``s``."""
    with torch.no_grad():
        sizes = image_sizes.float()
        feats, prob, bpc, mask = model.detect_candidates(images, sizes)
        probs, bpcs, masks = [prob], [bpc], [mask]
        if hflip:
            _, p_f, b_f, m_f = model.detect_candidates(
                hflip_images(images, sizes[:, 0]), sizes)
            probs.append(p_f)
            bpcs.append(hflip_boxes(b_f, sizes[:, 0, None, None]))
            masks.append(m_f)
        h, w = images.shape[1:3]
        for scale in scales:
            scaled = resize_images(images, (int(round(h * scale)),
                                            int(round(w * scale))))
            _, p_s, b_s, m_s = model.detect_candidates(scaled, sizes * scale)
            probs.append(p_s)
            # a tensor divisor: a card divides by a Python float as a
            # multiply by its rounded reciprocal
            bpcs.append(b_s / torch.full((), scale, device=b_s.device))
            masks.append(m_s)
        prob_all = torch.cat(probs, 1)
        dets = filter_decoded_boxes(prob_all, torch.cat(bpcs, 1),
                                    torch.cat(masks, 1), **model.box_cfg)
        idx = dets.orig_idx.long()[..., None].expand(-1, -1, prob_all.shape[-1])
        logits = torch.gather(torch.log(prob_all.clamp(min=1e-12)), 1, idx)
        return feats, dets, logits
