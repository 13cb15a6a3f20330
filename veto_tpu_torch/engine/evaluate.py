"""The PredCls and SGCls evaluation step (``veto_tpu/engine/train.py``
``make_eval_step``) and its feed into the evaluator.

``eval_step(batch)`` builds every candidate pair (``prepare_test_pairs``,
capped at ``max_pairs``), runs the model, and ranks the triplets
(``postprocess_relations``); results stay padded and masked, one shape per
batch.  It runs under ``torch.inference_mode``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.relation.postprocess import RelPrediction, postprocess_relations
from ..models.relation.sampling import prepare_test_pairs
from ..models.sgg import check_mode


def make_eval_step(model, max_pairs: int = 2048, mode: str = "predcls"):
    """(SGGBatch of tensors) → RelPrediction, batched."""
    check_mode(mode)
    if mode != model.mode:
        raise ValueError(f"mode {mode!r} for a model built for {model.mode!r}")

    @torch.inference_mode()
    def eval_step(batch) -> RelPrediction:
        scores = batch.box_mask.float()
        pair_idx, pair_mask = prepare_test_pairs(batch.box_mask, scores,
                                                 max_pairs=max_pairs)
        out = model(batch.images, batch.depth, batch.boxes, batch.box_mask,
                    batch.labels, batch.obj_logits, pair_idx, pair_mask)
        # the post-processor reads the proposals' predict_logits (the ±1000
        # GT injection in PredCls, the frozen box head's logits in SGCls),
        # not the predictor's obj_dists
        return postprocess_relations(out.rel_logits, out.predict_logits,
                                     pair_idx, pair_mask)

    return eval_step


def to_numpy(preds: RelPrediction) -> RelPrediction:
    return RelPrediction(*[t.detach().cpu().numpy() for t in preds])


def accumulate_eval(preds: RelPrediction, recs, evaluator) -> None:
    """Feed one batch of padded predictions (numpy) into ``evaluator``, one
    image per record (``accumulate_eval``'s gt-box branch in the JAX tool)."""
    for i, rec in enumerate(recs):
        n = len(rec["boxes"])
        pm = np.asarray(preds.pair_mask[i], bool)
        evaluator.add_image(
            rec["boxes"], rec["labels"], rec["rel_tuples"], rec["boxes"],
            preds.obj_labels[i][:n], preds.obj_scores[i][:n],
            preds.pair_idx[i][pm], preds.rel_scores[i][pm])
