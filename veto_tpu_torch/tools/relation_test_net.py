"""Relation evaluation entry point of the port (``tools/relation_test_net.py``).

    python -m veto_tpu_torch.tools.relation_test_net \\
        --config configs/veto_vg_predcls.yaml [--device cpu] \\
        [--max-batches N] [opts ...]

Reads the YAML with the port's config loader, builds the PredCls model on
the card (or the CPU when asked) with weights drawn from
``solver.seed``, evaluates the test split through the eval step and the
SGG evaluator, and prints R@K / mR@K.  With ``data.data_dir`` empty the
split is the synthetic corpus at the eval input shape: images of
``min_size_test`` x ``max_size_test`` rounded up to ``size_divisibility``
(800 x 1344 for Visual Genome), ``data.max_boxes`` objects at most.

Not yet ported (they raise): the Visual Genome loader, restoring a
checkpoint (a non-empty ``output_dir/ckpt`` raises rather than being
ignored), loading ``test.zeroshot_file``, SGCls/SGDet, MEET, other
predictors, multi-device evaluation.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def synthetic_eval_dataset(cfg, num_images: int = 16):
    """The synthetic test split at the config's eval input shape."""
    from ..data.synthetic import SyntheticSGGDataset

    div = cfg.data.size_divisibility

    def up(v):
        return -(-v // div) * div

    return SyntheticSGGDataset(
        num_images=num_images, image_size=(up(cfg.data.min_size_test),
                                   up(cfg.data.max_size_test)),
        num_obj_classes=cfg.model.num_obj_classes,
        num_rel_classes=cfg.relation.num_classes,
        max_objects=cfg.data.max_boxes, seed=cfg.solver.seed + 7)


def make_sgg_evaluator(cfg):
    from ..evaluation.sgg_eval import SGGEvaluator, vg_longtail_parts

    if cfg.test.stagewise_eval:
        raise NotImplementedError("stage-wise recall is not ported yet")
    if cfg.test.zeroshot_eval and cfg.test.zeroshot_file:
        raise NotImplementedError(
            f"test.zeroshot_file={cfg.test.zeroshot_file!r}: loading the "
            "zero-shot triplets comes with slice A8b; leave it empty")
    parts = None
    if (cfg.test.longtail_eval and cfg.relation.num_classes == 51
            and "GQA" not in cfg.data.dataset):
        parts = vg_longtail_parts(reordered=cfg.data.reorder_freq_based)
    # zero-shot recall needs the training split's triplets, which the
    # synthetic corpus does not define
    return SGGEvaluator(mode=cfg.relation.mode,
                        num_rel_classes=cfg.relation.num_classes,
                        iou_thres=cfg.test.iou_threshold, longtail_parts=parts)


def evaluate(cfg, device=None, max_batches: int = 0, log=print, model=None):
    """Evaluate the synthetic test split (``max_batches`` batches of it, or
    16 images).  Returns the evaluator's aggregate and the seconds each
    batch took from its host arrays to its predictions back on the host.

    ``model`` is an already built :class:`SGGModel`; by default one is
    built from ``cfg`` on ``device``."""
    from ..engine.evaluate import accumulate_eval, make_eval_step, to_numpy
    from ..models.sgg import build_model

    if cfg.data.data_dir:
        raise NotImplementedError("the Visual Genome loader comes in a later "
                                  "slice; leave data.data_dir empty")
    if model is None:
        ckpt = os.path.join(cfg.output_dir, "ckpt")
        if os.path.isdir(ckpt) and os.listdir(ckpt):
            raise NotImplementedError(
                f"{ckpt} holds a checkpoint: restoring it comes with slice "
                "A8c, and evaluating seeded random weights in its place would "
                "report the wrong model")
        model = build_model(cfg, device)
    dev = next(model.parameters()).device
    step = make_eval_step(model, max_pairs=cfg.relation.max_proposal_pairs,
                          mode=cfg.relation.mode)
    evaluator = make_sgg_evaluator(cfg)
    bsz = cfg.test.ims_per_batch
    ds = synthetic_eval_dataset(cfg, max_batches * bsz if max_batches else 16)
    seconds = []
    for i, (batch, recs) in enumerate(ds.batches(bsz, cfg.data.max_boxes)):
        t0 = time.perf_counter()
        preds = to_numpy(step(batch.to(dev)))
        seconds.append(time.perf_counter() - t0)
        log(f"batch {i}: {len(recs)} images, {seconds[-1]:.3f} s on {dev}")
        accumulate_eval(preds, recs, evaluator)
    log(evaluator.summary_string())
    return evaluator.aggregate(), seconds


def main(argv=None):
    from ..config import load_config

    parser = argparse.ArgumentParser(description="VETO relation evaluation "
                                                 "(PyTorch port)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--max-batches", type=int, default=0,
                        help="stop after this many batches (0 = whole split)")
    parser.add_argument("opts", nargs="*", default=[])
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.opts)
    agg, _ = evaluate(cfg, args.device, args.max_batches)
    print(json.dumps({m: {str(k): v for k, v in agg[m].items()}
                      for m in ("R", "mR")}))
    return agg


if __name__ == "__main__":
    main()
