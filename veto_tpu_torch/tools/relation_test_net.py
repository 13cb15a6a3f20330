"""Relation evaluation entry point of the port (``tools/relation_test_net.py``).

    python -m veto_tpu_torch.tools.relation_test_net \\
        --config configs/veto_vg_predcls.yaml [--device cpu] \\
        [--split val|test] [--max-batches N] [opts ...]

Reads the YAML with the port's config loader, builds the PredCls, SGCls or
SGDet model (``configs/veto_vg_sgcls.yaml``, ``configs/veto_vg_sgdet.yaml``,
their ``gqa_`` twins) on the card (or the CPU when asked), restores the latest checkpoint in
``output_dir/ckpt`` when there is one (else the weights stay the seeded
random ones of ``solver.seed``), evaluates the split through the eval step
and the SGG evaluator, prints R@K / mR@K (in SGDet also the detections'
COCO bbox mAP) and writes ``eval_results.json`` and the summary's text,
``evaluation_res.txt`` (as the JAX tool writes it), to ``output_dir``.
The split is read from ``data.data_dir`` (VG or GQA-200 files, through
:class:`SGGLoader`); with ``data.data_dir`` empty it is the
synthetic corpus at the eval input shape: images of ``min_size_test`` x
``max_size_test`` rounded up to ``size_divisibility`` (800 x 1344 for
Visual Genome), ``data.max_boxes`` objects at most.  Zero-shot recall uses
``test.zeroshot_file`` or, from files, the triplets of the split that the
train split never has.

MEET's configurations (``configs/veto_meet_vg_predcls.yaml``,
``configs/gqa_meet_predcls.yaml``, or any with ``ensemble.enabled``) run
through MEET's eval step in every mode: each group's best predicate of
each pair competes in one ranking of the G·P candidates of an image (with
3 experts a group, after the vote of ``ensemble.voting``).

``relation.predictor`` also takes the legacy ``MotifPredictor``,
``VCTreePredictor``, ``TransformerPredictor`` and ``TransLikePredictor``
(``relation.context_hidden_dim`` / ``context_pooling_dim`` wide), each with
its MEET heads under ``ensemble.enabled`` (``*_MEET`` names, and
``TransLike_MEET``, select the same base, as in the JAX tool), and
``IMPPredictor``, ``BGNNPredictor``, ``GPSNetPredictor`` and
``MSDNPredictor`` (BGNN's relness, with ``relation.rel_aware``, rides in
the PredCls / SGCls predictions).  ``configs/vgg_vg_predcls.yaml``
evaluates VETO on the single-scale VGG-16 detector.

Not yet ported (they raise ``NotImplementedError``, naming the slice that
brings them): the output keys ``test.save_plots``,
``test.save_visual_info`` and ``global_buffer_on``, the other legacy
predictors (Causal, KERN, AGRCNN, Naive, RelatednessTest), stage-wise
recall, multi-device evaluation.  The bbox-aug test-time
augmentation (``test.bbox_aug_*``, ``engine/bbox_aug.py``) serves the
detector tools' evaluation (``detector_pretest_net``); this tool, like the
JAX package's, does not run it.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


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


def make_sgg_evaluator(cfg, train_ds=None, eval_ds=None):
    """The SGG evaluator of the config.  Zero-shot triplets come from
    ``test.zeroshot_file``, else from the two splits' annotations (cached
    as ``output_dir/zeroshot_triplets.npy``), else there are none (the
    synthetic corpus defines no triplet vocabulary)."""
    from ..evaluation.sgg_eval import (
        SGGEvaluator, compute_zeroshot_triplets, load_zeroshot_triplets_file,
        vg_longtail_parts,
    )

    if cfg.test.stagewise_eval:
        raise NotImplementedError("stage-wise recall is not ported yet")
    zs = None
    if cfg.test.zeroshot_eval and cfg.test.zeroshot_file:
        zs = load_zeroshot_triplets_file(cfg.test.zeroshot_file)
    elif (cfg.test.zeroshot_eval and hasattr(train_ds, "relationships")
          and hasattr(eval_ds, "relationships")):
        cache = os.path.join(cfg.output_dir, "zeroshot_triplets.npy")
        if os.path.exists(cache):
            zs = np.load(cache)
        else:
            zs = compute_zeroshot_triplets(train_ds, eval_ds)
            os.makedirs(cfg.output_dir, exist_ok=True)
            np.save(cache, zs)
    parts = None
    if (cfg.test.longtail_eval and cfg.relation.num_classes == 51
            and "GQA" not in cfg.data.dataset):
        parts = vg_longtail_parts(reordered=cfg.data.reorder_freq_based)
    return SGGEvaluator(mode=cfg.relation.mode,
                        num_rel_classes=cfg.relation.num_classes,
                        iou_thres=cfg.test.iou_threshold, zeroshot_triplets=zs,
                        longtail_parts=parts)


def evaluate(cfg, device=None, max_batches: int = 0, log=print, model=None,
             split: str = "test", dataset=None, train_dataset=None):
    """Evaluate ``split`` (``max_batches`` batches of it, or all of it; the
    synthetic split has 16 images, or ``max_batches`` batches' worth).
    Returns the evaluator's aggregate (in SGDet with the COCO bbox mAP under
    ``"bbox"``) and the seconds each batch took from its hand-out by the
    device feeder to its predictions back on the host
    (:func:`run_validation`).

    ``model`` is an already built :class:`SGGModel`, evaluated as it is; by
    default one is built from ``cfg`` on ``device`` and the latest
    checkpoint of ``output_dir/ckpt`` restored into it.  ``dataset`` (and
    ``train_dataset``, for the zero-shot triplets) stand in for the files."""
    from ..evaluation.coco_map import CocoMapEvaluator
    from ..models.sgg import build_model
    from ..utils.checkpoint import CheckpointManager
    from .relation_train_net import (
        batches_for, build_dataset, make_eval_fn, refuse_unserved_outputs,
        run_validation,
    )

    refuse_unserved_outputs(cfg)

    if model is None:
        model = build_model(cfg, device)
        dev = next(model.parameters()).device
        payload = CheckpointManager(os.path.join(cfg.output_dir, "ckpt")).load(
            map_location=dev)
        if payload is not None:
            model.load_state_dict(payload["model"])
            log(f"evaluating the checkpoint of step {payload['step']}")
    dev = next(model.parameters()).device
    bsz = cfg.test.ims_per_batch
    if dataset is None:
        dataset = (build_dataset(cfg, split) if cfg.data.data_dir else
                   synthetic_eval_dataset(cfg, max_batches * bsz or 16))
    if (train_dataset is None and cfg.test.zeroshot_eval and cfg.data.data_dir
            and not cfg.test.zeroshot_file):
        train_dataset = build_dataset(cfg, "train")
    step = make_eval_fn(cfg, model)
    evaluator = make_sgg_evaluator(cfg, train_dataset, dataset)
    coco = (CocoMapEvaluator(num_classes=cfg.model.num_obj_classes)
            if cfg.relation.mode == "sgdet" else None)
    agg, seconds = run_validation(model, step,
                                  batches_for(cfg, dataset, split)(0),
                                  evaluator, dev, max_batches, log, coco)
    if coco is not None:
        agg["bbox"] = det = coco.aggregate()
        log(f"detection mAP {det['mAP']:.4f}  AP50 {det['AP50']:.4f}  "
            f"AP75 {det['AP75']:.4f}")
    summary = evaluator.summary_string()
    log(summary)
    # the summary as a text file, as the JAX tool writes it
    os.makedirs(cfg.output_dir, exist_ok=True)
    with open(os.path.join(cfg.output_dir, "evaluation_res.txt"), "w") as f:
        f.write(summary + "\n")
    return agg, seconds


def main(argv=None):
    from ..config import load_config

    parser = argparse.ArgumentParser(description="VETO relation evaluation "
                                                 "(PyTorch port)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--split", default="test", choices=["val", "test"])
    parser.add_argument("--max-batches", type=int, default=0,
                        help="stop after this many batches (0 = whole split)")
    parser.add_argument("opts", nargs="*", default=[])
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.opts)
    agg, _ = evaluate(cfg, args.device, args.max_batches, split=args.split)
    out = {m: {str(k): v for k, v in vals.items()} for m, vals in agg.items()
           if m != "mR_per_class" and isinstance(vals, dict)}
    os.makedirs(cfg.output_dir, exist_ok=True)
    with open(os.path.join(cfg.output_dir, "eval_results.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({m: out[m] for m in ("R", "mR")}))
    return agg


if __name__ == "__main__":
    main()
