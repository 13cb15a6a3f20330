"""Detector evaluation entry point of the port (``tools/detector_pretest_net.py``).

    python -m veto_tpu_torch.tools.detector_pretest_net \\
        --config configs/veto_vg_sgdet.yaml [--device cpu] \\
        [--split val|test] [--checkpoint STEP] [opts ...]

Builds the pretraining model of the config (``train_detector=True``) on
the card, or the CPU when asked, restores the checkpoint of ``STEP`` (by
default the latest) from ``output_dir/ckpt`` as
``detector_pretrain_net`` writes it (with none there the weights stay the
seeded random ones of ``solver.seed``, with a warning), runs COCO bbox mAP
on the split (:func:`~.detector_pretrain_net.run_detection_eval`, with
``test.bbox_aug_enabled`` through the test-time augmentation) and writes
``bbox_eval_{split}.json`` to ``output_dir``.
"""

from __future__ import annotations

import argparse
import json
import os


def evaluate(cfg, split: str = "val", step=None, device=None, log=print,
             model=None, dataset=None):
    """The bbox mAP of the checkpoint of ``step`` (default the latest) on
    ``split``; ``model`` and ``dataset`` default to the config's."""
    from ..models.sgg import build_model
    from ..utils.checkpoint import CheckpointManager
    from .detector_pretrain_net import run_detection_eval
    from .relation_train_net import batches_for, build_dataset

    if model is None:
        model = build_model(cfg, device, train_detector=True)
    if dataset is None:
        dataset = build_dataset(cfg, split)
    payload = CheckpointManager(os.path.join(cfg.output_dir, "ckpt")).load(
        step, map_location="cpu")
    if payload is None:
        log("no checkpoint found: evaluating the seeded random weights")
    else:
        model.load_state_dict(payload["model"])
        log(f"evaluating the checkpoint of iteration {payload['step']}")
    return run_detection_eval(cfg, model, batches_for(cfg, dataset, split)(0), log)


def main(argv=None):
    from ..config import load_config
    from ..utils.logger import setup_logger

    parser = argparse.ArgumentParser(description="Detector evaluation "
                                                 "(PyTorch port)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--split", default="val", choices=["val", "test"])
    parser.add_argument("--checkpoint", type=int, default=None,
                        help="checkpoint step to load (default: the latest)")
    parser.add_argument("opts", nargs="*", default=[])
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.opts)
    os.makedirs(cfg.output_dir, exist_ok=True)
    logger = setup_logger("veto_tpu_torch.detector_eval", cfg.output_dir)
    agg = evaluate(cfg, args.split, args.checkpoint, args.device, logger.info)
    path = os.path.join(cfg.output_dir, f"bbox_eval_{args.split}.json")
    with open(path, "w") as f:
        json.dump(agg, f, indent=1)
    logger.info(f"wrote {path}")
    print(json.dumps(agg))
    return agg


if __name__ == "__main__":
    main()
