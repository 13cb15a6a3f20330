"""Detector pretraining entry point of the port (``tools/detector_pretrain_net.py``).

    python -m veto_tpu_torch.tools.detector_pretrain_net \\
        --config configs/veto_vg_sgdet.yaml [--device cpu] \\
        [opts, e.g. data.data_dir=/path/to/vg solver.max_iter=50000]

Trains the whole Faster R-CNN detector of the config (body, FPN, RPN and
box head; the model is built with ``train_detector=True``, weights drawn
from ``solver.seed``) on the card, or the CPU when asked, with
``solver.optimizer=sgd`` and ``solver.schedule=WarmupMultiStepLR`` unless
the options set them (the JAX tool's defaults; the step's LR multiplier is
:func:`~..solver.optim.multistep_scale` either way, as there).  Every
parameter of the model is in the optimizer, nothing frozen.

  * data: the train split of ``data.data_dir`` (VG or GQA-200 files)
    through :class:`SGGLoader` and the :class:`DeviceFeeder`, or the
    synthetic corpus when it is empty (``relation_train_net.build_dataset``);
  * a checkpoint every ``solver.checkpoint_period`` steps into
    ``output_dir/ckpt`` (model, SGD's momentum buffers, iteration, the
    samplers' generator), resume from the latest one there, a checkpoint
    on SIGTERM and a final one;
  * COCO bbox mAP of the val split every ``solver.val_period`` steps
    (:func:`run_detection_eval`; with ``test.bbox_aug_enabled`` through the
    test-time augmentation);
  * ``metrics.jsonl`` in ``output_dir`` gets the losses every 30 steps, and
    the log a line every 100.

With ``model.mask_on`` / ``model.keypoint_on`` the mask and keypoint
heads train in the same step (``loss_mask``, ``loss_kp``).  The data
follow ``data.dataset`` as in ``relation_train_net.build_dataset``: Visual
Genome, GQA-200, COCO instances (``coco_2017``, ``coco_2014``), Pascal VOC
(``VOC2007``, ``VOC2012``) and concatenations of them (``A+B``, train
only).
"""

from __future__ import annotations

import argparse
import json
import os
import time


def run_detection_eval(cfg, model, batches, log=print):
    """COCO bbox mAP of the model's detections over ``batches`` (host
    batches and records of a split): the valid detections of each image (``detect``, or with
    ``test.bbox_aug_enabled`` the test-time augmentation of
    ``test.bbox_aug_h_flip`` and ``test.bbox_aug_scales``), scaled back to
    the record's ``orig_size`` when it names one, against its GT boxes.
    The model runs in eval mode (restored after).  Returns ``{"mAP",
    "AP50", "AP75"}``."""
    from ..engine.batch import DeviceFeeder
    from ..engine.evaluate import _scale, to_numpy
    from ..evaluation.coco_map import CocoMapEvaluator

    dev = next(model.parameters()).device
    if cfg.test.bbox_aug_enabled:
        from ..engine.bbox_aug import detect_tta

        def detect(images, sizes):
            return detect_tta(model, images, sizes, hflip=cfg.test.bbox_aug_h_flip,
                              scales=cfg.test.bbox_aug_scales)[1]
    else:
        def detect(images, sizes):
            return model.detect(images, sizes).detections
    ev = CocoMapEvaluator(num_classes=cfg.model.num_obj_classes)
    was_training = model.training
    model.eval()
    try:
        for batch, recs in DeviceFeeder(batches, dev):
            dets = to_numpy(detect(batch.images, batch.sizes.float()))
            sizes = batch.sizes.cpu().numpy()
            for i, rec in enumerate(recs):
                m = dets.mask[i]
                if m.sum() == 0:
                    continue
                ev.add_image(rec["boxes"], rec["labels"],
                             dets.boxes[i][m] * _scale(rec, sizes[i]),
                             dets.labels[i][m], dets.scores[i][m])
    finally:
        model.train(was_training)
    agg = ev.aggregate()
    log(f"bbox eval: mAP {agg['mAP']:.4f}  AP50 {agg['AP50']:.4f}  "
        f"AP75 {agg['AP75']:.4f}")
    return agg


def train(cfg, device=None, log=print, model=None, datasets=None):
    """Pretrain the detector to ``solver.max_iter`` (from the latest
    checkpoint in ``output_dir/ckpt`` when there is one).  Returns the
    train state and one dict per step run: the four losses (and
    ``loss_mask`` / ``loss_kp`` with those heads), loss, grad_norm, lr_scale, seconds (batch on the device to the end of the
    update), step_seconds, wait_seconds, image_shape and, on a validation
    step, val_mAP.  ``model`` is an already built model (with
    ``train_detector=True``), ``datasets`` a (train, val) pair of
    datasets; by default both are built from ``cfg``."""
    import torch

    from ..engine import distributed
    from ..engine.batch import DeviceFeeder
    from ..engine.pretrain import (
        create_detector_state, detector_budgets, detector_train_step,
    )
    from ..models.sgg import build_model
    from ..solver.optim import multistep_scale
    from ..utils.checkpoint import CheckpointManager
    from ..utils.logger import JSONLWriter, MetricLogger
    from ..utils.preemption import PreemptionGuard
    from .relation_train_net import batches_for, build_dataset

    distributed.refuse_ranks("detector pretraining (its losses have their "
                             "own denominators)")
    solver = cfg.solver
    budgets = detector_budgets(cfg)
    train_ds, val_ds = datasets if datasets is not None else (
        build_dataset(cfg, "train"), build_dataset(cfg, "val"))
    if model is None:
        model = build_model(cfg, device, train_detector=True)
    dev = next(model.parameters()).device
    state = create_detector_state(model, solver)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"detector pretraining: {n_params / 1e6:.2f}M parameters, all trained, "
        f"{solver.optimizer} on {dev}")
    ckpt = CheckpointManager(os.path.join(cfg.output_dir, "ckpt"))
    ckpt.restore(state, log=log)
    start_iter = state.step
    if start_iter:
        log(f"resumed from iteration {start_iter}")
    scale_fn = multistep_scale(solver)
    writer = JSONLWriter(cfg.output_dir, tensorboard=cfg.tensorboard_on)
    val_gen = batches_for(cfg, val_ds, "val")
    feeder = DeviceFeeder(
        batches_for(cfg, train_ds, "train")(solver.max_iter, start_iter), dev)
    batches = iter(feeder)

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    history = []
    meters = MetricLogger()
    guard = PreemptionGuard().install()
    try:
        t_prev = time.perf_counter()
        for it, (batch, _) in enumerate(batches, start=start_iter):
            scale = scale_fn(it)
            fence()
            t0 = time.perf_counter()
            m = detector_train_step(state, batch, scale, budgets)
            fence()  # the update's launches included
            now = time.perf_counter()
            rec = {k: float(v) for k, v in m.items()}
            rec.update(lr_scale=scale, seconds=now - t0,
                       step_seconds=now - t_prev, wait_seconds=feeder.waits[-1],
                       image_shape=tuple(batch.images.shape[1:3]))
            history.append(rec)
            meters.update(time=rec["step_seconds"])
            losses = [k for k in m if k.startswith("loss_")]
            if it % 30 == 0:
                writer.write(it, {k: rec[k] for k in ("loss", *losses, "grad_norm",
                                                      "lr_scale")})
            if it % 100 == 0:
                log(f"iter {it}/{solver.max_iter}  loss {rec['loss']:.4f}  "
                    + "  ".join(f"{k} {rec[k]:.4f}" for k in losses)
                    + f"  grad_norm {rec['grad_norm']:.4f}  lr_scale {scale:.4f}  "
                    f"{rec['seconds']:.3f} s on {dev}  "
                    f"eta {meters.eta_string(it + 1, solver.max_iter)}")
            if guard.requested:
                ckpt.save(it + 1, state)
                log(f"preemption signal: checkpointed at iter {it + 1}")
                break
            if (it + 1) % solver.checkpoint_period == 0:
                ckpt.save(it + 1, state)
            if (it + 1) % solver.val_period == 0:
                agg = run_detection_eval(cfg, model, val_gen(0), log)
                rec["val_mAP"] = agg["mAP"]
                writer.write(it + 1, {"val_mAP": agg["mAP"]})
            t_prev = time.perf_counter()
    finally:
        batches.close()
        guard.restore()
    ckpt.save(state.step, state)
    log(f"detector pretraining done at iteration {state.step}")
    return state, history


def main(argv=None):
    from ..config import load_config
    from ..utils.logger import setup_logger

    parser = argparse.ArgumentParser(description="Detector pretraining "
                                                 "(PyTorch port)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("opts", nargs="*", default=[])
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.opts)
    # the JAX tool's defaults: SGD and the multistep schedule unless set
    if not any(o.startswith("solver.optimizer") for o in args.opts):
        cfg = cfg.override("solver.optimizer", "sgd")
    if not any(o.startswith("solver.schedule") for o in args.opts):
        cfg = cfg.override("solver.schedule", "WarmupMultiStepLR")
    os.makedirs(cfg.output_dir, exist_ok=True)
    cfg.dump(os.path.join(cfg.output_dir, "config.json"))
    logger = setup_logger("veto_tpu_torch.detector", cfg.output_dir)
    _, history = train(cfg, args.device, log=logger.info)
    print(json.dumps(history[-1] if history else {}))
    return history


if __name__ == "__main__":
    main()
