"""Relation training entry point of the port (``tools/relation_train_net.py``).

    python -m veto_tpu_torch.tools.relation_train_net \\
        --config configs/veto_vg_predcls.yaml [--device cpu] \\
        [opts, e.g. data.data_dir=/path/to/vg solver.max_iter=125000]

Reads the YAML with the port's config loader, builds the PredCls model on
the card (or the CPU when asked) with weights drawn from ``solver.seed``,
imports ``model.pretrained_detector_ckpt`` into the frozen detector when
set, and trains the depth backbone and the relation head:

  * data: the Visual Genome (or GQA-200) files under ``data.data_dir``
    through :class:`SGGLoader` (800 x 1344 and 1344 x 800 buckets at the
    VG sizes) and the :class:`DeviceFeeder` (pinned, non-blocking copies
    one batch ahead); with ``data.data_dir`` empty, the synthetic corpus at
    the train input shape;
  * a checkpoint every ``solver.checkpoint_period`` steps into
    ``output_dir/ckpt``, and resume from the latest one there (model, Adam,
    iteration, the sampler's generator, the ``LRController`` fields); as in
    the JAX tool the resumed run restarts the data stream at its first
    batch, it does not continue the interrupted one;
  * validation on the val split every ``solver.val_period`` steps; its
    mR@100 drives the plateau decay and the early stop;
  * SIGTERM: the step in flight finishes, a checkpoint is saved at the
    next iteration and the run ends cleanly; a final checkpoint at the end.

Each step logs the loss, the gradient norm, the LR scale and its seconds:
``seconds`` from its batch on the device to the end of its update,
``step_seconds`` from the end of the previous update to the end of this
one (waiting on the loader included), ``wait_seconds`` the part spent
waiting for the batch.  ``metrics.jsonl`` in ``output_dir`` gets the
losses every 30 steps and each validation's mR@100.

Not yet ported (they raise): SGCls/SGDet, MEET, the attribute/mask/keypoint
heads, the other loss variants, COCO/VOC (A13) and Open Images (A14) data,
multi-device training.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

_CTRL_FIELDS = ("best", "bad_epochs", "cooldown_counter", "num_decays")


def synthetic_train_dataset(cfg, num_images: int = 64):
    """The synthetic train split at the config's train input shape."""
    from ..data.synthetic import SyntheticSGGDataset

    div = cfg.data.size_divisibility

    def up(v):
        return -(-v // div) * div

    return SyntheticSGGDataset(
        num_images=num_images, image_size=(up(cfg.data.min_size_train),
                                   up(cfg.data.max_size_train)),
        num_obj_classes=cfg.model.num_obj_classes,
        num_rel_classes=cfg.relation.num_classes,
        max_objects=cfg.data.max_boxes, seed=cfg.solver.seed)


def build_dataset(cfg, split: str):
    """The ``split`` ("train", "val", "test") of the data the config names:
    the synthetic corpus when ``data.data_dir`` is empty, else the VG or
    GQA-200 files under it (the JAX tool's layout)."""
    if not cfg.data.data_dir:
        if split == "train":
            return synthetic_train_dataset(cfg)
        from .relation_test_net import synthetic_eval_dataset

        return synthetic_eval_dataset(cfg)
    name = cfg.data.dataset.split("+")[0].upper()
    if "+" in cfg.data.dataset or "COCO" in name or "VOC" in name:
        raise NotImplementedError(
            f"data.dataset={cfg.data.dataset!r}: detector pretraining data "
            "(COCO, VOC, concatenated sets) comes with slice A13")
    if "OI" in name or "OPEN" in name:
        raise NotImplementedError(
            f"data.dataset={cfg.data.dataset!r}: Open Images comes with slice A14")
    d = cfg.data.data_dir
    resampling = ({"repeat_factor": cfg.data.repeat_factor,
                   "instance_drop_rate": cfg.data.instance_drop_rate}
                  if cfg.data.resampling and split == "train" else None)
    if "GQA" in cfg.data.dataset:
        from ..data.gqa import GQADataset

        return GQADataset(
            split, dict_file=os.path.join(d, "GQA_200_ID_Info.json"),
            train_file=os.path.join(d, "GQA_200_Train.json"),
            test_file=os.path.join(d, "GQA_200_Test.json"),
            img_dir=os.path.join(d, "images"),
            depth_img_dir=os.path.join(d, "depth") if cfg.data.use_depth else None,
            num_val_im=cfg.data.num_val_images,
            filter_duplicate_rels=cfg.data.filter_duplicate_relations,
            resampling=resampling, seed=cfg.solver.seed)
    from ..data.visual_genome import VGDataset

    return VGDataset(
        split, roidb_file=os.path.join(d, "VG-SGG-with-attri.h5"),
        dict_file=os.path.join(d, "VG-SGG-dicts-with-attri.json"),
        image_file=os.path.join(d, "image_data.json"),
        img_dir=os.path.join(d, "VG_100K"),
        depth_img_dir=os.path.join(d, "VG_100K_depth") if cfg.data.use_depth else None,
        num_val_im=cfg.data.num_val_images,
        filter_duplicate_rels=cfg.data.filter_duplicate_relations,
        filter_non_overlap=cfg.data.filter_non_overlap,
        reorder_freq_based=cfg.data.reorder_freq_based,
        resampling=resampling, seed=cfg.solver.seed)


def batches_for(cfg, dataset, split: str):
    """``gen(max_iter, start_iter=0)`` → (host SGGBatch, records): for
    "train" ``max_iter - start_iter`` batches, else one pass over the split
    (``max_iter`` ignored)."""
    from ..data.synthetic import SyntheticSGGDataset

    train = split == "train"
    bsz = cfg.solver.ims_per_batch if train else cfg.test.ims_per_batch
    if isinstance(dataset, SyntheticSGGDataset):
        def gen(max_iter, start_iter=0):
            if not train:
                yield from dataset.batches(bsz, cfg.data.max_boxes)
                return
            it = start_iter
            while it < max_iter:
                for batch, recs in dataset.batches(bsz, cfg.data.max_boxes):
                    yield batch, recs
                    it += 1
                    if it >= max_iter:
                        return
        return gen
    from ..data.loader import SGGLoader

    loader = SGGLoader(
        dataset, batch_size=bsz, max_boxes=cfg.data.max_boxes,
        num_obj_classes=cfg.model.num_obj_classes,
        min_size=cfg.data.min_size_train if train else cfg.data.min_size_test,
        max_size=cfg.data.max_size_train if train else cfg.data.max_size_test,
        pixel_mean=cfg.data.pixel_mean, pixel_std=cfg.data.pixel_std,
        use_depth=cfg.data.use_depth, shuffle=train, seed=cfg.solver.seed,
        size_divisibility=cfg.data.size_divisibility)

    def gen(max_iter, start_iter=0):
        if train:
            yield from loader.iterations(max_iter, start_iter)
        else:
            yield from loader.epochs()

    return gen


def rel_class_weights(cfg):
    """The Rwt beta weights of the dataset's predicate counts, or None."""
    from ..data.predicate_stats import predicate_counts
    from ..models.relation.predictor_veto import beta_class_weights

    if not cfg.relation.beta_loss:
        return None
    if cfg.pred_counts_path:
        import pickle

        with open(cfg.pred_counts_path, "rb") as fin:
            counts = np.asarray(pickle.load(fin), np.float64)
    else:
        counts = predicate_counts(
            "GQA" if "GQA" in cfg.data.dataset else "VG"
        )[: cfg.relation.num_classes]
    return beta_class_weights(counts, cfg.relation.beta)


def load_pretrained_detector(cfg, model, log=print):
    """Import ``model.pretrained_detector_ckpt`` into ``model``'s frozen
    detector (in the layout ``model.fold_bn`` names), when it is set.
    Returns :func:`import_detector_weights`' (loaded, skipped), or None."""
    if not cfg.model.pretrained_detector_ckpt:
        return None
    from ..utils.torch_import import import_detector_weights

    return import_detector_weights(model, cfg.model.pretrained_detector_ckpt,
                                   log, fold_bn=cfg.model.fold_bn)


def run_validation(model, eval_step, batches, evaluator, device,
                   max_batches: int = 0, log=None):
    """``batches`` (host batches of the val or test split; the first
    ``max_batches`` of them, or all) through :class:`DeviceFeeder`, the eval
    step (the model in eval mode, so its BatchNorms read and keep their
    running statistics; its mode is restored after) and the evaluator.
    Returns the aggregate and the seconds each batch took from its hand-out
    by the feeder (its pinned copy to the card overlapping the batch before)
    to its predictions back on the host."""
    import itertools

    from ..engine.batch import DeviceFeeder
    from ..engine.evaluate import accumulate_eval, to_numpy

    if max_batches:
        batches = itertools.islice(batches, max_batches)
    was_training = model.training
    model.eval()
    evaluator.reset()
    seconds = []
    try:
        for i, (batch, recs) in enumerate(DeviceFeeder(batches, device)):
            t0 = time.perf_counter()
            preds = to_numpy(eval_step(batch))
            seconds.append(time.perf_counter() - t0)
            if log is not None:
                log(f"batch {i}: {len(recs)} images, {seconds[-1]:.3f} s on "
                    f"{device}")
            accumulate_eval(preds, recs, evaluator)
    finally:
        model.train(was_training)
    return evaluator.aggregate(), seconds


def train(cfg, device=None, log=print, model=None, datasets=None):
    """Train to ``solver.max_iter`` (from the latest checkpoint in
    ``output_dir/ckpt`` when there is one).  Returns the train state and
    one dict per step run: loss, rel_loss, grad_norm, lr_scale, seconds,
    step_seconds, wait_seconds, image_shape (the batch's padded (H, W))
    and, on a validation step, val_mR100.

    ``model`` is an already built :class:`SGGModel` (by default one is
    built from ``cfg`` on ``device``); ``datasets`` a (train, val) pair of
    datasets with the reader's interface (by default :func:`build_dataset`'s)."""
    import torch

    from ..engine.batch import DeviceFeeder
    from ..engine.evaluate import make_eval_step
    from ..engine.train import create_train_state, train_step
    from ..models.sgg import build_model
    from ..solver.optim import LRController
    from ..utils.checkpoint import CheckpointManager
    from ..utils.logger import JSONLWriter, MetricLogger
    from ..utils.preemption import PreemptionGuard
    from .relation_test_net import make_sgg_evaluator

    solver = cfg.solver
    loss_variant = cfg.relation.loss_variant
    if cfg.relation.label_smoothing and loss_variant == "weighted_ce":
        loss_variant = "label_smoothing"
    writer = JSONLWriter(cfg.output_dir, tensorboard=cfg.tensorboard_on)
    train_ds, val_ds = datasets if datasets is not None else (
        build_dataset(cfg, "train"), build_dataset(cfg, "val"))
    if model is None:
        model = build_model(cfg, device)
    dev = next(model.parameters()).device
    load_pretrained_detector(cfg, model, log)
    state = create_train_state(model, solver, rel_class_weights(cfg),
                               mode=cfg.relation.mode, loss_variant=loss_variant,
                               meet=cfg.ensemble if cfg.ensemble.enabled else None)
    state.generator = torch.Generator(device=dev).manual_seed(solver.seed)
    ckpt = CheckpointManager(os.path.join(cfg.output_dir, "ckpt"))
    extra = ckpt.restore(state, log=log)
    start_iter = state.step
    ctrl = LRController(solver)
    if extra:
        ctrl.__dict__.update({k: extra[k] for k in _CTRL_FIELDS if k in extra})
    if start_iter:
        log(f"resumed from iteration {start_iter}")

    def ctrl_state():
        return {k: getattr(ctrl, k) for k in _CTRL_FIELDS}

    evaluator = make_sgg_evaluator(cfg, train_ds, val_ds)
    eval_step = make_eval_step(model, max_pairs=cfg.relation.max_proposal_pairs,
                               mode=cfg.relation.mode)
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
            scale = ctrl.scale(it)
            fence()
            t0 = time.perf_counter()
            m = train_step(state, batch, state.generator, scale,
                           cfg.relation.batch_size_per_image,
                           cfg.relation.positive_fraction)
            fence()  # the update's launches included
            now = time.perf_counter()
            rec = {k: float(m[k]) for k in ("loss", "rel_loss", "grad_norm")}
            rec.update(lr_scale=scale, seconds=now - t0,
                       step_seconds=now - t_prev, wait_seconds=feeder.waits[-1],
                       image_shape=tuple(batch.images.shape[1:3]))
            history.append(rec)
            meters.update(time=rec["step_seconds"])
            if it % 30 == 0:
                writer.write(it, {k: rec[k] for k in ("loss", "rel_loss",
                                                      "grad_norm", "lr_scale")})
            log(f"iter {it}/{solver.max_iter}  loss {rec['loss']:.4f}  "
                f"grad_norm {rec['grad_norm']:.4f}  lr_scale {scale:.4f}  "
                f"{rec['seconds']:.3f} s on {dev} ({rec['step_seconds']:.3f} s "
                f"a step, {rec['wait_seconds']:.3f} s waiting for data)  "
                f"eta {meters.eta_string(it + 1, solver.max_iter)}")
            if guard.requested:
                ckpt.save(it + 1, state, extra=ctrl_state())
                log(f"preemption signal: checkpointed at iter {it + 1}")
                break
            if (it + 1) % solver.checkpoint_period == 0:
                ckpt.save(it + 1, state, extra=ctrl_state())
            if (it + 1) % solver.val_period == 0:
                agg, _ = run_validation(model, eval_step, val_gen(0),
                                        evaluator, dev)
                rec["val_mR100"] = mr100 = agg["mR"][100]
                log(f"validation @ {it + 1}:\n{evaluator.summary_string()}")
                writer.write(it + 1, {"val_mR100": mr100})
                ctrl.report_validation(mr100)  # the plateau signal
                if ctrl.should_stop:
                    log("max LR decays reached; stopping")
                    break
            t_prev = time.perf_counter()
    finally:
        batches.close()
        guard.restore()
    ckpt.save(state.step, state, extra=ctrl_state())
    log(f"training done at iteration {state.step}")
    return state, history


def main(argv=None):
    from ..config import load_config
    from ..utils.logger import setup_logger

    parser = argparse.ArgumentParser(description="VETO relation training "
                                                 "(PyTorch port)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("opts", nargs="*", default=[])
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.opts)
    os.makedirs(cfg.output_dir, exist_ok=True)
    cfg.dump(os.path.join(cfg.output_dir, "config.json"))
    logger = setup_logger("veto_tpu_torch", cfg.output_dir)
    _, history = train(cfg, args.device, log=logger.info)
    print(json.dumps(history[-1] if history else {}))
    return history


if __name__ == "__main__":
    main()
