"""Relation training entry point of the port (``tools/relation_train_net.py``).

    python -m veto_tpu_torch.tools.relation_train_net \\
        --config configs/veto_vg_predcls.yaml [--device cpu] \\
        [opts, e.g. solver.max_iter=5]

Reads the YAML with the port's config loader, builds the PredCls model on
the card (or the CPU when asked) with weights drawn from ``solver.seed``,
and trains the depth backbone and the relation head on the synthetic train
split at the train input shape: images of ``min_size_train`` x
``max_size_train`` rounded up to ``size_divisibility`` (800 x 1344 for
Visual Genome), ``data.max_boxes`` objects at most, ``solver.ims_per_batch``
images a step, ``relation.batch_size_per_image`` sampled pairs an image.
Each step logs the loss, the gradient norm, the LR scale and its seconds.

Not yet ported (they raise): validation and the plateau decay it drives,
checkpoints and resume (so ``solver.max_iter`` must stay below
``solver.val_period`` and ``solver.checkpoint_period``), the Visual Genome
loader, SGCls/SGDet, MEET, the other loss variants, multi-device training.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


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


def train(cfg, device=None, log=print, model=None):
    """Train for ``solver.max_iter`` steps.  Returns the train state and one
    dict per step: loss, rel_loss, grad_norm, lr_scale and the seconds the
    step took on the host's clock (from its batch on the device to the end
    of its update on the device).

    ``model`` is an already built :class:`SGGModel`; by default one is
    built from ``cfg`` on ``device``."""
    import torch

    from ..engine.train import create_train_state, train_step
    from ..models.sgg import build_model
    from ..solver.optim import LRController

    if cfg.data.data_dir:
        raise NotImplementedError("the Visual Genome loader comes in a later "
                                  "slice; leave data.data_dir empty")
    period = min(cfg.solver.val_period, cfg.solver.checkpoint_period)
    if cfg.solver.max_iter >= period:
        raise NotImplementedError(
            f"solver.max_iter={cfg.solver.max_iter} reaches a validation or "
            f"checkpoint period ({period}); validation, checkpoints and resume "
            "come in a later slice")
    loss_variant = cfg.relation.loss_variant
    if cfg.relation.label_smoothing and loss_variant == "weighted_ce":
        loss_variant = "label_smoothing"
    if model is None:
        model = build_model(cfg, device)
    dev = next(model.parameters()).device
    state = create_train_state(model, cfg.solver, rel_class_weights(cfg),
                               mode=cfg.relation.mode, loss_variant=loss_variant,
                               meet=cfg.ensemble if cfg.ensemble.enabled else None)
    ctrl = LRController(cfg.solver)
    gen = torch.Generator(device=dev).manual_seed(cfg.solver.seed)
    bsz = cfg.solver.ims_per_batch
    ds = synthetic_train_dataset(cfg)
    history = []
    it = 0
    while it < cfg.solver.max_iter:
        for batch, _ in ds.batches(bsz, cfg.data.max_boxes):
            if it >= cfg.solver.max_iter:
                break
            b = batch.to(dev)
            scale = ctrl.scale(it)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            m = train_step(state, b, gen, scale,
                           cfg.relation.batch_size_per_image,
                           cfg.relation.positive_fraction)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # the update's launches included
            rec = {k: float(m[k]) for k in ("loss", "rel_loss", "grad_norm")}
            rec.update(lr_scale=scale, seconds=time.perf_counter() - t0)
            history.append(rec)
            log(f"iter {it}/{cfg.solver.max_iter}  loss {rec['loss']:.4f}  "
                f"grad_norm {rec['grad_norm']:.4f}  lr_scale {scale:.4f}  "
                f"{rec['seconds']:.3f} s on {dev}")
            it += 1
    return state, history


def main(argv=None):
    from ..config import load_config

    parser = argparse.ArgumentParser(description="VETO relation training "
                                                 "(PyTorch port)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("opts", nargs="*", default=[])
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.opts)
    _, history = train(cfg, args.device)
    print(json.dumps(history[-1] if history else {}))
    return history


if __name__ == "__main__":
    main()
