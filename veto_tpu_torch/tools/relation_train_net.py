"""Relation training entry point of the port (``tools/relation_train_net.py``).

    python -m veto_tpu_torch.tools.relation_train_net \\
        --config configs/veto_vg_predcls.yaml [--device cpu] \\
        [opts, e.g. data.data_dir=/path/to/vg solver.max_iter=125000]

Reads the YAML with the port's config loader, builds the PredCls, SGCls
or SGDet model (``relation.use_gt_box``, ``relation.use_gt_object_label``)
on the card (or the CPU when asked) with weights drawn from
``solver.seed``, imports ``model.pretrained_detector_ckpt`` into the frozen
detector (in SGCls its box head too, in SGDet also the RPN head) when set,
and trains the depth backbone and the relation head (in SGDet on pairs of
the detections, ``relation.num_sample_per_gt_rel`` and
``relation.require_box_overlap``):

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

With ``ensemble.enabled`` the model is MEET's (``relation.predictor``
``VETOPredictor_MEET`` or ``VETOPredictor``; VG's or GQA-200's groups of
``ensemble.group_split``, 3 experts a group with ``ensemble.expert_group``),
trained on its per-group losses and validated through its eval step
(voting by ``ensemble.voting`` with 3 experts).

Each step logs the loss (in SGCls and SGDet also the object loss, which
moves the loss value and not the update; with MEET each group's loss),
the gradient norm, the LR scale and its seconds:
``seconds`` from its batch on the device to the end of its update,
``step_seconds`` from the end of the previous update to the end of this
one (waiting on the loader included), ``wait_seconds`` the part spent
waiting for the batch.  ``metrics.jsonl`` in ``output_dir`` gets the
losses every 30 steps and each validation's mR@100.

With ``model.attribute_on`` the attribute head trains beside the relation
head on each box's attribute list (``model.attribute_*`` as the JAX tool
passes them: :func:`attribute_config`).

``relation.predictor`` also takes the legacy ``MotifPredictor``,
``VCTreePredictor``, ``TransformerPredictor`` and ``TransLikePredictor``,
each with its MEET heads under ``ensemble.enabled`` (``*_MEET`` names, and
``TransLike_MEET``, select the same base, as in the JAX tool), and
``IMPPredictor``, ``BGNNPredictor``, ``GPSNetPredictor`` and
``MSDNPredictor`` (BGNN and MSDN with ``relation.rel_aware`` and
``relation.mp_valid_pairs``: the relness pre-classifier adds
``pre_rel_classify_loss`` in PredCls and SGCls), ``CausalAnalysisPredictor``
(``relation.causal_effect_type`` none / TDE / NIE / TE,
``relation.causal_fusion_type`` sum / gate; its untreated averages ride in
the checkpoint), ``KERNPredictor``, ``AGRCNNPredictor``, ``NaivePredictor``
and ``RelatednessTestPredictor`` (its relness adds
``pre_rel_classify_loss`` in PredCls and SGCls); in SGCls and SGDet their
refined object logits train on ``obj_loss``, and VCTree adds
``binary_loss``.

``relation.loss_variant`` (``weighted_ce``, ``label_smoothing``, ``ldam``
with ``relation.ldam_max_m`` over the predicate counts, ``balanced_norm``,
whose running labeling probability rides in the checkpoint;
``relation.label_smoothing=True`` selects ``label_smoothing``) picks
``rel_loss``, as in the JAX tool.  ``configs/vgg_vg_predcls.yaml`` (``model.backbone=
VGG-16``) trains on the single-scale VGG-16 detector.

Data-parallel training over W processes, one a card::

    torchrun --nproc_per_node=W -m veto_tpu_torch.tools.relation_train_net \\
        --config configs/veto_vg_predcls.yaml [opts ...]

(or :func:`train` under a process group the caller has started).  Each
rank reads its shard of the data (``SGGLoader(rank=, world=)``) at
``solver.ims_per_batch // W`` images a step, the global batch staying
``solver.ims_per_batch``; the W ranks' step is the one-process step on the
global batch (``engine/distributed.py``).  Validation evaluates each
rank's shard and, with ``test.sync_gather``, merges the evaluators over the
ranks (``engine/gather.py``), so that every rank feeds the same mR@100 to
the plateau decay and the early stop; the preemption flag is agreed at
every step.  Only rank 0 writes the checkpoints, ``metrics.jsonl``, the
log file and ``inter_data_buffer.pkl``; every rank restores.  With W > 1
only the configurations of ``distributed.SCOPE`` run; the others raise
``NotImplementedError`` (ROADMAP queue A12b).

``global_buffer_on``: for a predictor with relness logits (BGNN or MSDN
with ``relation.rel_aware``, RelatednessTest) each step's relness targets and scores go to
the global buffer (``utils/global_buffer.py``: ``rel_pn-train_y``,
``rel_pn-train_pred``, the valid pairs' rows, gathered over the ranks),
pickled to ``output_dir/inter_data_buffer.pkl`` at the end.

Not yet ported (they raise ``NotImplementedError``): the output keys
``test.save_plots`` and ``test.save_visual_info``
(:data:`UNSERVED_OUTPUTS`), Open Images data (A14).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

_CTRL_FIELDS = ("best", "bad_epochs", "cooldown_counter", "num_decays")
# output keys the JAX tools serve and the port does not yet, with the slice
# of ROADMAP queue A that brings each
UNSERVED_OUTPUTS = (
    ("test.save_plots", "the tools' other outputs (ROADMAP queue A14 item 9: "
                        "utils/viz.py's frequency and recall plots)"),
    ("test.save_visual_info", "the tools' other outputs (ROADMAP queue A14 "
                              "item 9: the per-image visual_info dump)"),
)


def refuse_unserved_outputs(cfg) -> None:
    """Raise ``NotImplementedError`` for an output key of
    :data:`UNSERVED_OUTPUTS` that the config sets, naming the slice that
    serves it (both relation tools call this before any work)."""
    for key, slice_ in UNSERVED_OUTPUTS:
        node = cfg
        for part in key.split("."):
            node = getattr(node, part)
        if node:
            raise NotImplementedError(f"{key}: not served by the port yet; it "
                                      f"comes with {slice_}")


def synthetic_train_dataset(cfg, num_images: int = 64):
    """The synthetic train split at the config's train input shape (with
    each box's mask and keypoints when ``model.mask_on`` /
    ``model.keypoint_on`` train those heads)."""
    from ..data.synthetic import SyntheticSGGDataset

    div = cfg.data.size_divisibility

    def up(v):
        return -(-v // div) * div

    return SyntheticSGGDataset(
        num_images=num_images, image_size=(up(cfg.data.min_size_train),
                                   up(cfg.data.max_size_train)),
        num_obj_classes=cfg.model.num_obj_classes,
        num_rel_classes=cfg.relation.num_classes,
        max_objects=cfg.data.max_boxes, seed=cfg.solver.seed,
        with_masks=cfg.model.mask_on,
        with_keypoints=cfg.model.num_keypoints if cfg.model.keypoint_on else 0)


def build_dataset(cfg, split: str):
    """The ``split`` ("train", "val", "test") of the data the config names,
    routed by ``data.dataset`` as the JAX tool routes it: the synthetic
    corpus when ``data.data_dir`` is empty; ``A+B`` concatenates its parts
    for "train" (val and test take the first-named part); a name holding
    COCO reads ``annotations/instances_{train|val}{year}.json`` (2017
    unless the name holds another "201x" year, then 2014); VOC reads the
    ``VOC2007`` or ``VOC2012`` subdirectory the name's year names, when it
    exists, else ``data_dir`` itself; GQA the GQA-200 files; anything else
    the Visual Genome files.  Open Images raises (slice A14)."""
    if not cfg.data.data_dir:
        if split == "train":
            return synthetic_train_dataset(cfg)
        from .relation_test_net import synthetic_eval_dataset

        return synthetic_eval_dataset(cfg)
    d = cfg.data.data_dir
    if "+" in cfg.data.dataset and split == "train":
        from ..data.compound import ConcatDataset

        return ConcatDataset([build_dataset(cfg.override("data.dataset", part), split)
                              for part in cfg.data.dataset.split("+")])
    name = cfg.data.dataset.split("+")[0].upper()
    if "COCO" in name:
        from ..data.coco import COCODetDataset

        year = "2017" if "2017" in name or "201" not in name else "2014"
        coco_split = "train" if split == "train" else "val"
        return COCODetDataset(
            ann_file=os.path.join(d, "annotations",
                                  f"instances_{coco_split}{year}.json"),
            img_dir=os.path.join(d, f"{coco_split}{year}"))
    if "OI" in name or "OPEN" in name:
        raise NotImplementedError(
            f"data.dataset={cfg.data.dataset!r}: Open Images comes with slice A14")
    if "VOC" in name:
        from ..data.voc import VOCDataset

        for year in ("2007", "2012"):
            if year in name and os.path.isdir(os.path.join(d, f"VOC{year}")):
                return VOCDataset(os.path.join(d, f"VOC{year}"), split)
        return VOCDataset(d, split)
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


def batches_for(cfg, dataset, split: str, rank: int = 0, world: int = 1):
    """``gen(max_iter, start_iter=0)`` → (host SGGBatch, records): for
    "train" ``max_iter - start_iter`` batches, else one pass over the split
    (``max_iter`` ignored).  With ``world`` ranks, rank ``rank``'s shard:
    train batches of ``solver.ims_per_batch // world`` images (eval batches
    stay ``test.ims_per_batch`` a rank)."""
    from ..data.synthetic import SyntheticSGGDataset
    from ..engine.distributed import local_batch

    train = split == "train"
    bsz = (local_batch(cfg.solver.ims_per_batch, world) if train
           else cfg.test.ims_per_batch)
    if isinstance(dataset, SyntheticSGGDataset):
        def gen(max_iter, start_iter=0):
            if not train:
                yield from dataset.batches(bsz, cfg.data.max_boxes, rank, world)
                return
            it = start_iter
            while it < max_iter:
                for batch, recs in dataset.batches(bsz, cfg.data.max_boxes,
                                                   rank, world):
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
        size_divisibility=cfg.data.size_divisibility, rank=rank, world=world)

    def gen(max_iter, start_iter=0):
        if train:
            yield from loader.iterations(max_iter, start_iter)
        else:
            yield from loader.epochs()

    return gen


def predicate_counts_of(cfg) -> np.ndarray:
    """The training predicate counts: ``pred_counts_path`` (a reference
    ``pred_counts.pkl``), else the built-in VG or GQA constants."""
    from ..data.predicate_stats import predicate_counts

    if cfg.pred_counts_path:
        import pickle

        with open(cfg.pred_counts_path, "rb") as fin:
            return np.asarray(pickle.load(fin), np.float64)
    return predicate_counts(
        "GQA" if "GQA" in cfg.data.dataset else "VG")[: cfg.relation.num_classes]


def rel_class_weights(cfg):
    """The Rwt beta weights of the dataset's predicate counts, or None."""
    from ..models.relation.predictor_veto import beta_class_weights

    if not cfg.relation.beta_loss:
        return None
    return beta_class_weights(predicate_counts_of(cfg), cfg.relation.beta)


def build_meet_config(cfg):
    """MEET's routing constants (GQA-200's groups when ``data.dataset``
    holds "GQA", else Visual Genome's), or None when ``ensemble.enabled``
    is off.  ``ensemble.voting`` outside C/U and
    ``ensemble.zero_label_padding_mode`` other than ``rand_insert`` (the
    only routing of background pairs there is) raise ``ValueError``."""
    from ..models.relation.predictor_meet import make_meet_config

    ens = cfg.ensemble
    if not ens.enabled:
        return None
    if ens.zero_label_padding_mode != "rand_insert":
        raise ValueError(
            f"ensemble.zero_label_padding_mode={ens.zero_label_padding_mode!r}: "
            "MEET routes background pairs by 'rand_insert' only")
    return make_meet_config(
        dataset="GQA" if "GQA" in cfg.data.dataset else "VG",
        split=ens.group_split, expert_group=ens.expert_group, voting=ens.voting)


def attribute_config(cfg):
    """``attribute_loss``'s keyword arguments from ``model.attribute_*``
    (the JAX tool's ``attribute_cfg``), or None without ``attribute_on``."""
    m = cfg.model
    if not m.attribute_on:
        return None
    return dict(loss_weight=m.attribute_loss_weight,
                bgfg_sample=m.attribute_bgfg_sample,
                bgfg_ratio=m.attribute_bgfg_ratio,
                use_binary_loss=m.attribute_use_binary_loss,
                pos_weight=m.attribute_pos_weight)


def load_pretrained_detector(cfg, model, log=print):
    """Import ``model.pretrained_detector_ckpt`` into ``model``'s frozen
    detector (in the layout ``model.fold_bn`` names), when it is set.
    Returns :func:`import_detector_weights`' (loaded, skipped), or None."""
    if not cfg.model.pretrained_detector_ckpt:
        return None
    from ..utils.torch_import import import_detector_weights

    return import_detector_weights(model, cfg.model.pretrained_detector_ckpt,
                                   log, fold_bn=cfg.model.fold_bn)


def make_eval_fn(cfg, model):
    """The config's eval step (the JAX tool's ``make_eval_fn``): SGDet's
    takes ``relation.later_nms_prediction_thres`` and
    ``test.relation_require_overlap``; with ``ensemble.enabled`` MEET's (the
    JAX tool's kind "meet": its predictions are a ``MeetEval``, which
    ``accumulate_eval`` tells apart)."""
    from ..engine.evaluate import make_eval_step, make_meet_eval_step

    kw = dict(max_pairs=cfg.relation.max_proposal_pairs, mode=cfg.relation.mode,
              later_nms_thres=cfg.relation.later_nms_prediction_thres,
              require_overlap=cfg.test.relation_require_overlap)
    meet = build_meet_config(cfg)
    if meet is not None:
        return make_meet_eval_step(model, meet, **kw)
    return make_eval_step(model, **kw)


def run_validation(model, eval_step, batches, evaluator, device,
                   max_batches: int = 0, log=None, coco_evaluator=None,
                   gather=None):
    """``batches`` (host batches of the val or test split; the first
    ``max_batches`` of them, or all) through :class:`DeviceFeeder`, the eval
    step (the model in eval mode, so its BatchNorms read and keep their
    running statistics; its mode is restored after) and the evaluator (in
    SGDet also ``coco_evaluator``, when given).  With ``gather`` (a
    ``distributed.DataParallel``) the ranks' evaluators are merged first
    (``sync_gather_evaluator``): the aggregate is then every rank's images'.
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
            accumulate_eval(preds, recs, evaluator,
                            input_sizes=batch.sizes.cpu().numpy(),
                            coco_evaluator=coco_evaluator)
    finally:
        model.train(was_training)
    if gather is not None:
        from ..engine.gather import sync_gather_evaluator

        sync_gather_evaluator(evaluator, gather.host_group)
    return evaluator.aggregate(), seconds


def train(cfg, device=None, log=print, model=None, datasets=None, dp=None):
    """Train to ``solver.max_iter`` (from the latest checkpoint in
    ``output_dir/ckpt`` when there is one).  Returns the train state and
    one dict per step run: loss, rel_loss (with MEET the group_* losses
    instead; obj_loss in SGCls and SGDet; attribute_loss with
    ``model.attribute_on``), grad_norm, lr_scale, seconds,
    step_seconds, wait_seconds, image_shape (the batch's padded (H, W))
    and, on a validation step, val_mR100.

    ``model`` is an already built :class:`SGGModel` (by default one is
    built from ``cfg`` on ``device``); ``datasets`` a (train, val) pair of
    datasets with the reader's interface (by default :func:`build_dataset`'s).
    Under a process group (``torchrun``'s variables, or a group the caller
    started) this process is one rank of a data-parallel run
    (:func:`distributed.init_from_env`, unless the caller gives its ``dp``
    and ``device``); the losses and ``grad_norm`` are the global step's on
    every rank."""
    import torch

    refuse_unserved_outputs(cfg)
    from ..engine import distributed
    from ..engine.batch import DeviceFeeder
    from ..engine.train import create_train_state, train_step
    from ..models.sgg import build_model
    from ..solver.optim import LRController
    from ..utils import global_buffer
    from ..utils.checkpoint import CheckpointManager
    from ..utils.logger import JSONLWriter, MetricLogger
    from ..utils.preemption import PreemptionGuard
    from .relation_test_net import make_sgg_evaluator

    if model is not None:
        device = next(model.parameters()).device
    if dp is None:
        dp, device = distributed.init_from_env(device)
    rank, world = (0, 1) if dp is None else (dp.rank, dp.world)
    distributed.check_scope(cfg, world)
    distributed.local_batch(cfg.solver.ims_per_batch, world)  # raises early
    solver = cfg.solver
    loss_variant = cfg.relation.loss_variant
    if cfg.relation.label_smoothing and loss_variant == "weighted_ce":
        loss_variant = "label_smoothing"
    writer = JSONLWriter(cfg.output_dir, tensorboard=cfg.tensorboard_on) if (
        rank == 0) else None
    train_ds, val_ds = datasets if datasets is not None else (
        build_dataset(cfg, "train"), build_dataset(cfg, "val"))
    if model is None:
        model = build_model(cfg, device)
    dev = next(model.parameters()).device
    load_pretrained_detector(cfg, model, log)
    margins = None
    if loss_variant == "ldam":
        from ..ops.losses import ldam_margins

        margins = ldam_margins(predicate_counts_of(cfg), cfg.relation.ldam_max_m)
    state = create_train_state(model, solver, rel_class_weights(cfg),
                               mode=cfg.relation.mode, loss_variant=loss_variant,
                               meet=build_meet_config(cfg),
                               attribute_cfg=attribute_config(cfg), dp=dp,
                               ldam_margins=margins)
    state.generator = torch.Generator(device=dev).manual_seed(solver.seed)
    ckpt = CheckpointManager(os.path.join(cfg.output_dir, "ckpt"), dp=dp)
    extra = ckpt.restore(state, log=log)
    start_iter = state.step
    ctrl = LRController(solver)
    if extra:
        ctrl.__dict__.update({k: extra[k] for k in _CTRL_FIELDS if k in extra})
    if start_iter:
        log(f"resumed from iteration {start_iter}")
    if dp is not None:
        log(f"rank {rank} of {world} over {dp.backend}: "
            f"{solver.ims_per_batch // world} images a step on {dev}")

    def ctrl_state():
        return {k: getattr(ctrl, k) for k in _CTRL_FIELDS}

    if cfg.global_buffer_on:
        global_buffer.enable(True, dp)
    gather = dp if cfg.test.sync_gather else None
    evaluator = make_sgg_evaluator(cfg, train_ds, val_ds)
    eval_step = make_eval_fn(cfg, model)
    val_gen = batches_for(cfg, val_ds, "val", rank, world)
    feeder = DeviceFeeder(batches_for(cfg, train_ds, "train", rank, world)(
        solver.max_iter, start_iter), dev)
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
                           cfg.relation.positive_fraction,
                           cfg.relation.num_sample_per_gt_rel,
                           cfg.relation.require_box_overlap,
                           collect_diagnostics=cfg.global_buffer_on)
            fence()  # the update's launches included
            now = time.perf_counter()
            buf = m.pop("buffer", None)
            if buf is not None:
                for key in ("rel_pn-train_y", "rel_pn-train_pred"):
                    global_buffer.store_data(key, buf[key], mask=buf["mask"])
            losses = [k for k in m if k.endswith("loss")]
            rec = {k: float(m[k]) for k in losses + ["grad_norm"]}
            rec.update(lr_scale=scale, seconds=now - t0,
                       step_seconds=now - t_prev, wait_seconds=feeder.waits[-1],
                       image_shape=tuple(batch.images.shape[1:3]))
            history.append(rec)
            meters.update(time=rec["step_seconds"])
            if it % 30 == 0 and writer is not None:
                writer.write(it, {k: rec[k] for k in losses + ["grad_norm",
                                                               "lr_scale"]})
            log(f"iter {it}/{solver.max_iter}  loss {rec['loss']:.4f}  "
                f"grad_norm {rec['grad_norm']:.4f}  lr_scale {scale:.4f}  "
                f"{rec['seconds']:.3f} s on {dev} ({rec['step_seconds']:.3f} s "
                f"a step, {rec['wait_seconds']:.3f} s waiting for data)  "
                f"eta {meters.eta_string(it + 1, solver.max_iter)}")
            stop = guard.requested if dp is None else dp.agree(guard.requested)
            if stop:
                ckpt.save(it + 1, state, extra=ctrl_state())
                log(f"preemption signal: checkpointed at iter {it + 1}")
                break
            if (it + 1) % solver.checkpoint_period == 0:
                ckpt.save(it + 1, state, extra=ctrl_state())
            if (it + 1) % solver.val_period == 0:
                agg, _ = run_validation(model, eval_step, val_gen(0),
                                        evaluator, dev, gather=gather)
                mr100 = agg["mR"][100]
                if dp is not None and gather is None:
                    # each rank validated its own shard: take rank 0's
                    # reading, so that every rank decides alike
                    mr100 = distributed.broadcast_value(mr100, dp)
                rec["val_mR100"] = mr100
                log(f"validation @ {it + 1}:\n{evaluator.summary_string()}")
                if writer is not None:
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
    if cfg.global_buffer_on:
        path = global_buffer.save_buffer(cfg.output_dir)
        if path:
            log(f"saved the global buffer: {path}")
    log(f"training done at iteration {state.step}")
    return state, history


def main(argv=None):
    from ..config import load_config
    from ..engine import distributed
    from ..utils.logger import setup_logger

    parser = argparse.ArgumentParser(description="VETO relation training "
                                                 "(PyTorch port)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default; cuda:LOCAL_RANK under torchrun) "
                             "or cpu")
    parser.add_argument("opts", nargs="*", default=[])
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.opts)
    dp, device = distributed.init_from_env(args.device)
    rank = 0 if dp is None else dp.rank
    if rank == 0:
        os.makedirs(cfg.output_dir, exist_ok=True)
        cfg.dump(os.path.join(cfg.output_dir, "config.json"))
    logger = setup_logger("veto_tpu_torch", cfg.output_dir, rank=rank)
    try:
        _, history = train(cfg, device, log=logger.info, dp=dp)
    finally:
        if dp is not None:
            distributed.shutdown()
    if rank == 0:
        print(json.dumps(history[-1] if history else {}))
    return history


if __name__ == "__main__":
    main()
