"""Where the train step (PredCls, SGCls or SGDet, or detector
pretraining) spends its time on the card.

    python -m veto_tpu_torch.tools.profile_train \\
        [--config configs/veto_vg_predcls.yaml] [--steps 3] [--pretrain] [opts ...]

Builds the model of the config on ``cuda`` from seeded weights and its
train state, runs one warm-up step on the synthetic train split, then

* times each following step with CUDA events: pair sampling (in SGDet
  ``detect``, the label assignment and ``detect_relsample``); the
  forward's stages by forward hooks (the frozen detector body + FPN, the
  depth backbone, in SGCls the box head and ``obj_prediction_nms``, in
  SGDet the stages of ``detect`` and ``relate``, the relation predictor
  and, inside it, the encoder; the relation and depth pooling is what
  remains of the forward); the loss and the backward together; the
  optimizer update (clipping, Adam); the whole step on the host clock,
  ending after the update on the device;
* with MEET (``ensemble.enabled``) also times its heads (``meet_heads``,
  inside the predictor) and its routing and group losses
  (``meet_losses``, inside the loss and backward);
* traces one more step with ``torch.profiler`` and reports the device time
  by kernel, the port's own kernels by name, and the device's busy share of
  the step's wall time.

In SGDet the synthetic GT boxes match no detection of seeded weights, so
the sampler draws background pairs only; every shape is static, so the
step's work is the same.

With ``--pretrain`` it times the detector pretraining step instead
(``engine/pretrain.py``, the model built with ``train_detector=True``, SGD
at the multistep schedule's first scale) on the synthetic train split: the
body, FPN and RPN head forward (``detector_forward``), the RPN losses
(matching, the balanced sample, BCE and smooth-L1), the proposal
selection (top-k, decode, N1, the top 1000), the box sampler, the box pool
and head (``box_forward``: B3 and fc6/fc7/the predictor), the backward
(B3-bwd, the box head, the RPN head and the trained body), the update;
and the launches of B3, B3-bwd and N1 a step.  With ``model.mask_on`` /
``model.keypoint_on`` also the heads' stage (``head_losses``: the roi
selection and re-match, each head's 14x14 pool and convolutions, its
loss; of it ``mask_head`` and ``keypoint_head``, the two forwards).

The last line is one JSON object with these numbers and the card's name.
It needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .profile_eval import (
    OWN_KERNELS, _stage_timer, derived_stages, meet_stages, mode_stages, trace,
)

# the backward kernels of csrc/encoder_layer_bwd.cu, csrc/roi_align.cu and
# csrc/pair_attention.cu (its GEMMs are OWN_KERNELS' gemm_sm90_kernel, its
# tensor-core attention OWN_KERNELS' attention_bwd_mma_kernel)
OWN_BWD_KERNELS = ("ln_backward_kernel", "splitk_reduce_kernel",
                   "colsum_reduce_kernel", "roi_align_bwd_kernel",
                   "pair_attn_bwd_kernel")


def profile(cfg, steps: int = 3, log=print) -> dict:
    from ..engine import train
    from ..engine.train import (
        create_train_state, forward_backward, sample_detections, sample_pairs,
    )
    from ..models.sgg import build_model
    from ..solver.optim import LRController
    from .relation_train_net import (
        build_meet_config, rel_class_weights, synthetic_train_dataset,
    )

    if cfg.relation.predictor.split("_MEET")[0] != "VETOPredictor":
        raise NotImplementedError(
            f"relation.predictor={cfg.relation.predictor}: the profiler times "
            "VETO's stages; the legacy heads' times are chip_smoke.py phase 19's")
    model = build_model(cfg)  # cuda; raises without a card
    dev = next(model.parameters()).device
    state = create_train_state(model, cfg.solver, rel_class_weights(cfg),
                               mode=cfg.relation.mode, meet=build_meet_config(cfg))
    scale = LRController(cfg.solver).scale(0)
    gen = torch.Generator(device=dev).manual_seed(cfg.solver.seed)
    state.generator = gen  # the sampler's, and MEET's routing
    bsz = cfg.solver.ims_per_batch
    data = [b.to(dev) for b, _ in synthetic_train_dataset(cfg, (steps + 2) * bsz)
            .batches(bsz, cfg.data.max_boxes)]

    def step(b, marks=None):
        def mark():
            if marks is not None:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
        mark()
        if cfg.relation.mode == "sgdet":
            samples = sample_detections(model, b, gen,
                                        cfg.relation.batch_size_per_image,
                                        cfg.relation.positive_fraction,
                                        cfg.relation.num_sample_per_gt_rel,
                                        cfg.relation.require_box_overlap)
        else:
            samples = sample_pairs(b, gen, cfg.relation.batch_size_per_image,
                                   cfg.relation.positive_fraction)
        mark()
        losses = forward_backward(state, b, samples)
        mark()
        state.optimizer.step(scale)
        mark()
        return float(losses["loss"])

    step(data[0])  # warm-up: cuDNN plans, kernel loads
    stages = [("backbone", model.backbone),
              ("depth_backbone", model.depth_backbone),
              ("relation", model.relation),
              ("encoder", model.relation.trunk.fusion_transformer),
              ("model", model)]
    if cfg.relation.mode == "sgdet":
        stages.pop()  # the forward is not called: detect, then relate
    methods = mode_stages(model)
    meet = meet_stages(model, "meet_losses", train, "meet_losses")
    events, remove = _stage_timer(stages, methods + meet)
    marks, step_s = [], []
    for b in data[1:1 + steps]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(b, marks)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    remove()
    torch.cuda.synchronize()
    own = [n for n, _, _ in methods]
    ms = {name: float(np.mean([s.elapsed_time(e) for s, e in events[name]]))
          for name in [n for n, _ in stages] + own + [n for n, _, _ in meet]}
    spans = np.array([[marks[4 * i + k].elapsed_time(marks[4 * i + k + 1])
                       for k in range(3)] for i in range(steps)]).mean(0)
    derived_stages(ms, cfg.relation.mode, own)
    ms["sampling"] = float(spans[0])
    # SGDet's forward (relate) runs in the second span, detect in the first
    fwd = ms["relate"] if cfg.relation.mode == "sgdet" else ms["model"]
    ms["loss_and_backward"] = float(spans[1]) - fwd
    ms["optimizer"] = float(spans[2])
    ms["step"] = 1e3 * float(np.mean(step_s))
    for k in ["step", "sampling", "model", "backbone", "depth_backbone", *own,
              *(["detect_other"] if "detect" in own else []),
              "roi_pooling", "relation", "encoder", "predictor_without_encoder",
              "loss_and_backward", "optimizer", *[n for n, _, _ in meet]]:
        log(f"  {k:32s} {ms[k]:9.3f} ms")

    b = data[-1]
    return {"batch": bsz, "pairs_per_image": cfg.relation.batch_size_per_image,
            "stage_ms": ms,
            **trace(lambda: (step(b), torch.cuda.synchronize()),
                    OWN_KERNELS + OWN_BWD_KERNELS, log)}


PRETRAIN_STAGES = ("body_rpn_forward", "rpn_losses", "proposal_selection",
                   "box_sampler", "box_pool_and_head")


def profile_pretrain(cfg, steps: int = 3, log=print) -> dict:
    """The detector pretraining step's stage times, launches and trace."""
    from ..engine import pretrain
    from ..models.sgg import build_model
    from ..ops import nms, roi_align_windowed as rw
    from ..solver.optim import multistep_scale
    from .relation_train_net import synthetic_train_dataset

    model = build_model(cfg, train_detector=True)  # cuda; raises without a card
    dev = next(model.parameters()).device
    state = pretrain.create_detector_state(model, cfg.solver)
    budgets = pretrain.detector_budgets(cfg)
    scale = multistep_scale(cfg.solver)(0)
    bsz = cfg.solver.ims_per_batch
    data = [b.to(dev) for b, _ in synthetic_train_dataset(cfg, (steps + 2) * bsz)
            .batches(bsz, cfg.data.max_boxes)]

    def step(b, marks=None):
        def mark():
            if marks is not None:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
        mark()
        losses = pretrain.detector_forward_backward(state, b, budgets)
        mark()
        state.optimizer.step(scale)
        mark()
        return float(losses["loss"])

    step(data[0])  # warm-up: cuDNN plans, kernel loads
    methods = [("body_rpn_forward", model, "detector_forward"),
               ("rpn_losses", pretrain, "rpn_losses"),
               ("proposal_selection", pretrain, "rpn_select_proposals"),
               ("box_sampler", pretrain, "fastrcnn_sample"),
               ("box_pool_and_head", model, "box_forward"),
               ("forward_and_losses", pretrain, "detector_losses")]
    heads = model.mask_on or model.keypoint_on
    if heads:  # head_losses holds the two forwards: they are not summed
        methods += [("head_losses", pretrain, "_head_losses")] + [
            (f"{h}_head", model, f"{h}_forward") for h in ("mask", "keypoint")
            if getattr(model, f"{h}_on")]
    stages = PRETRAIN_STAGES + (("head_losses",) if heads else ())
    events, remove = _stage_timer([], methods)
    marks, step_s, launches = [], [], []
    counters = ((rw, "KERNEL_LAUNCHES"), (rw, "BWD_LAUNCHES"),
                (nms, "MASK_LAUNCHES"), (nms, "SCAN_LAUNCHES"))
    for b in data[1:1 + steps]:
        before = [getattr(m, a) for m, a in counters]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(b, marks)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        launches.append([getattr(m, a) - n for (m, a), n in zip(counters, before)])
    remove()
    ms = {name: float(np.mean([s.elapsed_time(e) for s, e in events[name]]))
          for name, _, _ in methods}
    spans = np.array([[marks[3 * i + k].elapsed_time(marks[3 * i + k + 1])
                       for k in range(2)] for i in range(steps)]).mean(0)
    ms["forward_other"] = ms["forward_and_losses"] - sum(ms[n] for n in stages)
    ms["backward"] = float(spans[0]) - ms["forward_and_losses"]
    ms["sgd_update"] = float(spans[1])
    ms["step"] = 1e3 * float(np.mean(step_s))
    for k in ["step", *[n for n, _, _ in methods if n != "forward_and_losses"],
              "forward_other", "backward", "sgd_update"]:
        log(f"  {k:32s} {ms[k]:9.3f} ms")
    names = ("multilevel_roi_align", "roi_align_backward", "nms_mask", "nms_scan")
    log(f"  launches a step: {dict(zip(names, launches[-1]))}")
    b = data[-1]
    return {"batch": bsz, "stage_ms": ms, "peak_gib": torch.cuda.max_memory_allocated()
            / 2 ** 30, "launches_per_step": dict(zip(names, launches[-1])),
            **trace(lambda: (step(b), torch.cuda.synchronize()),
                    OWN_KERNELS + OWN_BWD_KERNELS, log)}


def main(argv=None):
    from ..config import load_config

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default="configs/veto_vg_predcls.yaml")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--pretrain", action="store_true",
                        help="time the detector pretraining step")
    parser.add_argument("opts", nargs="*", default=[])
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.opts)
    if args.pretrain and not any(o.startswith("solver.optimizer") for o in args.opts):
        cfg = cfg.override("solver.optimizer", "sgd")  # as detector_pretrain_net
    run = profile_pretrain if args.pretrain else profile
    print(json.dumps(run(cfg, args.steps)))


if __name__ == "__main__":
    main()
