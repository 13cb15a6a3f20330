"""Where the evaluation step (PredCls, SGCls or SGDet) spends its time on
the card.

    python -m veto_tpu_torch.tools.profile_eval \\
        [--config configs/veto_vg_predcls.yaml] [--batches 3] [opts ...]

Builds the model of the config on ``cuda`` from seeded weights, runs one
warm-up batch of the synthetic split, then

* times the stages of each following batch with CUDA events recorded by
  forward hooks: the detector body + FPN, the depth backbone, in SGCls the
  box head (its pool and MLP) and ``obj_prediction_nms``, in SGDet the
  stages of ``detect`` (RPN head, proposals, box head, box
  post-processing) and ``relate``, the relation predictor and, inside it,
  the encoder; the relation and depth pooling is what remains of the
  model's forward (of ``relate`` in SGDet), pair preparation +
  post-processing what remains of the step; the host-to-card copy of the
  batch and the whole step (ending with the predictions on the host) are
  timed on the host clock;
* with MEET (``ensemble.enabled``) also times its heads (``meet_heads``,
  inside the predictor) and its post-processing (``meet_postprocess``,
  the ranking or vote of the G·P candidates, inside the post-processing);
* times ``accumulate_eval`` on the host clock, the NumPy evaluator taking
  each batch's predictions (``accumulate_eval_s``, seconds a batch);
* traces one more batch with ``torch.profiler`` and reports the device time
  by kernel, the port's own kernels by name, and the device's busy share of
  the step's wall time.

In SGDet the detections an image are reported beside the stages.

The last line is one JSON object with these numbers and the card's name.
It needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import subprocess
import time

import numpy as np
import torch

# kernels of veto_tpu_torch/csrc, by the name the profiler shows (the GEMM
# core of csrc/gemm_sm90.cuh carries every encoder product, forward and
# backward; attention_bwd_mma_kernel, the tensor-core attention of
# csrc/pair_attention_sm90.cuh, is B4a on the pair_attn path and, in a
# train step, also B4b's and B2b's attention)
OWN_KERNELS = ("gemm_sm90_kernel", "pair_attention_kernel", "layernorm_kernel",
               "roi_align_fwd_kernel", "attention_bwd_mma_kernel",
               "pair_attn_fwd_kernel", "nms_mask_kernel", "nms_scan_kernel")


def _stage_timer(named_modules, named_methods=()):
    """Forward hooks that record a CUDA event pair around each module's
    forward, and the same around each ``(name, owner, attribute)`` of
    ``named_methods`` (a method wrapped on its instance, or a function of
    a Python module wrapped in place, restored by the callback); returns
    (events list per name, remove callback)."""
    events = collections.defaultdict(list)
    handles = []

    def pre(*_, name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events[name].append([e, None])

    def post(*_, name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events[name][-1][1] = e

    for name, mod in named_modules:
        handles += [mod.register_forward_pre_hook(functools.partial(pre, name=name)),
                    mod.register_forward_hook(functools.partial(post, name=name))]
    wrapped = []
    for name, mod, attr in named_methods:
        def timed(*args, fn=getattr(mod, attr), name=name, **kw):
            pre(name=name)
            out = fn(*args, **kw)
            post(name=name)
            return out

        wrapped.append((mod, attr, vars(mod).get(attr)))
        setattr(mod, attr, timed)

    def remove():
        for h in handles:
            h.remove()
        for mod, attr, own in wrapped:
            if own is None:
                delattr(mod, attr)
            else:
                setattr(mod, attr, own)

    return events, remove


def mode_stages(model):
    """The mode's own stages, as ``named_methods`` of :func:`_stage_timer`:
    SGCls the box head (its 7x7 pool and MLP) and ``obj_prediction_nms``;
    SGDet ``detect`` and its stages, and ``relate``; none for PredCls."""
    if model.mode == "sgcls":
        return [("box_head", model, "_box_logits"),
                ("obj_prediction_nms", model, "_predict_labels")]
    if model.mode == "sgdet":
        return [("detect", model, "detect"), ("rpn_head", model, "rpn_maps"),
                ("propose", model, "propose"), ("box_head", model, "box_head"),
                ("box_postprocess", model, "postprocess_boxes"),
                ("relate", model, "relate")]
    return []


def meet_stages(model, stage: str, step_module, call: str):
    """MEET's stages (none without it), as ``named_methods``: the heads
    (one product inside the predictor), and ``stage``, the function
    ``call`` of ``step_module`` (the eval step's post-processing, or the
    train step's routing and group losses)."""
    from ..models.relation.predictor_meet import MeetPredictor

    if not isinstance(model.relation, MeetPredictor):
        return []
    return [("meet_heads", model.relation, "heads"),
            (stage, step_module, call)]


DETECT_STAGES = ("rpn_head", "propose", "box_head", "box_postprocess")


def derived_stages(ms, model_mode, own):
    """The stages that are differences of timed ones: the model's forward,
    the ROI pooling and the predictor without its encoder (and in SGDet the
    rest of ``detect``: anchors, the logits' gather)."""
    if model_mode == "sgdet":
        ms["model"] = ms["detect"] + ms["relate"]
        ms["detect_other"] = (ms["detect"] - ms["backbone"]
                              - sum(ms[n] for n in DETECT_STAGES))
        ms["roi_pooling"] = ms["relate"] - ms["depth_backbone"] - ms["relation"]
    else:
        ms["roi_pooling"] = (ms["model"] - ms["backbone"] - ms["depth_backbone"]
                             - ms["relation"] - sum(ms[n] for n in own))
    ms["predictor_without_encoder"] = ms["relation"] - ms["encoder"]


def profile(cfg, batches: int = 3, log=print) -> dict:
    from ..engine import evaluate
    from ..engine.evaluate import accumulate_eval, to_numpy
    from ..models.sgg import build_model
    from .relation_test_net import make_sgg_evaluator, synthetic_eval_dataset
    from .relation_train_net import make_eval_fn

    if cfg.relation.predictor.split("_MEET")[0] != "VETOPredictor":
        raise NotImplementedError(
            f"relation.predictor={cfg.relation.predictor}: the profiler times "
            "VETO's stages; the legacy heads' times are chip_smoke.py phase 19's")
    model = build_model(cfg)  # cuda; raises without a card
    dev = next(model.parameters()).device
    step = make_eval_fn(cfg, model)
    bsz = cfg.test.ims_per_batch
    data = list(synthetic_eval_dataset(cfg, (batches + 2) * bsz)
                .batches(bsz, cfg.data.max_boxes))
    first = to_numpy(step(data[0][0].to(dev)))  # warm-up: cuDNN plans, kernel loads
    extra = {}
    if cfg.relation.mode == "sgdet":
        extra["detections_per_image"] = float(first.det_mask.sum(1).mean())
        log(f"  detections an image: {first.det_mask.sum(1).tolist()}")

    stages = [("backbone", model.backbone),
              ("depth_backbone", model.depth_backbone),
              ("relation", model.relation),
              ("encoder", model.relation.trunk.fusion_transformer),
              ("model", model)]
    if cfg.relation.mode == "sgdet":
        stages.pop()  # the forward is not called: detect, then relate
    methods = mode_stages(model)
    meet = meet_stages(model, "meet_postprocess", evaluate,
                       "postprocess_meet")
    events, remove = _stage_timer(stages, methods + meet)
    evaluator = make_sgg_evaluator(cfg)
    h2d, step_s, host_eval = [], [], []
    for batch, recs in data[1:1 + batches]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = batch.to(dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        preds = to_numpy(step(b))
        t2 = time.perf_counter()
        accumulate_eval(preds, recs, evaluator, input_sizes=batch.sizes)
        host_eval.append(time.perf_counter() - t2)
        h2d.append(t1 - t0)
        step_s.append(t2 - t1)
    remove()
    torch.cuda.synchronize()
    ms = {name: float(np.mean([s.elapsed_time(e) for s, e in events[name]]))
          for name in [n for n, _ in stages] + [n for n, _, _ in methods + meet]}
    own = [n for n, _, _ in methods]
    derived_stages(ms, cfg.relation.mode, own)
    ms["pairs_postprocess_and_copy_back"] = 1e3 * float(np.mean(step_s)) - ms["model"]
    ms["host_to_card_copy"] = 1e3 * float(np.mean(h2d))
    ms["step"] = 1e3 * float(np.mean(step_s))
    for k in ["step", "host_to_card_copy", "model", "backbone",
              "depth_backbone", *own, *(["detect_other"] if "detect" in own else []),
              "roi_pooling", "relation", "encoder",
              "predictor_without_encoder", "pairs_postprocess_and_copy_back",
              *[n for n, _, _ in meet]]:
        log(f"  {k:32s} {ms[k]:9.3f} ms")
    extra["accumulate_eval_s"] = float(np.mean(host_eval))
    log(f"  accumulate_eval (host)           {extra['accumulate_eval_s']:9.4f} s a "
        f"batch ({[round(s, 4) for s in host_eval]})")

    b = data[-1][0].to(dev)
    return {"batch": bsz, "stage_ms": ms, **extra,
            **trace(lambda: to_numpy(step(b)), OWN_KERNELS, log)}


def trace(fn, own_kernels, log=print) -> dict:
    """One call of ``fn`` (ending on the host) under ``torch.profiler``:
    the device time by kernel, ``own_kernels`` summed by name, the device's
    busy share of the wall time, and the card's name and power limit."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us
    busy_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    log(f"  traced step: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%)")
    for name, us in top:
        log(f"    {us / 1e3:9.3f} ms  {name[:110]}")
    own = {k: sum(us for n, us in by_kernel.items() if k in n) / 1e3
           for k in own_kernels}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return {"card": card, "traced_wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "own_kernel_ms": own,
            "top_kernels_ms": {n[:110]: us / 1e3 for n, us in top}}


def main(argv=None):
    from ..config import load_config

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default="configs/veto_vg_predcls.yaml")
    parser.add_argument("--batches", type=int, default=3)
    parser.add_argument("opts", nargs="*", default=[])
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.opts)
    print(json.dumps(profile(cfg, args.batches)))


if __name__ == "__main__":
    main()
