"""Where the PredCls evaluation step spends its time on the card.

    python -m veto_tpu_torch.tools.profile_eval \\
        [--config configs/veto_vg_predcls.yaml] [--batches 3] [opts ...]

Builds the model of the config on ``cuda`` from seeded weights, runs one
warm-up batch of the synthetic split, then

* times the stages of each following batch with CUDA events recorded by
  forward hooks: the detector body + FPN, the depth backbone, the relation
  predictor and, inside it, the encoder; pooling is what remains of the
  model's forward, pair preparation + post-processing what remains of the
  step; the host-to-card copy of the batch and the whole step (ending with
  the predictions on the host) are timed on the host clock;
* traces one more batch with ``torch.profiler`` and reports the device time
  by kernel, the port's own kernels by name, and the device's busy share of
  the step's wall time.

The last line is one JSON object with these numbers and the card's name.
It needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import numpy as np
import torch

# kernels of veto_tpu_torch/csrc, by the name the profiler shows
OWN_KERNELS = ("gemm_bf16_kernel", "pair_attention_kernel", "layernorm_kernel",
               "roi_align_fwd_kernel")


def _stage_timer(named_modules):
    """Forward hooks that record a CUDA event pair around each module's
    forward; returns (events list per name, remove callback)."""
    events = collections.defaultdict(list)
    handles = []
    for name, mod in named_modules:
        def pre(_m, _a, name=name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events[name].append([e, None])

        def post(_m, _a, _o, name=name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events[name][-1][1] = e

        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    return events, lambda: [h.remove() for h in handles]


def profile(cfg, batches: int = 3, log=print) -> dict:
    from ..engine.evaluate import make_eval_step, to_numpy
    from ..models.sgg import build_model
    from .relation_test_net import synthetic_eval_dataset

    model = build_model(cfg)  # cuda; raises without a card
    dev = next(model.parameters()).device
    step = make_eval_step(model, max_pairs=cfg.relation.max_proposal_pairs)
    bsz = cfg.test.ims_per_batch
    data = list(synthetic_eval_dataset(cfg, (batches + 2) * bsz)
                .batches(bsz, cfg.data.max_boxes))
    to_numpy(step(data[0][0].to(dev)))  # warm-up: cuDNN plans, kernel loads

    stages = [("backbone", model.backbone),
              ("depth_backbone", model.depth_backbone),
              ("relation", model.relation),
              ("encoder", model.relation.trunk.fusion_transformer),
              ("model", model)]
    events, remove = _stage_timer(stages)
    h2d, step_s = [], []
    for batch, _ in data[1:1 + batches]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = batch.to(dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        to_numpy(step(b))
        t2 = time.perf_counter()
        h2d.append(t1 - t0)
        step_s.append(t2 - t1)
    remove()
    torch.cuda.synchronize()
    ms = {name: float(np.mean([s.elapsed_time(e) for s, e in events[name]]))
          for name, _ in stages}
    ms["roi_pooling"] = (ms["model"] - ms["backbone"] - ms["depth_backbone"]
                         - ms["relation"])
    ms["predictor_without_encoder"] = ms["relation"] - ms["encoder"]
    ms["pairs_postprocess_and_copy_back"] = 1e3 * float(np.mean(step_s)) - ms["model"]
    ms["host_to_card_copy"] = 1e3 * float(np.mean(h2d))
    ms["step"] = 1e3 * float(np.mean(step_s))
    for k in ("step", "host_to_card_copy", "model", "backbone",
              "depth_backbone", "roi_pooling", "relation", "encoder",
              "predictor_without_encoder", "pairs_postprocess_and_copy_back"):
        log(f"  {k:32s} {ms[k]:9.3f} ms")

    b = data[-1][0].to(dev)
    return {"batch": bsz, "stage_ms": ms,
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
