"""Where the PredCls train step spends its time on the card.

    python -m veto_tpu_torch.tools.profile_train \\
        [--config configs/veto_vg_predcls.yaml] [--steps 3] [opts ...]

Builds the model of the config on ``cuda`` from seeded weights and its
train state, runs one warm-up step on the synthetic train split, then

* times each following step with CUDA events: pair sampling; the forward's
  stages by forward hooks (the frozen detector body + FPN, the depth
  backbone, the relation predictor and, inside it, the encoder; ROI pooling
  is what remains of the forward); the loss and the backward together; the
  optimizer update (clipping, Adam); the whole step on the host clock,
  ending after the update on the device;
* traces one more step with ``torch.profiler`` and reports the device time
  by kernel, the port's own kernels by name, and the device's busy share of
  the step's wall time.

The last line is one JSON object with these numbers and the card's name.
It needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .profile_eval import OWN_KERNELS, _stage_timer, trace

# the backward kernels of csrc/encoder_layer_bwd.cu, csrc/roi_align.cu and
# csrc/pair_attention.cu (its GEMMs are OWN_KERNELS' gemm_sm90_kernel)
OWN_BWD_KERNELS = ("attention_bwd_mma_kernel",
                   "ln_backward_kernel", "splitk_reduce_kernel",
                   "colsum_reduce_kernel", "roi_align_bwd_kernel",
                   "pair_attn_bwd_kernel")


def profile(cfg, steps: int = 3, log=print) -> dict:
    from ..engine.train import create_train_state, forward_backward, sample_pairs
    from ..models.sgg import build_model
    from ..solver.optim import LRController
    from .relation_train_net import rel_class_weights, synthetic_train_dataset

    model = build_model(cfg)  # cuda; raises without a card
    dev = next(model.parameters()).device
    state = create_train_state(model, cfg.solver, rel_class_weights(cfg))
    scale = LRController(cfg.solver).scale(0)
    gen = torch.Generator(device=dev).manual_seed(cfg.solver.seed)
    bsz = cfg.solver.ims_per_batch
    data = [b.to(dev) for b, _ in synthetic_train_dataset(cfg, (steps + 2) * bsz)
            .batches(bsz, cfg.data.max_boxes)]

    def step(b, marks=None):
        def mark():
            if marks is not None:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
        mark()
        samples = sample_pairs(b, gen, cfg.relation.batch_size_per_image,
                               cfg.relation.positive_fraction)
        mark()
        loss = forward_backward(state, b, samples)
        mark()
        state.optimizer.step(scale)
        mark()
        return float(loss)

    step(data[0])  # warm-up: cuDNN plans, kernel loads
    stages = [("backbone", model.backbone),
              ("depth_backbone", model.depth_backbone),
              ("relation", model.relation),
              ("encoder", model.relation.trunk.fusion_transformer),
              ("model", model)]
    events, remove = _stage_timer(stages)
    marks, step_s = [], []
    for b in data[1:1 + steps]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(b, marks)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    remove()
    torch.cuda.synchronize()
    ms = {name: float(np.mean([s.elapsed_time(e) for s, e in events[name]]))
          for name, _ in stages}
    spans = np.array([[marks[4 * i + k].elapsed_time(marks[4 * i + k + 1])
                       for k in range(3)] for i in range(steps)]).mean(0)
    ms["sampling"] = float(spans[0])
    ms["loss_and_backward"] = float(spans[1]) - ms["model"]
    ms["optimizer"] = float(spans[2])
    ms["roi_pooling"] = (ms["model"] - ms["backbone"] - ms["depth_backbone"]
                         - ms["relation"])
    ms["predictor_without_encoder"] = ms["relation"] - ms["encoder"]
    ms["step"] = 1e3 * float(np.mean(step_s))
    for k in ("step", "sampling", "model", "backbone", "depth_backbone",
              "roi_pooling", "relation", "encoder", "predictor_without_encoder",
              "loss_and_backward", "optimizer"):
        log(f"  {k:32s} {ms[k]:9.3f} ms")

    b = data[-1]
    return {"batch": bsz, "pairs_per_image": cfg.relation.batch_size_per_image,
            "stage_ms": ms,
            **trace(lambda: (step(b), torch.cuda.synchronize()),
                    OWN_KERNELS + OWN_BWD_KERNELS, log)}


def main(argv=None):
    from ..config import load_config

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default="configs/veto_vg_predcls.yaml")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("opts", nargs="*", default=[])
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.opts)
    print(json.dumps(profile(cfg, args.steps)))


if __name__ == "__main__":
    main()
