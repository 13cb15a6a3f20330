"""Device time of the ROIAlign kernels (B3, B3-bwd) at the PredCls shapes.

    python -m veto_tpu_torch.tools.profile_roi_align [--tree DIR] [--calls N]

Times, by ``torch.profiler``, the forward at the eval shape (P2-P5 and the
1/16 depth map of 8 x 800x1344 images, 256 bf16 channels, 8x8 bins) and
the backward at the train shape (the depth map of 12 images), each over
``--calls`` calls: the kernel's own device time and the device time of
every kernel the call launches (the level mapper's, a zero-fill or a cast
where there is one).  Two sets of boxes: ``corpus``, the synthetic split's
first batch as the main path pools it (4 to 80 boxes an image, padded to
80 with zero boxes, which all pool the map's corner), and ``dense``, 80
boxes an image drawn the same way with no padding.  ``--tree`` times the
port of another checkout (for example an earlier commit unpacked with
``git archive``) on the same inputs, so that two versions are compared on
one card in one run.  Needs a CUDA card; prints one JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys

SCALES = (0.25, 0.125, 0.0625, 0.03125)


def eval_rois(torch, gen, b, r, h=800, w=1344):
    """Rois as the synthetic corpus draws them (10-30% of each side)."""
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(b, r, generator=gen, device="cuda")

    x1, y1 = u(0, w * 0.7), u(0, h * 0.7)
    x2 = torch.minimum(x1 + u(w * 0.1, w * 0.3), torch.tensor(w - 1.0, device="cuda"))
    y2 = torch.minimum(y1 + u(h * 0.1, h * 0.3), torch.tensor(h - 1.0, device="cuda"))
    return torch.stack([x1, y1, x2, y2], -1)


def corpus_rois(torch, b, train: bool, config: str = "configs/veto_vg_predcls.yaml"):
    """The boxes of the synthetic split's first batch of ``b`` images at the
    config's shapes, padded with zero boxes to ``data.max_boxes``, on the
    card."""
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.tools import relation_test_net, relation_train_net

    cfg = load_config(config)
    ds = (relation_train_net.synthetic_train_dataset(cfg, b) if train
          else relation_test_net.synthetic_eval_dataset(cfg, b))
    boxes = torch.zeros(b, cfg.data.max_boxes, 4)
    for i in range(b):
        got = torch.from_numpy(ds[i]["boxes"])[: cfg.data.max_boxes]
        boxes[i, : len(got)] = got
    return boxes.cuda()


def profile(calls: int = 20) -> dict:
    import torch

    rw = importlib.import_module("veto_tpu_torch.ops.roi_align_windowed")
    trace = importlib.import_module("veto_tpu_torch.tools.profile_eval").trace
    if not torch.cuda.is_available():
        raise RuntimeError("profile_roi_align times the kernels on a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    c, p = 256, 8
    feats = [torch.randn(8, 800 // k, 1344 // k, c, generator=gen, device="cuda")
             .bfloat16() for k in (4, 8, 16, 32)]
    depth = torch.randn(8, 50, 84, c, generator=gen, device="cuda").bfloat16()
    depth12 = torch.randn(12, 50, 84, c, generator=gen, device="cuda").bfloat16()
    g = torch.randn(12, 80, p, p, c, generator=gen, device="cuda")
    boxes = {"corpus": (corpus_rois(torch, 8, False), corpus_rois(torch, 12, True)),
             "dense": (eval_rois(torch, gen, 8, 80), eval_rois(torch, gen, 12, 80))}
    out = {}

    def timed(name, fn, kernel):
        fn()
        got = trace(lambda: [fn() for _ in range(calls)], [kernel], log=lambda s: None)
        out[name] = {"kernel_ms": got["own_kernel_ms"][kernel] / calls,
                     "call_device_ms": got["device_busy_ms"] / calls}

    for which, (rois, rois12) in boxes.items():
        for name, fs, sc in (("fwd_p2_p5", feats, SCALES), ("fwd_depth", [depth], (0.0625,))):
            with torch.no_grad():
                timed(f"{name}_{which}", lambda fs=fs, sc=sc: rw.multilevel_roi_align_batched(
                    fs, rois, sc, p, 2), "roi_align_fwd_kernel")
        timed(f"bwd_depth_{which}", lambda: rw._launch_backward(
            [depth12], [True], rois12, g, (0.0625,), p, 2), "roi_align_bwd_kernel")
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=None,
                        help="root of another checkout whose port to time")
    parser.add_argument("--calls", type=int, default=20)
    args = parser.parse_args(argv)
    if args.tree:
        for name in [m for m in sys.modules if m.startswith("veto_tpu_torch")]:
            del sys.modules[name]
        sys.path.insert(0, args.tree)
    res = profile(args.calls)
    res["tree"] = args.tree or "this checkout"
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
