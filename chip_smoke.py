#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``veto_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero, and no phase
catches its own failure:

1. Build both CUDA kernels from ``veto_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together) and print the card's name and power limit.
2. ROIAlign kernel vs its plain version at the PredCls eval shapes: P2-P5
   of 8 x 800x1344 images and the 1/16 depth map, 80 rois per image with
   edge cases, bf16 maps (and f32 maps once).
3. Encoder-layer kernel vs its plain version at 16,384 pairs x 19 tokens x
   576, and once with padded tokens (t_pad 24 > t_valid 19) and a row count
   that leaves a partial GEMM tile.
4. The main path: the full-width VETO PredCls model from seeded weights,
   3 synthetic batches of 8 x 800x1344 images (80 boxes, 2048 pairs)
   through the evaluation entry point's ``evaluate`` and ``SGGEvaluator``,
   with the kernels' launch counts read around it; then one batch's
   ``rel_logits`` against the same model run through the plain versions.
5. One JSON line ``{"kernels": [...]}`` and, last,
   ``{"ok": true, "device": {...}}``.

Every f32 comparison runs with TF32 off (``torch.backends.cudnn.allow_tf32``
and ``torch.backends.cuda.matmul.allow_tf32`` are set False below), so the
plain versions' f32 products are true f32.  Without a card the script
exits 2 before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
PEAK_F32 = 67e12     # H100 SXM f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
SCALES = (0.25, 0.125, 0.0625, 0.03125)
DEVICE = "cuda"


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Milliseconds per call: CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def check_close(name, got, ref, atol, rtol, mean_tol=None) -> float:
    """Raise unless |got - ref| <= atol + rtol |ref| everywhere (and the
    mean |got - ref| <= mean_tol); returns the max abs error."""
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    print(f"  {name}: max |err| {max_err:.3e}, mean |err| {mean_err:.3e} "
          f"(atol {atol}, rtol {rtol}, mean tol {mean_tol})")
    if bad.any() or (mean_tol is not None and mean_err > mean_tol):
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside "
                             f"tolerance, max err {max_err}, mean {mean_err}")
    return max_err


# ------------------------------------------------------------------ phase 1
def build():
    from veto_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    took = cuda_lib.build()
    print(f"[build] {json.dumps({k: round(v, 1) for k, v in took.items()})} "
          f"total {time.perf_counter() - t0:.1f} s into {cuda_lib.BUILD_DIR}")
    for name in cuda_lib.SOURCES:
        log = cuda_lib.BUILD_DIR / f"{name}.log"
        if log.exists():  # absent when the library was already built
            text = log.read_text()
            used = [ln.split(": ", 1)[-1] for ln in text.splitlines()
                    if "Used" in ln]
            spills = "no spills" if " 0 bytes spill stores" in text and \
                "spill stores" not in text.replace(" 0 bytes spill stores", "") \
                else "SPILLS"
            print(f"  {name} ptxas ({spills}): " + "; ".join(used))
    print(f"[card] {card()}")


# ------------------------------------------------------------------ phase 2
def eval_rois(gen, b=8, r=80, h=800, w=1344):
    """Rois as the synthetic corpus draws them at the eval shape, with the
    edge cases in image 0: one roi per FPN level, rois partly off the map,
    degenerate (< 1 px) rois, one 1:6 roi 60 rows tall on P2 (taller than
    the TPU kernel's window) and padded zero boxes."""
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(b, r, generator=gen,  # noqa: E731
                                                   device=DEVICE)
    x1, y1 = u(0, w * 0.7), u(0, h * 0.7)
    x2 = torch.minimum(x1 + u(w * 0.1, w * 0.3), torch.tensor(w - 1.0, device=DEVICE))
    y2 = torch.minimum(y1 + u(h * 0.1, h * 0.3), torch.tensor(h - 1.0, device=DEVICE))
    rois = torch.stack([x1, y1, x2, y2], -1)
    edge = torch.tensor([
        [10, 20, 60, 70], [100, 80, 250, 230], [50, 40, 350, 340],
        [10, 5, 900, 780],                            # P2 .. P5
        [-30, -20, 40, 60], [1300, 760, 1400, 860],   # off the map
        [200.2, 100.7, 200.5, 100.9], [0, 0, 0, 0],   # degenerate / padding
        [300, 10, 340, 250],                          # 1:6, 60 rows on P2
    ], dtype=torch.float32, device=DEVICE)
    rois[0, :len(edge)] = edge
    rois[1, -8:] = 0.0                                # padded boxes
    return rois


def roi_tap_bytes(feats, rois, levels, scales, p=8, s=2) -> int:
    """Bytes of the distinct map pixels that the rois' in-range bilinear
    samples read: what this run's data needs from the maps."""
    from veto_tpu_torch.ops.roi_align import _sample_coords

    b, r = rois.shape[:2]
    flat, lv = rois.reshape(-1, 4).float(), levels.reshape(-1)
    bidx = torch.arange(b, device=rois.device).repeat_interleave(r)
    total = 0
    for lvl, (f, sc) in enumerate(zip(feats, scales)):
        sel = lv == lvl
        n = int(sel.sum())
        if not n:
            continue
        _, h, w, c = f.shape
        ys, xs = _sample_coords(flat[sel], sc, p, s)
        y = ys.reshape(n, -1, 1).expand(n, p * s, p * s)
        x = xs.reshape(n, 1, -1).expand(n, p * s, p * s)
        ok = ~((y < -1) | (y > h) | (x < -1) | (x > w))
        yl = torch.floor(y.clamp(min=0)).clamp(max=h - 1)
        xl = torch.floor(x.clamp(min=0)).clamp(max=w - 1)
        yh, xh = (yl + 1).clamp(max=h - 1), (xl + 1).clamp(max=w - 1)
        bb = bidx[sel].reshape(n, 1, 1).expand_as(y)
        keys = torch.cat([((bb * h + yy.long()) * w + xx.long())[ok]
                          for yy in (yl, yh) for xx in (xl, xh)])
        total += int(torch.unique(keys).numel()) * c * f.element_size()
    return total


def phase_roi_align(gen, b=8, h=800, w=1344, c=256):
    from veto_tpu_torch.ops import roi_align_windowed as rw

    print(f"[roi_align] kernel vs plain, {b} x {h}x{w} images, {c} channels")
    p = 8
    feats = [torch.randn(b, h // k, w // k, c, generator=gen, device=DEVICE)
             .to(torch.bfloat16) for k in (4, 8, 16, 32)]
    depth = torch.randn(b, h // 16, w // 16, c, generator=gen,
                        device=DEVICE).to(torch.bfloat16)
    rois = eval_rois(gen, b, 80, h, w)
    calls = [(feats, SCALES), ([depth], (0.0625,))]
    errs = []
    for (fs, sc), what in zip(calls, ("P2-P5 bf16", "depth 1/16 bf16")):
        got = rw.multilevel_roi_align_batched(fs, rois, sc, p, 2)
        ref = rw.reference_multilevel_roi_align_batched(fs, rois, sc, p, 2)
        # both take f32 weights and f32 sums of the same bf16 taps; only
        # the order of the 16 products differs
        errs.append(check_close(what, got, ref, atol=1e-5, rtol=1e-5))
    f32 = [f[:2].float() for f in feats]
    got = rw.multilevel_roi_align_batched(f32, rois[:2], SCALES, p, 2)
    ref = rw.reference_multilevel_roi_align_batched(f32, rois[:2], SCALES, p, 2)
    errs.append(check_close("P2-P5 f32", got, ref, atol=1e-5, rtol=1e-5))

    def kernel():
        for fs, sc in calls:
            rw.multilevel_roi_align_batched(fs, rois, sc, p, 2)

    def plain():
        for fs, sc in calls:
            rw.reference_multilevel_roi_align_batched(fs, rois, sc, p, 2)

    per_call = [cuda_ms(lambda fs=fs, sc=sc: rw.multilevel_roi_align_batched(
        fs, rois, sc, p, 2), 50) for fs, sc in calls]
    ms, plain_ms = cuda_ms(kernel, 50), cuda_ms(plain, 3)
    out_bytes = 2 * b * rois.shape[1] * p * p * c * 4
    in_bytes = (roi_tap_bytes(feats, rois, rw.fpn_level_assignment(rois), SCALES)
                + roi_tap_bytes([depth], rois, torch.zeros_like(rois[..., 0]), (0.0625,))
                + 2 * rois.numel() * 4)
    flops = 2 * b * rois.shape[1] * p * p * c * 16 * 2  # 16 FMAs per output
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32 * 1e3
    print(f"  per batch (P2-P5 + depth): kernel {ms:.4f} ms "
          f"({per_call[0]:.4f} + {per_call[1]:.4f}), plain {plain_ms:.3f} ms; "
          f"moves {in_bytes / 1e6:.1f} MB of taps and rois + "
          f"{out_bytes / 1e6:.1f} MB out -> bound {max(t_bytes, t_ops):.4f} ms")
    return dict(name="multilevel_roi_align", route="cuda",
                source="veto_tpu_torch/csrc/roi_align.cu",
                replaces="veto_tpu/ops/roi_align_windowed.py:175",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


# ------------------------------------------------------------------ phase 3
def enc_params(gen, d=576, f=1152):
    from veto_tpu_torch.ops.fused_encoder import EncoderLayerParams

    def n(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=DEVICE) * std

    return EncoderLayerParams(
        ln1_scale=1 + n(d, std=0.1), ln1_bias=n(d, std=0.1),
        w_qkv=n(d, 3 * d, std=d ** -0.5).bfloat16(),
        w_out=n(d, d, std=d ** -0.5).bfloat16(), b_out=n(d, std=0.1),
        ln2_scale=1 + n(d, std=0.1), ln2_bias=n(d, std=0.1),
        w1=n(d, f, std=d ** -0.5).bfloat16(), b1=n(f, std=0.1),
        w2=n(f, d, std=f ** -0.5).bfloat16(), b2=n(d, std=0.1))


def library_layer(params, heads):
    """torch's own PreNorm encoder layer with the same weights: the
    yardstick ``library_ms`` (never called by the port)."""
    d, f = params.w1.shape
    layer = torch.nn.TransformerEncoderLayer(
        d, heads, f, dropout=0.0, activation="gelu", layer_norm_eps=1e-6,
        batch_first=True, norm_first=True, device=DEVICE,
        dtype=torch.bfloat16).eval()
    with torch.no_grad():
        layer.self_attn.in_proj_weight.copy_(params.w_qkv.t())
        layer.self_attn.in_proj_bias.zero_()
        layer.self_attn.out_proj.weight.copy_(params.w_out.t())
        layer.self_attn.out_proj.bias.copy_(params.b_out)
        layer.linear1.weight.copy_(params.w1.t())
        layer.linear1.bias.copy_(params.b1)
        layer.linear2.weight.copy_(params.w2.t())
        layer.linear2.bias.copy_(params.b2)
        layer.norm1.weight.copy_(params.ln1_scale)
        layer.norm1.bias.copy_(params.ln1_bias)
        layer.norm2.weight.copy_(params.ln2_scale)
        layer.norm2.bias.copy_(params.ln2_bias)
    return layer


def phase_encoder(gen, pairs=16384, d=576):
    from veto_tpu_torch.ops import fused_encoder as fe

    t, heads = 19, 6
    print(f"[encoder] kernel vs plain, {pairs} pairs x {t} tokens x {d}")
    params = enc_params(gen, d)
    f = params.w1.shape[1]
    # same rounding points in both; an f32 sum in another order can flip
    # one bf16 rounding, which moves that value by a bf16 ulp or two
    tol = dict(atol=6e-2, rtol=2e-2, mean_tol=5e-3)
    with torch.inference_mode():
        x = torch.randn(pairs * t, d, generator=gen, device=DEVICE).bfloat16()
        err = check_close("t_pad=t_valid=19", fe.fused_encoder_layer(x, params, heads, t, t),
                          fe.reference_encoder_layer(x, params, heads, t, t), **tol)
        # 509 pairs: 12,216 rows, not a multiple of the 128-row GEMM tile
        xp = torch.randn(min(pairs, 509) * 24, d, generator=gen, device=DEVICE).bfloat16()
        err = max(err, check_close(
            "t_pad=24, t_valid=19", fe.fused_encoder_layer(xp, params, heads, 24, t),
            fe.reference_encoder_layer(xp, params, heads, 24, t), **tol))
        ms = cuda_ms(lambda: fe.fused_encoder_layer(x, params, heads, t, t), 20)
        plain_ms = cuda_ms(lambda: fe.reference_encoder_layer(x, params, heads, t, t), 3)
        layer = library_layer(params, heads)
        x3 = x.view(pairs, t, d)
        library_ms = cuda_ms(lambda: layer(x3), 10)
    rows = pairs * t
    flops = (2 * rows * (d * 3 * d + d * d + 2 * d * f)
             + 4 * pairs * heads * t * t * (d // heads))
    nbytes = 2 * rows * d * 2 + sum(p.numel() * p.element_size() for p in params)
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    print(f"  kernel {ms:.3f} ms/layer ({flops / ms / 1e9:.1f} TFLOP/s), plain "
          f"{plain_ms:.3f} ms, torch TransformerEncoderLayer {library_ms:.3f} ms; "
          f"{flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB -> bound "
          f"{max(t_ops, t_bytes):.3f} ms")
    return dict(name="fused_encoder_layer", route="cuda",
                source="veto_tpu_torch/csrc/encoder_layer.cu",
                replaces="veto_tpu/ops/fused_encoder.py:258",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=library_ms)


# ------------------------------------------------------------------ phase 4
def phase_main_path(opts=()):
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.models.relation.sampling import prepare_test_pairs
    from veto_tpu_torch.models.sgg import build_model
    from veto_tpu_torch.ops import cuda_lib
    from veto_tpu_torch.ops import fused_encoder as fe
    from veto_tpu_torch.ops import roi_align_windowed as rw
    from veto_tpu_torch.tools.relation_test_net import (
        evaluate, synthetic_eval_dataset,
    )

    n_batches = 3
    cfg = load_config(os.path.join(ROOT, "configs", "veto_vg_predcls.yaml"),
                      list(opts))
    model = build_model(cfg)  # cuda, seeded weights, eval mode
    layers = cfg.veto.enc_layers
    print(f"[main] VETO PredCls, {cfg.model.backbone} "
          f"{cfg.model.resnet_groups}x{cfg.model.resnet_width_per_group}d "
          f"blocks {tuple(cfg.model.stage_blocks)}, trunk {cfg.veto.t_input_dim} "
          f"x {layers} layers, {cfg.dtype}; {n_batches} batches of "
          f"{cfg.test.ims_per_batch}, {cfg.data.max_boxes} boxes, "
          f"{cfg.relation.max_proposal_pairs} pairs")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fe.KERNEL_LAUNCHES = rw.KERNEL_LAUNCHES = 0
    agg, seconds = evaluate(cfg, model=model, max_batches=n_batches,
                            log=lambda s: print("  " + s))
    launches = {"fused_encoder_layer": fe.KERNEL_LAUNCHES,
                "multilevel_roi_align": rw.KERNEL_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    print(f"  launches {json.dumps(launches)}; after warm-up "
          f"{1e3 * float(np.mean(seconds[1:])):.1f} ms per batch "
          f"({[round(1e3 * s, 1) for s in seconds]}); peak memory "
          f"{peak / 2 ** 30:.2f} GiB")
    if len(seconds) != n_batches:
        raise AssertionError(f"{len(seconds)} batches ran, not {n_batches}")
    if launches["fused_encoder_layer"] != layers * n_batches:
        raise AssertionError(f"encoder kernel launched "
                             f"{launches['fused_encoder_layer']} times, "
                             f"expected {layers} per batch")
    if launches["multilevel_roi_align"] < n_batches:
        raise AssertionError("ROIAlign kernel launched less than once per batch")
    for m in ("R", "mR"):
        if not all(np.isfinite(v) and 0 <= v <= 100 for v in agg[m].values()):
            raise AssertionError(f"{m}@K out of range: {agg[m]}")

    # one batch through the kernels and through the plain versions
    bsz = cfg.test.ims_per_batch
    batch, _ = next(synthetic_eval_dataset(cfg, bsz).batches(bsz, cfg.data.max_boxes))
    b = batch.to(DEVICE)
    with torch.inference_mode():
        pair_idx, pair_mask = prepare_test_pairs(
            b.box_mask, b.box_mask.float(), cfg.relation.max_proposal_pairs)
        args = (b.images, b.depth, b.boxes, b.box_mask, b.labels,
                b.obj_logits, pair_idx, pair_mask)
        got = model(*args).rel_logits
        with cuda_lib.plain_kernels():
            ref = model(*args).rel_logits
    want = (bsz, cfg.relation.max_proposal_pairs, cfg.relation.num_classes)
    if tuple(got.shape) != want or got.dtype != torch.float32:
        raise AssertionError(f"rel_logits {tuple(got.shape)} {got.dtype}, want {want}")
    # bf16 through six layers: a rounding flip anywhere moves the logits by
    # about a bf16 ulp of their scale; hold max and mean to that scale
    scale = float(ref.abs().max())
    check_close("rel_logits kernels vs plain", got, ref, atol=0.05 * scale,
                rtol=0.0, mean_tol=0.01 * float(ref.abs().mean()))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs the port on "
              "an NVIDIA card", file=sys.stderr)
        return 2
    import veto_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    kernels = [phase_roi_align(gen), phase_encoder(gen)]
    launches = phase_main_path()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(f"[card] {card()}")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
