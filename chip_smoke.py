#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``veto_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero, and no phase
catches its own failure:

1. Build the CUDA kernels from ``veto_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together), print ptxas's registers and spills and the
   card's name and power limit.
2. The GEMM core (``csrc/gemm_sm90.cuh``: wgmma fed by TMA through an
   mbarrier ring) alone against ``torch.matmul`` in f32, at every product
   shape of the main path (B1's four at 311,296 rows, B2a's and B2b's at
   233,472, the split-K weight gradients) in the operand majors each is
   used with, and at 12,216 rows; its ms and TFLOP/s beside
   ``torch.matmul`` in bf16; the Python mirror of the split count against
   the C code's.
3. ROIAlign kernel (B3) vs its plain version at the PredCls eval shapes:
   P2-P5 of 8 x 800x1344 images and the 1/16 depth map, 80 rois per image
   with edge cases, bf16 maps, P = 8; P2-P5 at P = 7 (the SGCls box head);
   f32 maps once.  Its device time by ``torch.profiler`` and GB/s against
   its bound (bytes).
4. Encoder-layer kernel vs its plain version at 16,384 pairs x 19 tokens x
   576, and once with padded tokens (t_pad 24 > t_valid 19) and a row count
   that leaves a partial GEMM tile.
5. The main path: the full-width VETO PredCls model from seeded weights,
   3 synthetic batches of 8 x 800x1344 images (80 boxes, 2048 pairs)
   through the evaluation entry point's ``evaluate`` and ``SGGEvaluator``,
   with exact launch counts per batch (B1 6, B3 2, every other kernel 0);
   then one batch's ``rel_logits`` against the same model run through the
   plain versions.
6. Encoder backward kernels.  First B2b's attention backward alone (the
   tensor-core kernel that B2b and B5 launch) vs the plain ``_attention_bwd``
   (att, dq, dk, dv) and, without datt, vs ``_attention``, at 12,288 pairs x
   19 and at 509 pairs with t_pad 24 > t_valid 19, two runs bit-equal; its
   time against its bound and SDPA's backward, and the HMMA instructions
   in its SASS (``cuobjdump``).  Then B2a (FFN) and B2b (attention) vs their
   plain versions at the train shape (12,288 pairs x 19 x 576, and once
   with t_pad 24 > t_valid 19 and a partial GEMM tile); two kernel runs
   must give bit-equal gradients; each pass's kernels timed by
   ``torch.profiler`` (the LN backwards against their bounds).
7. ROIAlign backward kernel (B3-bwd) vs autograd of the plain pooling on
   the 1/16 depth map of 12 x 800x1344 images, 80 rois each, and on every
   level of P2-P5 of 2 images at P = 7 with 512 rois each; two kernel runs
   bit-equal in both; the C tile plan against its Python mirror; device
   time and GB/s against the bound.
8. Pair-attention kernels B4a and B4b vs their plain versions, q/k/v the
   thirds of a packed qkv: on the tensor-core route (the attention of
   ``csrc/pair_attention_sm90.cuh`` that B2b and B5 run) at 16,384 and
   12,288 pairs x 19 x 576 and at 509 pairs with t_pad 24 > t_valid 19, on
   the CUDA-core route at 509 pairs x 67 tokens; two runs bit-equal each;
   the route rule and shared memory in C against their Python mirrors;
   HMMA in the SASS.  Device times by ``torch.profiler`` on the same
   inputs: the tensor-core route, the CUDA-core route called directly
   (which it must beat) and SDPA with the key mask, each against the bound.
9. Monolithic encoder backward B5 vs its plain version at 12,288 pairs,
   with and without the qkv/x1 stash; two kernel runs bit-equal; B5 vs
   B2a + B2b on the same input; the two external dW ``torch.matmul``s
   timed apart.
10. The training main path: ``relation_train_net.train`` for 5 full-width
    PredCls steps from seeded weights, with exact launch counts per step
    (B1, B2a, B2b 6 each, B3 2, B3-bwd 1, B4a, B4b, B5 0), finite losses,
    every trainable tensor changed and the frozen detector bit-unchanged;
    then one step's gradients through the kernels against the same step
    through the plain versions, and the floor of that check: what two
    kernel runs of the step differ by (0, or the tensors that vary).
11. The ``veto.encoder_impl=pair_attn`` path: 2 eval batches (B4a 6, B3 2
    per batch), 3 train steps (B4a 6, B4b 6, B3 2, B3-bwd 1 per step), all
    on the tensor-core route (the CUDA-core route 0), and one step's
    gradients against the plain versions.
12. The monolithic-backward path: 3 train steps with
    ``fused_encoder.FUSED_SPLIT = False`` (B1 6, B5 6, B3 2, B3-bwd 1 per
    step), 3 more with ``FUSED_STASH = False`` too, and one step's
    gradients against the plain versions; both constants restored after.
13. Training and evaluation from Visual-Genome-shaped data at full width
    (``VGShapedDataset``: VG's image sizes, both aspects, up to 80 boxes,
    in memory, since the card's machine has neither the VG files nor h5py):
    the port's host ops (built by ``g++``) against the NumPy pipeline; the
    loader's images/s; an eval batch's pinned non-blocking copy against the
    pageable one; a reference-format detector state dict written with
    ``torch.save`` and imported through ``model.pretrained_detector_ckpt``
    with ``fold_bn`` false and true (every tensor equal to the reference
    under the mapping, both pyramids equal in f32, both models' logits
    against their plain versions, and against each other with the detector
    in f32 and in bf16);
    ``relation_train_net.train`` through ``SGGLoader`` and the device feeder
    for 6 steps (both buckets, exact launch counts at every step and at the
    validation of step 4, whose two batches are landscape and the 1344 x
    1344 envelope; checkpoints at 3 and 6; the validation's mR@100 in the
    plateau controller); the step-6 checkpoint restored on the CPU and by
    ``relation_test_net.evaluate``, which reproduces the step-6 model's
    validation exactly; a second ``train`` resumed from step 3 bit-equal to
    3 + 3 steps on the resumed stream without a save; the step fed from
    memory; checkpoint save and restore times; then both buckets' step
    gradients and the three eval shapes' logits against the plain versions,
    and B3 / B3-bwd at the portrait and envelope shapes.
14. One JSON line ``{"kernels": [...]}`` (all eight kernels; ``launches``
    from the training path that runs each) and, last,
    ``{"ok": true, "device": {...}}``.

Every f32 comparison runs with TF32 off (``torch.backends.cudnn.allow_tf32``
and ``torch.backends.cuda.matmul.allow_tf32`` are set False below), so the
plain versions' f32 products are true f32.  Without a card the script
exits 2 before printing any result.
"""

from __future__ import annotations

import contextlib
import ctypes
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


def device_ms(fn, kernel: str, calls: int) -> float:
    """Device milliseconds per launch of the kernels whose name holds
    ``kernel``, by ``torch.profiler`` over ``calls`` calls of ``fn`` (a
    wrapper's time by CUDA events also counts the host's work between its
    launches, when the card waits for it).  Divided by the launches the
    trace holds, not by ``calls``: a trace that misses launches would
    otherwise read short.  A trace that holds no launch at all (CUPTI
    drops a trace's records now and then on the card) is taken again, up to
    three times."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for e in prof.key_averages():
            if (kernel in e.key and e.device_type == torch.autograd.DeviceType.CUDA
                    and (getattr(e, "self_device_time_total", 0) or 0) > 0):
                us += e.self_device_time_total
                n += e.count
        if n:
            break
        print(f"  ({kernel}: trace {attempt + 1} holds no launch)")
    if n == 0:
        raise AssertionError(f"the trace holds no launch of {kernel}")
    if n != calls:
        print(f"  ({kernel}: the trace holds {n} launches of {calls})")
    return us / n / 1e3


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
    atol_s = atol if isinstance(atol, float) else "per element"
    print(f"  {name}: max |err| {max_err:.3e}, mean |err| {mean_err:.3e} "
          f"(atol {atol_s}, rtol {rtol}, mean tol {mean_tol})")
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
            entries = ptxas_entries(log.read_text())
            spilled = [e for e, (_, spill) in entries.items() if spill]
            print(f"  {name} ptxas: {len(entries)} kernels, registers "
                  f"{sorted({regs for regs, _ in entries.values()})}, "
                  f"spills {spilled or 'none'}")
            for e, (regs, spill) in entries.items():
                if "attention_bwd_mma_kernel" in e or "ln_backward_kernel" in e and "Li9E" in e:
                    print(f"    {e}: {regs} registers, {spill} bytes spilled")
    print(f"[card] {card()}")


def ptxas_entries(text):
    """ptxas -v's report by kernel: {mangled name: (registers, bytes of
    spill stores)}."""
    out, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function '" in line:
            name = line.split("'")[1]
        elif name and "bytes spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
            out[name] = (0, spill)
        elif name and "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split("registers")[0])
            out[name] = (regs, out.get(name, (0, 0))[1])
            name = None
    return out


# ------------------------------------------------------------------ phase 2
# (name, M, N, K, mode): the encoder's products at the main path's shapes,
# in the operand majors each is used with (fused_encoder.gemm_product: mode
# 0 x W, W (in, out) read MN-major; 1 x W^T, W read K-major; 2 the split-K
# weight gradient A^T B, both read MN-major)
EVAL_ROWS, TRAIN_ROWS, D, F = 16384 * 19, 12288 * 19, 576, 1152
GEMM_SHAPES = (
    ("B1 qkv", EVAL_ROWS, 3 * D, D, 0),
    ("B1 out-proj", EVAL_ROWS, D, D, 0),
    ("B1 FFN1", EVAL_ROWS, F, D, 0),
    ("B1 FFN2", EVAL_ROWS, D, F, 0),
    ("B2a f1 = h2 W1", TRAIN_ROWS, F, D, 0),
    ("B2a dg = dy W2^T", TRAIN_ROWS, F, D, 1),
    ("B2a dh2 = df1 W1^T", TRAIN_ROWS, D, F, 1),
    ("B2a dW1 = h2^T df1", D, F, TRAIN_ROWS, 2),
    ("B2a dW2 = g^T dy", F, D, TRAIN_ROWS, 2),
    ("B2b datt = dx1 Wout^T", TRAIN_ROWS, D, D, 1),
    ("B2b dh1 = dqkv Wqkv^T", TRAIN_ROWS, D, 3 * D, 1),
    ("B2b dWqkv = h1^T dqkv", D, 3 * D, TRAIN_ROWS, 2),
    ("B2b dWout = att^T dx1", D, D, TRAIN_ROWS, 2),
    # 12,216 rows (509 pairs x 24): a partial 128-row tile, a partial split
    ("qkv at 12,216 rows", 12216, 3 * D, D, 0),
    ("dh1 at 12,216 rows", 12216, D, 3 * D, 1),
    ("dW1 at 12,216 rows", D, F, 12216, 2),
)


def phase_gemm_core(gen):
    """The GEMM core (``csrc/gemm_sm90.cuh``) alone against ``torch.matmul``
    in f32 on the same bf16 operands, at every product shape of the main
    path; its time and TFLOP/s beside ``torch.matmul`` in bf16 (a yardstick
    only, never on the port's path).  Also holds the Python mirror of the
    split count to the C code's."""
    from veto_tpu_torch.ops import fused_encoder as fe

    print("[gemm core] wgmma + TMA core vs torch.matmul (f32), each product "
          "in the operand majors the encoder uses")
    lib = fe._bwd_lib()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for name, m, n, k, mode in GEMM_SHAPES:
        a = torch.randn(*((k, m) if mode == 2 else (m, k)), generator=gen,
                        device=DEVICE).bfloat16()
        b = torch.randn(*((n, k) if mode == 1 else (k, n)), generator=gen,
                        device=DEVICE).bfloat16()
        with torch.inference_mode():
            got = fe.gemm_product(a, b, mode)
            af, bf = a.float(), b.float()
            ref = af.t() @ bf if mode == 2 else af @ (bf.t() if mode == 1 else bf)
            del af, bf
            # modes 0, 1: exact bf16 products summed in f32 in another order
            # (~1e-6 of the scale); mode 2 rounds each sum once to bf16, at
            # most 2^-8 of the largest value
            tol = (dict(max_tol=5e-3, mean_tol=1e-3) if mode == 2
                   else dict(max_tol=1e-4, mean_tol=1e-5))
            err = check_scaled(f"{name} {m}x{n}x{k}", got, ref, **tol)
            del got, ref
            lib_fn = {0: lambda: torch.matmul(a, b), 1: lambda: torch.matmul(a, b.t()),
                      2: lambda: torch.matmul(a.t(), b)}[mode]
            ms = cuda_ms(lambda: fe.gemm_product(a, b, mode), 10)
            lib_ms = cuda_ms(lib_fn, 10)
        flops = 2 * m * n * k
        extra = ""
        if mode == 2:
            c_splits = lib.encoder_splitk_count(m, n, k)
            if c_splits != fe.splitk_count(m, n, k, sms):
                raise AssertionError(f"{name}: split count {c_splits} in C, "
                                     f"{fe.splitk_count(m, n, k, sms)} in Python")
            extra = f", {c_splits} splits"
        print(f"    {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s{extra}), torch.matmul "
              f"bf16 {lib_ms:.3f} ms ({flops / lib_ms / 1e9:.1f}); bound "
              f"{flops / PEAK_BF16 * 1e3:.3f} ms")
        rows[name] = dict(ms=ms, lib_ms=lib_ms, tflops=flops / ms / 1e9, err=err)
        del a, b
    release()
    return rows


# ------------------------------------------------------------------ phase 3
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


def corpus_rois(b):
    """The train split's first ``b`` images' boxes as the main path pools
    them: 4 to 80 an image, padded with zero boxes to 80."""
    from veto_tpu_torch.tools.profile_roi_align import corpus_rois as boxes

    return boxes(torch, b, True, os.path.join(ROOT, "configs", "veto_vg_predcls.yaml"))


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
    # both take f32 weights and f32 sums of the same taps; only the order of
    # the 16 products differs
    for (fs, sc, p_), what in zip(((feats, SCALES, p), ([depth], (0.0625,), p),
                                   (feats, SCALES, 7)),
                                  ("P2-P5 bf16", "depth 1/16 bf16",
                                   "P2-P5 bf16, P = 7 (SGCls box head)")):
        got = rw.multilevel_roi_align_batched(fs, rois, sc, p_, 2)
        ref = rw.reference_multilevel_roi_align_batched(fs, rois, sc, p_, 2)
        errs.append(check_close(what, got, ref, atol=1e-5, rtol=1e-5))
    f32 = [f[:2].float() for f in feats]
    got = rw.multilevel_roi_align_batched(f32, rois[:2], SCALES, p, 2)
    ref = rw.reference_multilevel_roi_align_batched(f32, rois[:2], SCALES, p, 2)
    errs.append(check_close("P2-P5 f32", got, ref, atol=1e-5, rtol=1e-5))
    del got, ref, f32

    def kernel():
        for fs, sc in calls:
            rw.multilevel_roi_align_batched(fs, rois, sc, p, 2)

    def plain():
        for fs, sc in calls:
            rw.reference_multilevel_roi_align_batched(fs, rois, sc, p, 2)

    per_call = [device_ms(lambda fs=fs, sc=sc: rw.multilevel_roi_align_batched(
        fs, rois, sc, p, 2), "roi_align_fwd_kernel", 20) for fs, sc in calls]
    ms = sum(per_call)
    wrapper_ms, plain_ms = cuda_ms(kernel, 50), cuda_ms(plain, 3)
    out_bytes = 2 * b * rois.shape[1] * p * p * c * 4
    in_bytes = (roi_tap_bytes(feats, rois, rw.fpn_level_assignment(rois), SCALES)
                + roi_tap_bytes([depth], rois, torch.zeros_like(rois[..., 0]), (0.0625,))
                + 2 * rois.numel() * 4)
    flops = 2 * b * rois.shape[1] * p * p * c * 16 * 2  # 16 FMAs per output
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32 * 1e3
    print(f"  per batch (P2-P5 + depth): kernel {ms:.4f} ms on the device "
          f"({per_call[0]:.4f} + {per_call[1]:.4f}), "
          f"{(in_bytes + out_bytes) / ms / 1e6:.0f} GB/s of "
          f"{PEAK_BYTES / 1e9:.0f}; the wrappers by CUDA events {wrapper_ms:.4f} "
          f"ms [the design before: 0.332], plain {plain_ms:.3f} ms; "
          f"moves {in_bytes / 1e6:.1f} MB of taps and rois + "
          f"{out_bytes / 1e6:.1f} MB out -> bound {max(t_bytes, t_ops):.4f} ms")
    return dict(name="multilevel_roi_align", route="cuda",
                source="veto_tpu_torch/csrc/roi_align.cu",
                replaces="veto_tpu/ops/roi_align_windowed.py:175",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


# ------------------------------------------------------------------ phase 4
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


# ------------------------------------------------------------------ phase 5
def phase_main_path(opts=(), n_batches=3, encoder="fused_encoder_layer"):
    """The eval entry point's ``evaluate`` over ``n_batches`` full-width
    batches; per batch exactly ``layers`` launches of the ``encoder``
    kernel, 2 of ROIAlign and none of any other kernel."""
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.models.sgg import build_model
    from veto_tpu_torch.tools.relation_test_net import (
        evaluate, synthetic_eval_dataset,
    )

    cfg = load_config(os.path.join(ROOT, "configs", "veto_vg_predcls.yaml"),
                      list(opts))
    model = build_model(cfg)  # cuda, seeded weights, eval mode
    layers = cfg.veto.enc_layers
    print(f"[main{' ' + ' '.join(opts) if opts else ''}] VETO PredCls, "
          f"{cfg.model.backbone} "
          f"{cfg.model.resnet_groups}x{cfg.model.resnet_width_per_group}d "
          f"blocks {tuple(cfg.model.stage_blocks)}, trunk {cfg.veto.t_input_dim} "
          f"x {layers} layers ({cfg.veto.encoder_impl}), {cfg.dtype}; "
          f"{n_batches} batches of {cfg.test.ims_per_batch}, "
          f"{cfg.data.max_boxes} boxes, {cfg.relation.max_proposal_pairs} pairs")
    want = expected(**{encoder: layers * n_batches,
                       "multilevel_roi_align": 2 * n_batches})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read_counters(reset=True)
    agg, seconds = evaluate(cfg, model=model, max_batches=n_batches,
                            log=lambda s: print("  " + s))
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    print(f"  launches {json.dumps(launches)}; after warm-up "
          f"{1e3 * float(np.mean(seconds[1:])):.1f} ms per batch "
          f"({[round(1e3 * s, 1) for s in seconds]}); peak memory "
          f"{peak / 2 ** 30:.2f} GiB")
    if len(seconds) != n_batches:
        raise AssertionError(f"{len(seconds)} batches ran, not {n_batches}")
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    for m in ("R", "mR"):
        if not all(np.isfinite(v) and 0 <= v <= 100 for v in agg[m].values()):
            raise AssertionError(f"{m}@K out of range: {agg[m]}")

    # one batch through the kernels and through the plain versions
    bsz = cfg.test.ims_per_batch
    batch, _ = next(synthetic_eval_dataset(cfg, bsz).batches(bsz, cfg.data.max_boxes))
    check_eval_batch(model, cfg, batch.to(DEVICE))


@contextlib.contextmanager
def f32_frozen_bn():
    """Every FrozenBatchNorm applies its scale and bias in f32 and rounds
    its output to the input's dtype once (a reading of the bf16 rounding of
    the unfolded layout, not a layout of the port)."""
    from veto_tpu_torch.models.backbone.resnet import FrozenBatchNorm

    plain = FrozenBatchNorm.forward

    def forward(self, x):
        return (x.float() * self.weight.float()[:, None, None]
                + self.bias.float()[:, None, None]).to(x.dtype)

    FrozenBatchNorm.forward = forward
    try:
        yield
    finally:
        FrozenBatchNorm.forward = plain


def eval_logits(model, cfg, b):
    """One eval batch's ``rel_logits``, the model in eval mode."""
    from veto_tpu_torch.models.relation.sampling import prepare_test_pairs

    model.eval()
    with torch.inference_mode():
        pair_idx, pair_mask = prepare_test_pairs(
            b.box_mask, b.box_mask.float(), cfg.relation.max_proposal_pairs)
        return model(b.images, b.depth, b.boxes, b.box_mask, b.labels,
                     b.obj_logits, pair_idx, pair_mask).rel_logits


def check_eval_batch(model, cfg, b, what="rel_logits kernels vs plain"):
    """One eval batch's ``rel_logits`` through the kernels against the same
    model through the plain versions; returns the kernels' logits."""
    from veto_tpu_torch.ops import cuda_lib

    bsz = b.images.shape[0]
    got = eval_logits(model, cfg, b)
    with cuda_lib.plain_kernels():
        ref = eval_logits(model, cfg, b)
    want = (bsz, cfg.relation.max_proposal_pairs, cfg.relation.num_classes)
    if tuple(got.shape) != want or got.dtype != torch.float32:
        raise AssertionError(f"rel_logits {tuple(got.shape)} {got.dtype}, want {want}")
    # bf16 through six layers: a rounding flip anywhere moves the logits by
    # about a bf16 ulp of their scale; hold max and mean to that scale
    scale = float(ref.abs().max())
    check_close(what, got, ref, atol=0.05 * scale, rtol=0.0,
                mean_tol=0.01 * float(ref.abs().mean()))
    return got


# ------------------------------------------------------------------ phase 6
def size(*ts) -> int:
    """Bytes of the tensors ``ts``."""
    return sum(t.numel() * t.element_size() for t in ts)


def check_scaled(name, got, ref, max_tol, mean_tol) -> float:
    """check_close with both tolerances relative to max |ref|; returns the
    max abs error over that scale."""
    scale = max(float(ref.float().abs().max()), 1e-30)
    return check_close(f"{name} (scale {scale:.3e})", got, ref,
                       atol=max_tol * scale, rtol=0.0,
                       mean_tol=mean_tol * scale) / scale


def enc_bwd_kernels(x, dy, params, heads, t_pad, t_valid):
    """B1 with the stash, then B2a and B2b: every output of both passes."""
    from veto_tpu_torch.ops import fused_encoder as fe

    _, qkv, x1 = fe._launch(x, params, heads, t_pad, t_valid, stash=True)
    dx1, dx1b, dw1, dw2, vec4, db1 = fe._launch_ffn_bwd(x1, dy, params)
    dx, dwqkv, dwout, vec2 = fe._launch_att_bwd(x, qkv, dx1, dx1b, params,
                                                heads, t_pad, t_valid)
    return dict(dx1=dx1, dw1=dw1, dw2=dw2, vec4=vec4, db1=db1, dx=dx,
                dwqkv=dwqkv, dwout=dwout, vec2=vec2), (qkv, x1)


def sass_count(lib_name, kernel, opcode) -> int:
    """Instructions ``opcode`` in the SASS of the functions of library
    ``lib_name`` whose name holds ``kernel`` (``cuobjdump -sass``)."""
    from veto_tpu_torch.ops import cuda_lib

    tool = os.path.join(os.path.dirname(cuda_lib.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(cuda_lib._lib_path(lib_name))],
                          capture_output=True, text=True, check=True).stdout
    n, inside = 0, False
    for line in sass.splitlines():
        if "Function : " in line:
            inside = kernel in line
        elif inside and opcode in line:
            n += 1
    return n


def sdpa_call(gen, pairs, t, d, heads, backward):
    """A call of SDPA with the key mask on the strided (P, heads, T, dh) views
    of a packed qkv, as the pair-attention path lays them out: the forward,
    or its backward to dq, dk, dv (``torch.autograd.grad``, so nothing
    accumulates into a leaf).  A yardstick only; the port never calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = (torch.arange(t, device=DEVICE) < t).expand(t, t)
    qkv = torch.randn(pairs, t, 3 * d, generator=gen, device=DEVICE).bfloat16()
    do = torch.randn(pairs, t, d, generator=gen, device=DEVICE).bfloat16()

    def heads_of(a):
        return a.unflatten(-1, (heads, d // heads)).transpose(1, 2)

    if not backward:
        q4, k4, v4 = (heads_of(a) for a in qkv.chunk(3, dim=-1))
        return lambda: sdpa(q4, k4, v4, attn_mask=mask)
    # outside inference mode: the graph of one forward, its backward timed
    q4, k4, v4 = (heads_of(a) for a in qkv.requires_grad_().chunk(3, dim=-1))
    o4 = sdpa(q4, k4, v4, attn_mask=mask)
    do4 = heads_of(do)
    return lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)


def sdpa_ms(gen, pairs, t, d, heads, backward) -> float:
    """ms per call of :func:`sdpa_call`'s call by CUDA events."""
    return cuda_ms(sdpa_call(gen, pairs, t, d, heads, backward), 20)


def phase_attention_alone(gen, pairs=12288, d=576, heads=6, t=19):
    """The attention backward kernel of B2b and B5 alone
    (``fused_encoder._launch_attention_bwd``) against the plain
    ``_attention_bwd`` (att, dq, dk, dv) and, without datt, ``_attention``,
    at the train shape and at 509 pairs with t_pad 24 > t_valid 19; two runs
    bit-equal; its time against its bound and SDPA's backward; the
    tensor-core instructions in its SASS; the Python mirror of its shared
    memory against the C code's.  Returns its ms and bound ms."""
    from veto_tpu_torch.ops import fused_encoder as fe

    print(f"[attention alone] B2b's attention backward vs plain, {pairs} pairs "
          f"x {t} tokens x {d}, {heads} heads")
    lib = fe._bwd_lib()
    tol = dict(max_tol=1e-2, mean_tol=1e-3)  # phase 6's, for the same reason
    with torch.inference_mode():
        for n_pairs, t_pad in ((pairs, t), (min(pairs, 509), 24)):
            smem = lib.encoder_attention_bwd_smem_bytes(t_pad, d)
            if smem != fe.attention_bwd_smem_bytes(t_pad, d):
                raise AssertionError(f"shared memory {smem} in C, "
                                     f"{fe.attention_bwd_smem_bytes(t_pad, d)} in Python")
            qkv = torch.randn(n_pairs * t_pad, 3 * d, generator=gen,
                              device=DEVICE).bfloat16()
            datt = torch.randn(n_pairs * t_pad, d, generator=gen,
                               device=DEVICE).bfloat16()
            runs = [fe._launch_attention_bwd(qkv, datt, heads, t_pad, t)
                    for _ in range(2)]
            fwd = [fe._launch_attention_bwd(qkv, None, heads, t_pad, t)[0]
                   for _ in range(2)]
            if not (all(torch.equal(a, b) for a, b in zip(*runs))
                    and torch.equal(*fwd) and runs[0][1] is not None):
                raise AssertionError(f"t_pad {t_pad}: two kernel runs differ")
            print(f"  {n_pairs} pairs, t_pad {t_pad}, t_valid {t}, {smem} B of "
                  "shared memory a block (two kernel runs bit-equal)")
            (att, dqkv), ref = runs[0], fe._attention_bwd(qkv, datt, heads, t_pad, t,
                                                          torch.bfloat16)
            check_scaled("att", att, ref[0], **tol)
            for i, name in enumerate(("dq", "dk", "dv")):
                cols = slice(i * d, (i + 1) * d)
                check_scaled(name, dqkv[:, cols], ref[1][:, cols], **tol)
            check_scaled("att without datt (forward)", fwd[0],
                         fe._attention(qkv, heads, t_pad, t, torch.bfloat16), **tol)
        del runs, fwd, att, dqkv, ref
        qkv = torch.randn(pairs * t, 3 * d, generator=gen, device=DEVICE).bfloat16()
        datt = torch.randn(pairs * t, d, generator=gen, device=DEVICE).bfloat16()
        ms = cuda_ms(lambda: fe._launch_attention_bwd(qkv, datt, heads, t, t), 20)
        fwd_ms = cuda_ms(lambda: fe._launch_attention_bwd(qkv, None, heads, t, t), 20)
        plain_ms = cuda_ms(lambda: fe._attention_bwd(qkv, datt, heads, t, t,
                                                     torch.bfloat16), 3)
    lib_ms = sdpa_ms(gen, pairs, t, d, heads, backward=True)
    rows = pairs * t
    # in: qkv, datt; out: att, dqkv
    nbytes = rows * (3 * d + d + d + 3 * d) * 2
    flops = 12 * pairs * heads * t * t * (d // heads)
    bound = max(nbytes / PEAK_BYTES, flops / PEAK_BF16) * 1e3
    hmma = sass_count("encoder_layer_bwd", "attention_bwd_mma_kernel", "HMMA")
    print(f"  kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s), forward only "
          f"{fwd_ms:.4f} ms, plain {plain_ms:.3f} ms, SDPA backward with the key "
          f"mask {lib_ms:.3f} ms (which writes no att); {nbytes / 1e9:.3f} GB, "
          f"{flops / 1e12:.4f} TFLOP -> bound {bound:.4f} ms (bytes); "
          f"{hmma} HMMA instructions in its SASS")
    if hmma == 0:
        raise AssertionError("attention_bwd_mma_kernel has no HMMA in its SASS")
    release()
    return dict(ms=ms, bound_ms=bound)


def ln_bwd_bound_ms(rows, d, bytes_per_element) -> float:
    return rows * d * bytes_per_element / PEAK_BYTES * 1e3


def phase_encoder_bwd(gen, pairs=12288, d=576):
    """B2a (FFN backward) and B2b (attention backward) against their plain
    versions on the same inputs, at the PredCls train shape; their pieces'
    device times by ``torch.profiler``."""
    from veto_tpu_torch.ops import fused_encoder as fe
    from veto_tpu_torch.tools.profile_eval import trace

    t, heads = 19, 6
    attention = phase_attention_alone(gen, pairs, d, heads, t)
    print(f"[encoder bwd] kernels vs plain, {pairs} pairs x {t} tokens x {d}")
    params = enc_params(gen, d)
    f = params.w1.shape[1]
    # Both sides round the same intermediates to bf16 (dy, df1, bf16(dx1),
    # datt, the probabilities, ds, dqkv).  An f32 sum in another order can
    # flip one rounding, which moves that value by one bf16 ulp (2^-8 of
    # itself); the matrix grads and dx are rounded to bf16 once more (2^-9).
    # So each grad is held to 1% of its largest |value| everywhere and to
    # 0.1% of it on average; a wrong index or operand would miss both by
    # orders of magnitude.
    tol = dict(max_tol=1e-2, mean_tol=1e-3)
    pass_a = ("dx1", "dw1", "dw2", "vec4", "db1")
    errs = {"a": 0.0, "b": 0.0}  # max abs error of each pass's outputs
    with torch.inference_mode():
        for n_pairs, t_pad in ((pairs, t), (min(pairs, 509), 24)):
            # 509 pairs x 24 rows: 12,216 rows, a partial 128-row GEMM tile
            # and a partial last split of the weight-gradient sums
            x = torch.randn(n_pairs * t_pad, d, generator=gen, device=DEVICE).bfloat16()
            dy = torch.randn(n_pairs * t_pad, d, generator=gen,
                             device=DEVICE).bfloat16()
            got, (qkv, x1) = enc_bwd_kernels(x, dy, params, heads, t_pad, t)
            again, _ = enc_bwd_kernels(x, dy, params, heads, t_pad, t)
            for k in got:  # split-K sums and column sums in a fixed order
                if not torch.equal(got[k], again[k]):
                    raise AssertionError(f"{k}: two kernel runs differ")
            dx1, dw1, dw2, vec4, db1 = fe.reference_ffn_bwd(x1, dy, params)
            dx, dwqkv, dwout, vec2 = fe.reference_att_bwd(
                x, qkv, got["dx1"], params, heads, t_pad, t)
            ref = dict(dx1=dx1, dw1=dw1, dw2=dw2, vec4=vec4, db1=db1, dx=dx,
                       dwqkv=dwqkv, dwout=dwout, vec2=vec2)
            print(f"  t_pad={t_pad}, t_valid={t}, {n_pairs} pairs "
                  "(two kernel runs bit-equal)")
            for k in got:
                # one scale per grad: each row of the stacked vector grads
                # is a parameter's own
                parts = ([(f"{k}[{i}]", got[k][i], ref[k][i])
                          for i in range(ref[k].shape[0])]
                         if k.startswith("vec") else [(k, got[k], ref[k])])
                which = "a" if k in pass_a else "b"
                for name, g_, r_ in parts:
                    check_scaled(name, g_, r_, **tol)
                    errs[which] = max(errs[which],
                                      float((g_.float() - r_.float()).abs().max()))
        x = torch.randn(pairs * t, d, generator=gen, device=DEVICE).bfloat16()
        dy = torch.randn(pairs * t, d, generator=gen, device=DEVICE).bfloat16()
        _, qkv, x1 = fe._launch(x, params, heads, t, t, stash=True)
        dx1, dx1b, *_ = fe._launch_ffn_bwd(x1, dy, params)
        ms_a = cuda_ms(lambda: fe._launch_ffn_bwd(x1, dy, params), 10)
        ms_b = cuda_ms(lambda: fe._launch_att_bwd(x, qkv, dx1, dx1b, params,
                                                  heads, t, t), 10)
        plain_a = cuda_ms(lambda: fe.reference_ffn_bwd(x1, dy, params), 2, 1)
        plain_b = cuda_ms(lambda: fe.reference_att_bwd(x, qkv, dx1, params,
                                                       heads, t, t), 2, 1)
        # the pieces of each pass: device time by kernel under
        # torch.profiler over 5 calls, per call
        calls = 5
        own = ("attention_bwd_mma_kernel", "ln_backward_kernel<2",
               "ln_backward_kernel<4", "gemm_sm90_kernel", "layernorm_kernel",
               "splitk_reduce_kernel", "colsum_reduce_kernel")
        pieces = {}
        for name, fn in (("B2a", lambda: fe._launch_ffn_bwd(x1, dy, params)),
                         ("B2b", lambda: fe._launch_att_bwd(
                             x, qkv, dx1, dx1b, params, heads, t, t))):
            got = trace(lambda: [fn() for _ in range(calls)], own,
                        log=lambda s: None)["own_kernel_ms"]
            pieces[name] = {k: v / calls for k, v in got.items() if v}
            print(f"  {name} per call by kernel (torch.profiler): " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in pieces[name].items()))
    rows = pairs * t
    # LN1 backward: x (bf16), dh1, dx1 (f32) in, dx (bf16) out; LN2
    # backward: x1, dy (bf16), dh2 (f32) in, dx1 (f32 and bf16) out
    ln1_bound, ln2_bound = ln_bwd_bound_ms(rows, d, 12), ln_bwd_bound_ms(rows, d, 14)
    print(f"  B2b's attention backward {attention['ms']:.4f} ms (bound "
          f"{attention['bound_ms']:.4f}), LN1 backward "
          f"{pieces['B2b']['ln_backward_kernel<2']:.4f} ms (bound {ln1_bound:.4f}); "
          f"B2a's LN2 backward {pieces['B2a']['ln_backward_kernel<4']:.4f} ms "
          f"(bound {ln2_bound:.4f})")
    # yardstick: autograd through torch's own layer, one sub-block at a time
    layer = library_layer(params, heads)
    # clones: tensors made under inference_mode cannot enter autograd
    x3 = x.view(pairs, t, d).clone().requires_grad_()
    x13 = x1.view(pairs, t, d).clone().requires_grad_()
    dy3 = dy.view(pairs, t, d).clone()
    ffn = x13 + layer._ff_block(layer.norm2(x13))
    att = x3 + layer._sa_block(layer.norm1(x3), None, None)
    lib_a = cuda_ms(lambda: ffn.backward(dy3, retain_graph=True), 5)
    lib_b = cuda_ms(lambda: att.backward(dy3, retain_graph=True), 5)
    del ffn, att, layer

    p = params
    # f1 recompute, dg, dh2, dW1, dW2: five products of 2 R D F
    flops_a = 5 * 2 * rows * d * f
    # in: x1, dy, W1, W2, LN2 scale/bias, b1;
    # out: dx1 (f32 and bf16), dW1, dW2 (bf16), (4, D), d b1
    bytes_a = (rows * d * (2 + 2 + 4 + 2) + 2 * size(p.w1, p.w2)
               + size(p.ln2_scale, p.ln2_bias, p.b1) + 4 * (4 * d + f))
    # datt, dh1, dWqkv, dWout; attention: scores, att, dp, dv, dq, dk
    att_flops = 12 * pairs * heads * t * t * (d // heads)
    flops_b = 2 * rows * d * d * (1 + 3 + 3 + 1) + att_flops
    # in: x, qkv, dx1 (f32 and bf16), Wqkv, Wout, LN1 scale/bias;
    # out: dx, dWqkv, dWout (bf16), (2, D)
    bytes_b = (rows * d * (2 + 6 + 4 + 2 + 2) + 2 * size(p.w_qkv, p.w_out)
               + size(p.ln1_scale, p.ln1_bias) + 4 * 2 * d)
    out = []
    for name, src_line, err, ms, plain_ms, lib_ms, flops, nbytes in (
            ("encoder_ffn_bwd", 678, errs["a"], ms_a, plain_a, lib_a, flops_a,
             bytes_a),
            ("encoder_att_bwd", 708, errs["b"], ms_b, plain_b, lib_b, flops_b,
             bytes_b)):
        t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
        print(f"  {name}: kernel {ms:.3f} ms/layer ({flops / ms / 1e9:.1f} "
              f"TFLOP/s), plain {plain_ms:.3f} ms, torch TransformerEncoderLayer "
              f"sub-block backward {lib_ms:.3f} ms; {flops / 1e12:.3f} TFLOP, "
              f"{nbytes / 1e9:.3f} GB -> bound {max(t_ops, t_bytes):.3f} ms")
        out.append(dict(name=name, route="cuda",
                        source="veto_tpu_torch/csrc/encoder_layer_bwd.cu",
                        replaces=f"veto_tpu/ops/fused_encoder.py:{src_line}",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=max(t_ops, t_bytes),
                        bound_by="operations" if t_ops >= t_bytes else "bytes",
                        library_ms=lib_ms))
    return out


# ------------------------------------------------------------------ phase 7
def phase_roi_align_bwd(gen, b=12, h=800, w=1344, c=256):
    """B3-bwd against autograd of the plain pooling: the depth map's
    gradient at the PredCls train shape, and every FPN level's at P = 7 with
    512 rois an image (detector pretraining's shape); two kernel runs
    bit-equal in both; the C tile plan against its Python mirror."""
    from veto_tpu_torch.ops import cuda_lib
    from veto_tpu_torch.ops import roi_align_windowed as rw

    lib = cuda_lib.library("roi_align")
    for ch, dt in ((c, torch.bfloat16), (c, torch.float32)):
        c_rows = lib.roi_align_bwd_tile_rows(ch, int(dt == torch.bfloat16))
        if c_rows != rw.bwd_tile_rows(ch, dt):
            raise AssertionError(f"backward tile rows {c_rows} in C, "
                                 f"{rw.bwd_tile_rows(ch, dt)} in Python ({ch}, {dt})")
    p, s, scale = 8, 2, 0.0625
    print(f"[roi_align bwd] kernel vs plain, {b} x {h // 16}x{w // 16}x{c} "
          f"depth map, 80 rois an image; tiles {rw.BWD_TILE_W} x "
          f"{rw.bwd_tile_rows(c, torch.bfloat16)} pixels (C and Python agree)")
    depth = torch.randn(b, h // 16, w // 16, c, generator=gen,
                        device=DEVICE).bfloat16()
    dense = eval_rois(gen, b, 80, h, w)
    g = torch.randn(b, 80, p, p, c, generator=gen, device=DEVICE)
    # the rois as chip_smoke draws them (edge cases, few zero boxes), and the
    # train split's first batch as the main path pools it: 4 to 80 boxes an
    # image padded with zero boxes, which all reach the map's corner
    cases = (("edge and dense rois", dense), ("the train split's boxes", corpus_rois(b)))
    err, ms = 0.0, {}
    for what, rois in cases:
        def kernel(rois=rois):
            return rw._launch_backward([depth], [True], rois, g, (scale,), p, s)[0]

        def plain(rois=rois):
            return rw.reference_multilevel_roi_align_backward(
                [depth], [True], rois, g, (scale,), p, s)[0]

        got, again, ref = kernel(), kernel(), plain()
        if got.dtype != depth.dtype or ref.dtype != depth.dtype:
            raise AssertionError(f"grad dtypes {got.dtype}, {ref.dtype}; map {depth.dtype}")
        if not torch.equal(got, again):
            raise AssertionError(f"depth grad, {what}: two kernel runs differ")
        # both sum the same f32 products in f32, in another order, and round
        # once to bf16: where the two f32 sums straddle a rounding boundary
        # they differ by one bf16 ulp, at most 2^-7 of the value.  Under the
        # train split's zero boxes the corner pixels sum ~17,000 terms, and
        # the two f32 sums differ by a few ulps of the sum of |terms| times
        # the root of their count: 2^-16 of that sum (the gradient of |g|)
        atol = 1e-5
        if rois is not dense:
            mag = rw.reference_multilevel_roi_align_backward(
                [depth.float()], [True], rois, g.abs(), (scale,), p, s)[0]
            atol = 1e-5 + 2.0 ** -16 * mag
            del mag
        err = max(err, check_close(f"depth grad bf16, {what} (two kernel runs "
                                   "bit-equal)", got, ref, atol=atol, rtol=2 ** -7))
        del got, again, ref
        ms[what] = device_ms(kernel, "roi_align_bwd_kernel", 20)
    # the main path's boxes
    wrapper_ms, plain_ms = cuda_ms(kernel, 50), cuda_ms(plain, 3)
    # in: the f32 gradient and the rois; out: the bf16 map gradient
    nbytes = g.numel() * 4 + rois.numel() * 4 + depth.numel() * 2
    flops = g.numel() * 4 * 4 * 2  # 4 samples x 4 taps, one FMA each
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    for what, t in ms.items():
        print(f"  {what}: kernel {t:.4f} ms on the device, {nbytes / t / 1e6:.0f} GB/s of "
              f"{PEAK_BYTES / 1e9:.0f}")
    print(f"  the train split's boxes: the wrapper by CUDA events {wrapper_ms:.4f} ms "
          f"[the atomic design before: 0.650 on the dense rois], plain {plain_ms:.3f} ms; "
          f"{nbytes / 1e6:.1f} MB -> bound {max(t_bytes, t_ops):.4f} ms")
    ms = ms[cases[-1][0]]
    del depth, g
    err = max(err, roi_align_bwd_levels(gen))
    release()
    return dict(name="roi_align_backward", route="cuda",
                source="veto_tpu_torch/csrc/roi_align.cu",
                replaces="veto_tpu/ops/roi_align.py:175",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def roi_align_bwd_levels(gen, b=2, r=512, h=800, w=1344, c=256, p=7, s=2):
    """B3-bwd over P2-P5, every level needing its gradient, at P = 7 and
    ``r`` rois an image: against the plain backward, two runs bit-equal.
    Returns the max abs error."""
    from veto_tpu_torch.ops import roi_align_windowed as rw

    print(f"  P2-P5 of {b} x {h}x{w} images, {r} rois an image, P = {p}, every "
          "level's gradient")
    feats = [torch.randn(b, h // k, w // k, c, generator=gen, device=DEVICE)
             .bfloat16() for k in (4, 8, 16, 32)]
    rois = eval_rois(gen, b, r, h, w)
    g = torch.randn(b, r, p, p, c, generator=gen, device=DEVICE)
    need = [True] * len(feats)

    def kernel():
        return rw._launch_backward(feats, need, rois, g, SCALES, p, s)

    got, again = kernel(), kernel()
    ref = rw.reference_multilevel_roi_align_backward(feats, need, rois, g,
                                                     SCALES, p, s)
    err = 0.0
    for lvl, (a, a2, r_) in enumerate(zip(got, again, ref)):
        if not torch.equal(a, a2):
            raise AssertionError(f"P{lvl + 2} grad: two kernel runs differ")
        err = max(err, check_close(f"P{lvl + 2} grad bf16 (two kernel runs "
                                   "bit-equal)", a, r_, atol=1e-5, rtol=2 ** -7))
    del got, again, ref
    ms = device_ms(kernel, "roi_align_bwd_kernel", 10)
    nbytes = g.numel() * 4 + rois.numel() * 4 + sum(f.numel() * 2 for f in feats)
    print(f"  kernel {ms:.4f} ms on the device, {nbytes / ms / 1e6:.0f} GB/s; "
          f"{nbytes / 1e6:.1f} MB -> bound {nbytes / PEAK_BYTES * 1e3:.4f} ms")
    return err


# ------------------------------------------------------------------ phase 8
def busy_ms(fn, calls: int) -> float:
    """Device milliseconds per call of ``fn``: every kernel it launches, by
    ``torch.profiler`` over ``calls`` calls after one warm-up call."""
    from veto_tpu_torch.tools.profile_eval import trace

    fn()
    got = trace(lambda: [fn() for _ in range(calls)], (), log=lambda s: None)
    return got["device_busy_ms"] / calls


# (T, D, heads) at which the C route rule is held against its Python mirror:
# the main path's pairs, padded tokens, ATT_TMAX and one past it,
# veto.patch_size 1's 67 tokens, a head dim of 12, and rows past ATT_SMEM_MAX
ROUTE_SHAPES = ((19, 576, 6), (24, 576, 6), (32, 576, 6), (33, 576, 6),
                (67, 576, 6), (19, 72, 6), (32, 1024, 8))


def phase_pair_attention(gen, d=576, heads=6):
    """B4a and B4b against their plain versions, q/k/v the thirds of one
    packed qkv as ``_xla_layer`` passes them.  The tensor-core route (the
    attention of ``csrc/pair_attention_sm90.cuh``) at the eval (16,384
    pairs) and train (12,288) shapes and at 509 pairs with t_pad 24 >
    t_valid 19; the CUDA-core route at 509 pairs x 67 tokens (veto.patch_size
    1); two runs bit-equal each; the route rule and shared memory in C
    against their Python mirrors; HMMA in the tensor-core kernel's SASS.
    Then, by ``torch.profiler`` device time on the same inputs, the
    tensor-core route, the CUDA-core route called directly, and SDPA with
    the key mask, each against the bound."""
    from veto_tpu_torch.ops import cuda_lib
    from veto_tpu_torch.ops import fused_encoder as fe
    from veto_tpu_torch.ops import pair_attention as pa

    t, dh = 19, d // heads
    print(f"[pair attention] B4a/B4b vs plain, q/k/v thirds of a packed qkv, "
          f"x {t} tokens x {d}, {heads} heads")
    lib = cuda_lib.library("pair_attention")
    lib.pair_attention_route.argtypes = [ctypes.c_int] * 3
    lib.pair_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.pair_attention_cuda_core_smem_bytes.argtypes = [ctypes.c_int] * 3
    for shape in ROUTE_SHAPES:
        c_route = "tensor_cores" if lib.pair_attention_route(*shape) else "cuda_cores"
        if c_route != pa.kernel_route(*shape):
            raise AssertionError(f"T, D, heads {shape}: route {c_route} in C, "
                                 f"{pa.kernel_route(*shape)} in Python")
    for c_smem, py_smem in (
            (lib.pair_attention_smem_bytes(t, d), fe.attention_bwd_smem_bytes(t, d)),
            (lib.pair_attention_cuda_core_smem_bytes(67, dh, 1),
             pa.cuda_core_smem_bytes(67, dh, True))):
        if c_smem != py_smem:
            raise AssertionError(f"shared memory {c_smem} in C, {py_smem} in Python")
    print(f"  route rule and shared memory: C and Python agree at "
          f"{len(ROUTE_SHAPES)} shapes")
    # same rounding points (bf16 probabilities, bf16(ds * scale), each
    # output once); an f32 sum in another order can flip one bf16 rounding,
    # one ulp (2^-8) of that value: 1% of the largest |value| everywhere,
    # 0.1% on average, as phase 6 holds the encoder backward
    tol = dict(max_tol=1e-2, mean_tol=1e-3)
    errs = {"fwd": 0.0, "bwd": 0.0}

    def inputs(pairs, t_pad):
        qkv = torch.randn(pairs, t_pad, 3 * d, generator=gen, device=DEVICE).bfloat16()
        do = torch.randn(pairs, t_pad, d, generator=gen, device=DEVICE).bfloat16()
        return qkv.chunk(3, dim=-1), do

    def fwd(q, k, v, t_valid, route=None):
        return pa._launch_forward(q, k, v, heads, t_valid, route)

    def bwd(q, k, v, do, t_valid, route=None):
        """B4b writing dq, dk, dv packed, as ``pair_attention_qkv`` has it"""
        dqkv = torch.empty(*q.shape[:2], 3 * d, dtype=q.dtype, device=DEVICE)
        pa._launch_backward(q, k, v, do, heads, t_valid, dqkv.chunk(3, dim=-1), route)
        return dqkv.chunk(3, dim=-1)

    times = {}
    with torch.inference_mode():
        for pairs, t_pad, t_valid in ((16384, t, t), (12288, t, t), (509, 24, t),
                                      (509, 67, 67)):
            route = pa.kernel_route(t_pad, d, heads)
            if route != ("cuda_cores" if t_pad > fe.ATT_TMAX else "tensor_cores"):
                raise AssertionError(f"T={t_pad}: route {route}")
            (q, k, v), do = inputs(pairs, t_pad)
            got = [fwd(q, k, v, t_valid) for _ in range(2)]
            gotb = [bwd(q, k, v, do, t_valid) for _ in range(2)]
            if not (torch.equal(*got)
                    and all(torch.equal(a, b) for a, b in zip(*gotb))):
                raise AssertionError(f"{pairs} x {t_pad}: two kernel runs differ")
            print(f"  {pairs} pairs, t_pad {t_pad}, t_valid {t_valid}: {route} "
                  "(two kernel runs bit-equal)")
            for which, names, g_, r_ in (
                    ("fwd", ["B4a out"], got[:1],
                     [pa.reference_pair_attention_forward(q, k, v, heads, t_valid)]),
                    ("bwd", ["B4b dq", "B4b dk", "B4b dv"], gotb[0],
                     pa.reference_pair_attention_backward(q, k, v, do, heads, t_valid))):
                for name, a, b in zip(names, g_, r_):
                    check_scaled(name, a, b, **tol)
                    if route == "tensor_cores":
                        errs[which] = max(errs[which],
                                          float((a.float() - b.float()).abs().max()))
            del got, gotb
            if t_pad == t:
                times[pairs] = dict(
                    fwd=device_ms(lambda: fwd(q, k, v, t), "attention_bwd_mma_kernel", 20),
                    bwd=device_ms(lambda: bwd(q, k, v, do, t), "attention_bwd_mma_kernel",
                                  20),
                    cc_fwd=device_ms(lambda: fwd(q, k, v, t, "cuda_cores"),
                                     "pair_attn_fwd_kernel", 10),
                    cc_bwd=device_ms(lambda: bwd(q, k, v, do, t, "cuda_cores"),
                                     "pair_attn_bwd_kernel", 10),
                    plain_fwd=cuda_ms(lambda: pa.reference_pair_attention_forward(
                        q, k, v, heads, t), 3),
                    plain_bwd=cuda_ms(lambda: pa.reference_pair_attention_backward(
                        q, k, v, do, heads, t), 3))
            del q, k, v, do
        for pairs in times:
            times[pairs].update(
                lib_fwd=busy_ms(sdpa_call(gen, pairs, t, d, heads, False), 20))
    for pairs in times:
        times[pairs]["lib_bwd"] = busy_ms(sdpa_call(gen, pairs, t, d, heads, True), 20)
    hmma = sass_count("pair_attention", "attention_bwd_mma_kernel", "HMMA")
    print(f"  {hmma} HMMA instructions in the pair-attention library's "
          "attention_bwd_mma_kernel")
    if hmma == 0:
        raise AssertionError("the pair-attention library's tensor-core kernel has "
                             "no HMMA in its SASS")

    out = []
    # B4a: qkv in, att out; QK^T and PV.  B4b: qkv, do in, dqkv out; QK^T
    # again, dP, dV, dQ, dK
    for name, key, line, tensors, products, pairs in (
            ("pair_attention", "fwd", 156, 4, 2, 16384),
            ("pair_attention_backward", "bwd", 176, 7, 5, 12288)):
        for p_ in sorted(times):
            tm = times[p_]
            nbytes = tensors * p_ * t * d * 2
            t_ops = 2 * products * p_ * heads * t * t * dh / PEAK_BF16 * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            bound = max(t_ops, t_bytes)
            print(f"  {name} at {p_} pairs (device ms, torch.profiler): tensor cores "
                  f"{tm[key]:.4f} ({100 * bound / tm[key]:.0f}% of the bound, "
                  f"{nbytes / tm[key] / 1e6:.0f} GB/s), CUDA cores "
                  f"{tm['cc_' + key]:.4f} ({100 * bound / tm['cc_' + key]:.0f}%), "
                  f"SDPA with the key mask {tm['lib_' + key]:.4f} "
                  f"({100 * bound / tm['lib_' + key]:.0f}%); plain "
                  f"{tm['plain_' + key]:.3f} ms by CUDA events; {nbytes / 1e9:.3f} GB "
                  f"-> bound {bound:.4f} ms (bytes)")
            if tm[key] >= tm["cc_" + key]:
                raise AssertionError(f"{name} at {p_} pairs: the tensor-core route "
                                     "is not faster than the CUDA-core one")
            if p_ == pairs:
                row = dict(name=name, route="cuda",
                           source="veto_tpu_torch/csrc/pair_attention.cu",
                           replaces=f"veto_tpu/ops/pair_attention.py:{line}",
                           max_abs_err=errs[key], ms=tm[key],
                           plain_ms=tm["plain_" + key], bound_ms=bound,
                           bound_by="operations" if t_ops >= t_bytes else "bytes",
                           library_ms=tm["lib_" + key])
        out.append(row)
    release()
    return out


# ------------------------------------------------------------------ phase 9
MONO_OUT = ("dx", "h2", "df1", "g", "vec", "db1", "dwqkv", "dwout")


def phase_mono_bwd(gen, pairs=12288, d=576):
    """B5 against its plain version at the train shape, with and without the
    stash; two kernel runs bit-equal; B5 against B2a + B2b on the same
    input; its time beside the two external dW products'."""
    from veto_tpu_torch.ops import fused_encoder as fe

    t, heads = 19, 6
    print(f"[encoder mono bwd] B5 vs plain, {pairs} pairs x {t} tokens x {d}")
    params = enc_params(gen, d)
    f = params.w1.shape[1]
    tol = dict(max_tol=1e-2, mean_tol=1e-3)  # phase 6's, for the same reason
    err = 0.0
    with torch.inference_mode():
        x = torch.randn(pairs * t, d, generator=gen, device=DEVICE).bfloat16()
        dy = torch.randn(pairs * t, d, generator=gen, device=DEVICE).bfloat16()
        _, qkv, x1 = fe._launch(x, params, heads, t, t, stash=True)
        runs = {}
        for stash in (True, False):
            sq, sx = (qkv, x1) if stash else (None, None)
            got, again = (dict(zip(MONO_OUT, fe._launch_mono_bwd(
                x, sq, sx, dy, params, heads, t, t))) for _ in range(2))
            for k in got:  # split-K sums and column sums in a fixed order
                if not torch.equal(got[k], again[k]):
                    raise AssertionError(f"B5 {k} (stash {stash}): two kernel runs differ")
            ref = dict(zip(MONO_OUT, fe.reference_mono_bwd(
                x, sq, sx, dy, params, heads, t, t)))
            print(f"  stash {stash}: two kernel runs bit-equal")
            for k in got:
                parts = ([(f"{k}[{i}]", got[k][i], ref[k][i]) for i in range(6)]
                         if k == "vec" else [(k, got[k], ref[k])])
                for name, g_, r_ in parts:
                    check_scaled(name, g_, r_, **tol)
                    err = max(err, float((g_.float() - r_.float()).abs().max()))
            runs[stash] = got
        # not expected: without the stash B5 recomputes att with the
        # backward's tensor-core attention, whose sums run in another order
        # than B1's, so x1 and what follows may differ in a rounding
        same = all(torch.equal(runs[True][k], runs[False][k]) for k in runs[True])
        print(f"  B5 with and without the stash bit-equal: {same}")
        # B5 against the split backward on the same input
        split, _ = enc_bwd_kernels(x, dy, params, heads, t, t)
        b5 = runs[True]
        pairs_ = [("dx", b5["dx"], split["dx"]), ("db1", b5["db1"], split["db1"]),
                  ("dwqkv", b5["dwqkv"], split["dwqkv"]),
                  ("dwout", b5["dwout"], split["dwout"]),
                  ("dw1", b5["h2"].t() @ b5["df1"], split["dw1"]),
                  ("dw2", b5["g"].t() @ dy, split["dw2"])]
        vec = torch.cat([split["vec2"], split["vec4"]])
        pairs_ += [(f"vec[{i}]", b5["vec"][i], vec[i]) for i in range(6)]
        print("  B5 against B2a + B2b:")
        for name, g_, r_ in pairs_:
            check_scaled(f"B5 vs split {name}", g_, r_, **tol)
        ms = cuda_ms(lambda: fe._launch_mono_bwd(x, qkv, x1, dy, params, heads, t, t), 10)
        ms_nostash = cuda_ms(lambda: fe._launch_mono_bwd(
            x, None, None, dy, params, heads, t, t), 10)
        h2, df1, g = b5["h2"], b5["df1"], b5["g"]
        ms_dw = cuda_ms(lambda: (torch.matmul(h2.t(), df1), torch.matmul(g.t(), dy)), 10)
        plain_ms = cuda_ms(lambda: fe.reference_mono_bwd(
            x, qkv, x1, dy, params, heads, t, t), 2, 1)
    # yardstick: autograd through torch's own layer, the whole backward
    layer = library_layer(params, heads)
    x3 = x.view(pairs, t, d).clone().requires_grad_()
    y3 = layer(x3)
    lib_ms = cuda_ms(lambda: y3.backward(dy.view(pairs, t, d).clone(),
                                         retain_graph=True), 5)
    del y3, layer
    rows = pairs * t
    p = params
    # f1, dg, dh2 (2 R D F each); datt, dWout (2 R D D); dh1, dWqkv
    # (2 R D 3D); attention: scores, att, dp, dv, dq, dk
    att_flops = 12 * pairs * heads * t * t * (d // heads)
    flops = 2 * rows * (3 * d * f + 2 * d * d + 2 * 3 * d * d) + att_flops
    # without the stash also the qkv and out-projection GEMMs and the
    # attention forward (scores, att)
    flops_nostash = (flops + 2 * rows * (3 * d * d + d * d)
                     + 4 * pairs * heads * t * t * (d // heads))
    # in: x, dy, qkv, x1, the parameters; out: dx, h2 (R D), df1, g (R F),
    # the vector grads, dWqkv, dWout
    nbytes = (rows * d * 2 * (1 + 1 + 3 + 1) + size(*p)
              + rows * 2 * (2 * d + 2 * f) + 4 * (6 * d + f) + 2 * (3 * d * d + d * d))
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    t_ops_ns = flops_nostash / PEAK_BF16 * 1e3
    dw_flops = 2 * 2 * rows * d * f
    print(f"  encoder_mono_bwd: kernel {ms:.3f} ms/layer with the stash "
          f"({flops / ms / 1e9:.1f} TFLOP/s), {ms_nostash:.3f} without "
          f"({flops_nostash / ms_nostash / 1e9:.1f} TFLOP/s, bound "
          f"{t_ops_ns:.3f} ms); external dW1 + dW2 torch.matmul {ms_dw:.3f} ms "
          f"({dw_flops / 1e12:.3f} TFLOP, bound {dw_flops / PEAK_BF16 * 1e3:.3f}); "
          f"plain {plain_ms:.3f} ms, torch TransformerEncoderLayer backward "
          f"{lib_ms:.3f} ms; {flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB -> "
          f"bound {max(t_ops, t_bytes):.3f} ms")
    return dict(name="encoder_mono_bwd", route="cuda",
                source="veto_tpu_torch/csrc/encoder_layer_bwd.cu",
                replaces="veto_tpu/ops/fused_encoder.py:752",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=lib_ms)


# ------------------------------------------------------------ phases 10-12
# every kernel's launch counter: (module, attribute) by kernel name
COUNTERS = {
    "fused_encoder_layer": ("fused_encoder", "KERNEL_LAUNCHES"),        # B1
    "encoder_ffn_bwd": ("fused_encoder", "FFN_BWD_LAUNCHES"),           # B2a
    "encoder_att_bwd": ("fused_encoder", "ATT_BWD_LAUNCHES"),           # B2b
    "multilevel_roi_align": ("roi_align_windowed", "KERNEL_LAUNCHES"),  # B3
    "roi_align_backward": ("roi_align_windowed", "BWD_LAUNCHES"),       # B3-bwd
    "pair_attention": ("pair_attention", "KERNEL_LAUNCHES"),            # B4a
    "pair_attention_backward": ("pair_attention", "BWD_LAUNCHES"),      # B4b
    # B4a and B4b on their CUDA-core route (T > 32): 0 on every path here
    "pair_attention_cuda_cores": ("pair_attention", "CUDA_CORE_LAUNCHES"),
    "pair_attention_backward_cuda_cores": ("pair_attention", "CUDA_CORE_BWD_LAUNCHES"),
    "encoder_mono_bwd": ("fused_encoder", "MONO_BWD_LAUNCHES"),         # B5
}


def read_counters(reset=False):
    """Every kernel's launch count, by kernel name; ``reset`` zeroes them."""
    import importlib

    out = {}
    for name, (mod, attr) in COUNTERS.items():
        m = importlib.import_module(f"veto_tpu_torch.ops.{mod}")
        out[name] = getattr(m, attr)
        if reset:
            setattr(m, attr, 0)
    return out


def expected(**launches):
    """Launch counts of every kernel: the given ones, 0 for the rest."""
    return {name: launches.get(name, 0) for name in COUNTERS}


LAST_TRAIN = {}  # the main path's training run: from-memory step times


def phase_train(steps=5, opts=(), encoder=("fused_encoder_layer",
                                           "encoder_ffn_bwd", "encoder_att_bwd"),
                what="main path"):
    """A training path: ``relation_train_net.train`` for a few full-width
    steps from seeded weights, with the launch counts read after every step:
    exactly ``layers`` launches of each ``encoder`` kernel, 2 of ROIAlign,
    1 of its backward and none of any other kernel."""
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.models.sgg import build_model
    from veto_tpu_torch.tools.relation_train_net import train

    cfg = load_config(os.path.join(ROOT, "configs", "veto_vg_predcls.yaml"),
                      [f"solver.max_iter={steps}", f"output_dir={scratch_dir()}",
                       *opts])
    model = build_model(cfg)  # cuda, seeded weights
    layers = cfg.veto.enc_layers
    per_step = expected(**{k: layers for k in encoder}, multilevel_roi_align=2,
                        roi_align_backward=1)
    print(f"[train, {what}] VETO PredCls training, {cfg.model.backbone} "
          f"{cfg.model.resnet_groups}x{cfg.model.resnet_width_per_group}d frozen, "
          f"depth ResNet-18 + trunk {cfg.veto.t_input_dim} x {layers} layers "
          f"({cfg.veto.encoder_impl}) trained, {cfg.dtype}; {steps} steps of "
          f"{cfg.solver.ims_per_batch} "
          f"images, {cfg.relation.batch_size_per_image} pairs an image")
    frozen = {k: v.clone() for k, v in model.backbone.state_dict().items()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.requires_grad}
    stats0 = {n: b.clone() for n, b in model.named_buffers()
              if not n.startswith("backbone.")
              and n.endswith(("running_mean", "running_var"))}
    counts = []

    def log(line):
        if not line.startswith("iter "):  # the final checkpoint's line
            print(f"  {line}")
            return
        counts.append(read_counters(reset=True))
        print(f"  {line}  launches {json.dumps(counts[-1])}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read_counters(reset=True)
    state, history = train(cfg, model=model, log=log)
    peak = torch.cuda.max_memory_allocated()
    total = {k: sum(c[k] for c in counts) for k in per_step}
    ms = 1e3 * float(np.mean([r["seconds"] for r in history[1:]]))
    fed = 1e3 * float(np.mean([r["step_seconds"] for r in history[1:]]))
    wait = 1e3 * float(np.mean([r["wait_seconds"] for r in history[1:]]))
    print(f"  [{what}] after warm-up {ms:.1f} ms per step "
          f"({[round(1e3 * r['seconds'], 1) for r in history]}); peak memory "
          f"{peak / 2 ** 30:.2f} GiB; {fed:.1f} ms from one update's end to "
          f"the next, {wait:.1f} ms of it waiting for a batch")
    if what == "main path":
        LAST_TRAIN.update(fed_ms=fed, wait_share=wait / fed)
    if len(history) != steps:
        raise AssertionError(f"{len(history)} steps ran, not {steps}")
    for i, c in enumerate(counts):
        if c != per_step:
            raise AssertionError(f"step {i}: launches {c}, want {per_step}")
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in history):
        raise AssertionError(f"non-finite loss or grad norm: {history}")
    for k, v in model.backbone.state_dict().items():
        if not torch.equal(v, frozen[k]):
            raise AssertionError(f"frozen detector changed: backbone.{k}")
    still = [n for n, p in model.named_parameters()
             if p.requires_grad and torch.equal(p, before[n])]
    if still:
        raise AssertionError(f"trainable parameters unchanged: {still}")
    same = [n for n, b in model.named_buffers()
            if n in stats0 and torch.equal(b, stats0[n])]
    if same:
        raise AssertionError(f"BatchNorm statistics unchanged: {same}")
    print(f"  {len(before)} trainable tensors all changed, {len(frozen)} "
          f"detector tensors bit-unchanged, {len(stats0)} BatchNorm "
          "statistics updated")
    return state, total


def phase_train_grads(state, opts=(), what="main path", b=None):
    """One step's gradients through the kernels against the same step
    through the plain versions, on the card, from the trained state; on
    the synthetic train split's first batch unless a device batch ``b`` is
    given."""
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.engine.train import forward_backward, sample_pairs
    from veto_tpu_torch.ops import cuda_lib
    from veto_tpu_torch.tools.relation_train_net import synthetic_train_dataset

    cfg = load_config(os.path.join(ROOT, "configs", "veto_vg_predcls.yaml"),
                      list(opts))
    if b is None:
        bsz = cfg.solver.ims_per_batch
        batch, _ = next(synthetic_train_dataset(cfg).batches(bsz, cfg.data.max_boxes))
        b = batch.to(DEVICE)
    bsz = b.images.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    samples = sample_pairs(b, gen, cfg.relation.batch_size_per_image,
                           cfg.relation.positive_fraction)
    print(f"[train grads, {what}] one step's gradients, kernels vs plain: {bsz} "
          f"images of {tuple(b.images.shape[1:3])}, "
          f"{cfg.relation.batch_size_per_image} pairs an image")
    params = [(n, p) for n, p in state.model.named_parameters() if p.requires_grad]

    def grads():
        loss = forward_backward(state, b, samples)
        return loss, {n: p.grad.detach().clone() for n, p in params}

    def compare(got, ref):
        """(|err| / |ref| in L2, max |err| / max |ref|, name, finite) per
        tensor, worst first."""
        rows = []
        for n, _ in params:
            diff = got[n].float() - ref[n].float()
            rows.append((float(diff.norm()) / max(float(ref[n].float().norm()), 1e-30),
                         float(diff.abs().max())
                         / max(float(ref[n].abs().max()), 1e-30),
                         n, bool(torch.isfinite(got[n]).all())))
        return sorted(rows, reverse=True)

    loss, got = grads()
    _, again = grads()
    with cuda_lib.plain_kernels():
        ref_loss, ref = grads()
    state.optimizer.zero_grad()
    print(f"  loss {float(loss):.6f} (kernels), {float(ref_loss):.6f} (plain)")
    # The floor: what two kernel runs of one step differ by.  Every kernel
    # of the port sums in a fixed order (B3-bwd has no atomics),
    # so what is left comes from PyTorch's own ops (cuDNN's convolution
    # backwards of the depth ResNet-18 may pick algorithms that add in
    # another order); back through that network in bf16 a last-bit
    # difference grows to a few % in its first layers' gradients, whose
    # sums over every pixel nearly cancel.  Kernels vs plain versions add
    # the encoder's bf16 rounding flips on top.  Each tensor is held to 10%
    # (L2) and 25% (largest element) of its plain version; a dropped or
    # misplaced term is off by about 100%.
    floor = compare(again, got)[0]
    # in parameter order from the last (nearest the loss) back
    varies = [n for n, _ in reversed(params) if not torch.equal(got[n], again[n])]
    if not varies:
        print("  two kernel runs: floor 0, every gradient tensor bit-equal")
    else:
        print(f"  two kernel runs: worst |err| / |ref| {floor[0]:.3e} ({floor[2]}); "
              f"{len(varies)} of {len(params)} tensors vary, the one nearest the "
              f"loss in parameter order {varies[0]} (|err| / |ref| "
              f"{next(r[0] for r in compare(again, got) if r[2] == varies[0]):.3e})")
    rows = compare(got, ref)
    for rel_l2, rel_max, n, _ in rows[:4]:
        print(f"  {n}: |err| / |ref| {rel_l2:.3e}, max |err| {rel_max:.3e} of max |ref|")
    bad = [r for r in rows if r[0] > 0.1 or r[1] > 0.25 or not r[3]]
    if bad:
        raise AssertionError(f"gradients off: {bad}")
    if abs(float(loss) - float(ref_loss)) > 1e-2 * abs(float(ref_loss)):
        raise AssertionError("loss differs by more than 1%")
    print(f"  {len(params)} gradient tensors within 10% (L2) and 25% (max) of "
          "their plain versions")


def phase_paths():
    """The two further paths through the entry points: the encoder's
    ``pair_attn`` implementation (evaluation, training) and the fused
    encoder with the monolithic backward (``FUSED_SPLIT`` off, then also
    ``FUSED_STASH`` off).  Returns each path's launches by kernel."""
    from veto_tpu_torch.ops import fused_encoder as fe

    pair_attn = ("veto.encoder_impl=pair_attn",)
    phase_main_path(pair_attn, n_batches=2, encoder="pair_attention")
    state, pa_launches = phase_train(
        3, pair_attn, encoder=("pair_attention", "pair_attention_backward"),
        what="pair_attn")
    phase_train_grads(state, pair_attn, what="pair_attn")
    del state
    release()
    saved = fe.FUSED_SPLIT, fe.FUSED_STASH
    mono = ("fused_encoder_layer", "encoder_mono_bwd")
    try:
        fe.FUSED_SPLIT = False
        state, mono_launches = phase_train(3, encoder=mono, what="FUSED_SPLIT=False")
        del state
        release()
        fe.FUSED_STASH = False
        state, _ = phase_train(3, encoder=mono,
                               what="FUSED_SPLIT=False, FUSED_STASH=False")
        phase_train_grads(state, what="FUSED_SPLIT=False, FUSED_STASH=False")
        del state
        release()
    finally:
        fe.FUSED_SPLIT, fe.FUSED_STASH = saved
    return pa_launches, mono_launches


# ------------------------------------------------------------------ phase 13
class VGShapedDataset:
    """An in-memory dataset with the Visual Genome reader's interface
    (``get_groundtruth``, ``idx_list``, ``load_image``, ``load_image_raw``
    and ``image_size`` for the loader's fused path, ``load_depth``, and
    ``img_info`` / ``gt_classes`` / ``relationships`` for the zero-shot
    triplets): raw u8 images at VG's own sizes (longest side 450-500),
    portrait where ``portrait`` says so, 20-80 boxes at the image's scale
    with 5-30 relations among them, and a 16-bit depth map; all drawn
    from ``seed``.  It stands in for the VG files, which the card's machine
    does not have (nor h5py or PIL to read them)."""

    def __init__(self, portrait, seed, num_obj=151, num_rel=51, max_boxes=80):
        rng = np.random.RandomState(seed)
        self.img_info, self.gt_classes, self.relationships = [], [], []
        self._images, self._depth, self._boxes = [], [], []
        for i, tall in enumerate(portrait):
            long, short = int(rng.randint(450, 501)), int(rng.randint(300, 376))
            w, h = (short, long) if tall else (long, short)
            n = int(rng.randint(20, max_boxes + 1))
            x1, y1 = rng.uniform(0, w * 0.7, n), rng.uniform(0, h * 0.7, n)
            x2 = np.minimum(x1 + rng.uniform(w * 0.05, w * 0.3, n), w - 1)
            y2 = np.minimum(y1 + rng.uniform(h * 0.05, h * 0.3, n), h - 1)
            pairs = rng.choice(n * n, size=int(rng.randint(5, 31)), replace=False)
            subj, obj = pairs // n, pairs % n
            keep = subj != obj
            self.relationships.append(np.stack(
                [subj[keep], obj[keep], rng.randint(1, num_rel, int(keep.sum()))],
                1).astype(np.int64))
            self.img_info.append({"image_id": 10000 + i, "width": w, "height": h})
            self.gt_classes.append(rng.randint(1, num_obj, n).astype(np.int64))
            self._boxes.append(np.stack([x1, y1, x2, y2], 1).astype(np.float32))
            self._images.append(rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
            self._depth.append(rng.randint(0, 65536, (h, w)).astype(np.float32))
        self.idx_list = list(range(len(portrait)))

    def __len__(self):
        return len(self.idx_list)

    def get_groundtruth(self, index, inner_idx=True):
        index = index if inner_idx else self.idx_list[index]
        info, rels = self.img_info[index], self.relationships[index]
        n = len(self._boxes[index])
        rel_matrix = np.zeros((n, n), np.int64)
        rel_matrix[rels[:, 0], rels[:, 1]] = rels[:, 2]
        return {"boxes": self._boxes[index].copy(),
                "labels": self.gt_classes[index].astype(np.int32),
                "rel_matrix": rel_matrix, "rel_tuples": rels,
                "size": np.array([info["width"], info["height"]], np.int32),
                "image_id": info["image_id"]}

    def load_image(self, index):
        return self._images[index].astype(np.float32) / 255.0

    def load_image_raw(self, index):
        return self._images[index]

    def image_size(self, index):
        return self.img_info[index]["width"], self.img_info[index]["height"]

    def load_depth(self, index):
        return self._depth[index][..., None]


def host_ms(fn, iters: int) -> float:
    """Milliseconds per call on the host's clock, the card synchronized
    before and after (for copies that block the host anyway)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def reference_detector(body, gen, path):
    """A maskrcnn-benchmark detector state dict at the shapes of the unfolded
    port body ``body`` (seeded: LeCun-normal convs, BN weight in [0.5, 1],
    running var in [0.5, 1.5], small biases and means), saved with
    ``torch.save`` to ``path``.  Returns it as numpy arrays."""
    import re

    def ref_name(name):
        name = name.replace("body.stem_conv.", "body.stem.conv1.")
        name = name.replace("body.stem_bn.", "body.stem.bn1.")
        name = re.sub(r"_block(\d+)\.downsample_conv\.", r".\1.downsample.0.", name)
        name = re.sub(r"_block(\d+)\.downsample_bn\.", r".\1.downsample.1.", name)
        return "backbone." + re.sub(r"_block(\d+)\.", r".\1.", name)

    sd = {}
    for name, t in body.state_dict().items():
        n = ref_name(name)
        if t.dim() == 4:
            sd[n] = torch.randn(t.shape, generator=gen) * t[0].numel() ** -0.5
        elif name.startswith("fpn."):
            sd[n] = 0.1 * torch.randn(t.shape, generator=gen)
        elif n.endswith(".weight"):  # a BatchNorm's affine and statistics
            base = n[: -len(".weight")]
            sd[n] = 0.5 + 0.5 * torch.rand(t.shape, generator=gen)
            sd[base + ".running_mean"] = 0.1 * torch.randn(t.shape, generator=gen)
            sd[base + ".running_var"] = 0.5 + torch.rand(t.shape, generator=gen)
        else:
            sd[n] = 0.1 * torch.randn(t.shape, generator=gen)
    torch.save({"model": sd}, path)
    return {k: v.numpy() for k, v in sd.items()}


def check_detector_import(model, ref, fold_bn) -> int:
    """Every tensor of ``model``'s detector equals the reference state dict
    ``ref`` under the import's mapping, computed here in numpy: convs and
    the FPN renamed, each BatchNorm folded without eps (``scale = w /
    sqrt(var)``, ``bias = b - mean * scale``) into a FrozenBatchNorm or,
    with ``fold_bn``, into its conv.  Returns the tensors checked."""
    import re

    bn_of = {"stem_conv": "stem_bn", "conv1": "bn1", "conv2": "bn2",
             "conv3": "bn3", "downsample_conv": "downsample_bn"}

    def ref_prefix(mod):
        mod = mod.replace("body.stem_conv", "body.stem.conv1")
        mod = mod.replace("body.stem_bn", "body.stem.bn1")
        mod = re.sub(r"_block(\d+)\.downsample_conv$", r".\1.downsample.0", mod)
        mod = re.sub(r"_block(\d+)\.downsample_bn$", r".\1.downsample.1", mod)
        return "backbone." + re.sub(r"_block(\d+)\.", r".\1.", mod)

    def fold(bn_mod):
        p = ref_prefix(bn_mod)
        scale = ref[p + ".weight"] / np.sqrt(ref[p + ".running_var"])
        return scale, ref[p + ".bias"] - ref[p + ".running_mean"] * scale

    state = model.backbone.state_dict()
    for name, t in state.items():
        mod, leaf = name.rsplit(".", 1)
        last = mod.rsplit(".", 1)[-1]
        if name.startswith("fpn."):
            want = ref["backbone." + name]
        elif last in bn_of.values():  # unfolded: FrozenBatchNorm
            want = fold(mod)[0 if leaf == "weight" else 1]
        else:  # a conv of the body
            w = ref[ref_prefix(mod) + ".weight"]
            if not fold_bn:
                want = w
            else:
                scale, bias = fold(mod[: -len(last)] + bn_of[last])
                want = w * scale[:, None, None, None] if leaf == "weight" else bias
        if not np.array_equal(t.cpu().numpy(), want):
            raise AssertionError(f"fold_bn={fold_bn}: backbone.{name} is not the "
                                 "imported tensor")
    return len(state)


def train_counts(events, per_step, per_val):
    """The launch counts read at each log line of a ``train`` run, held to
    ``per_step`` at every step and ``per_val`` at every validation."""
    for i, (kind, counts) in enumerate(events):
        want = per_step if kind == "iter" else per_val
        if counts != want:
            raise AssertionError(f"{kind} (line {i}): launches {counts}, want {want}")


def same_train_state(a, b, what):
    """Parameters, BatchNorm statistics, Adam's moments and steps, and the
    sampler's generator bit-equal."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    diff = [k for k in sa if not torch.equal(sa[k], sb[k])]
    oa, ob = a.optimizer.adam.state_dict()["state"], b.optimizer.adam.state_dict()["state"]
    diff += [f"adam {i} {k}" for i in oa for k in ("step", "exp_avg", "exp_avg_sq")
             if oa[i][k].device != ob[i][k].device
             or not torch.equal(oa[i][k], ob[i][k])]
    if not torch.equal(a.generator.get_state(), b.generator.get_state()):
        diff.append("generator")
    if diff or a.step != b.step:
        raise AssertionError(f"{what}: steps {a.step}/{b.step}, differ: {diff[:8]}")
    print(f"  {what}: {len(sa)} model tensors, {len(oa)} Adam states and the "
          f"generator bit-equal at step {a.step}")


def phase_data_path(gen):
    """Training and evaluation from Visual-Genome-shaped data, at full width:
    the host ops, the reference detector import, ``train`` through
    ``SGGLoader`` and the device feeder with validation, checkpoints and
    resume, ``evaluate`` restoring the last checkpoint, and the kernels on
    the portrait bucket and the envelope shape against their plain
    versions."""
    import shutil

    from veto_tpu_torch import native
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.data import transforms
    from veto_tpu_torch.data.loader import SGGLoader
    from veto_tpu_torch.engine.batch import DeviceFeeder
    from veto_tpu_torch.engine.evaluate import make_eval_step
    from veto_tpu_torch.engine.train import create_train_state, train_step
    from veto_tpu_torch.models.sgg import build_model
    from veto_tpu_torch.solver.optim import LRController
    from veto_tpu_torch.tools import relation_test_net
    from veto_tpu_torch.tools import relation_train_net as rtn
    from veto_tpu_torch.utils.checkpoint import CheckpointManager

    yaml = os.path.join(ROOT, "configs", "veto_vg_predcls.yaml")
    name = card()
    t0 = time.perf_counter()
    if not native.available() or native.PATH_TAKEN not in ("built", "loaded"):
        raise AssertionError(f"host ops: {native.PATH_TAKEN}; the fused path "
                             "needs the library")
    print(f"[data path] host ops {native.PATH_TAKEN} ({native.library_path().name}) "
          f"in {time.perf_counter() - t0:.2f} s")

    # 1. the fused u8 path against the NumPy pipeline, at VG sizes
    cfg = load_config(yaml, [f"output_dir={scratch_dir()}"])
    probe = VGShapedDataset([False, True], seed=11)
    pads = SGGLoader(probe, 1, min_size=cfg.data.min_size_train,
                     max_size=cfg.data.max_size_train,
                     size_divisibility=cfg.data.size_divisibility).pad_shapes
    val_pads = SGGLoader(probe, 1, min_size=cfg.data.min_size_test,
                         max_size=cfg.data.max_size_test,
                         size_divisibility=cfg.data.size_divisibility).pad_shapes
    for i in range(2):
        w0, h0 = probe.image_size(i)
        oh, ow = transforms.resize_shape(w0, h0, cfg.data.min_size_train,
                                         cfg.data.max_size_train)
        ph, pw = pads["portrait" if oh > ow else "landscape"]
        img = np.empty((ph, pw, 3), np.float32)
        dep = np.empty((ph, pw, 1), np.float32)
        native.resize_normalize_u8_into(probe.load_image_raw(i), oh, ow, img,
                                        cfg.data.pixel_mean, cfg.data.pixel_std)
        native.resize_standardize_into(probe.load_depth(i), oh, ow, dep)
        ref = transforms.pad_to(transforms.normalize_image(
            transforms.resize_image(probe.load_image(i), oh, ow),
            cfg.data.pixel_mean, cfg.data.pixel_std), ph, pw)
        dref = transforms.pad_to(transforms.normalize_depth(
            transforms.resize_image(probe.load_depth(i), oh, ow)), ph, pw)
        e_img, e_dep = float(np.abs(img - ref).max()), float(np.abs(dep - dref).max())
        print(f"  fused u8 path {h0}x{w0} -> {oh}x{ow} in {ph}x{pw} (HxW): max |err| "
              f"image {e_img:.2e} (tol 2e-3), depth {e_dep:.2e} (tol 1e-4)")
        if e_img > 2e-3 or e_dep > 1e-4:
            raise AssertionError("the fused host path disagrees with NumPy")

    # 2. the loader alone, and the eval batch's copy to the card
    portrait = [i % 2 == 1 for i in range(48)]
    train_ds = VGShapedDataset(portrait, seed=1)
    val_ds = VGShapedDataset([False] * 12 + [True] * 4, seed=2)
    loader = SGGLoader(train_ds, cfg.solver.ims_per_batch, cfg.data.max_boxes,
                       cfg.model.num_obj_classes, cfg.data.min_size_train,
                       cfg.data.max_size_train, seed=cfg.solver.seed)
    if not loader.fast_capable():
        raise AssertionError("the loader does not take its fused path")
    t0 = time.perf_counter()
    n_img = sum(len(recs) for _, recs in loader.iterations(8))
    ips = n_img / (time.perf_counter() - t0)
    land, tall_shape = pads["landscape"], pads["portrait"]  # 800x1344, 1344x800
    vl, vp = val_pads["landscape"], val_pads["portrait"]
    envelope = (max(vl[0], vp[0]), max(vl[1], vp[1]))  # 1344x1344
    val_batches = list(rtn.batches_for(cfg, val_ds, "val")(0))
    shapes = [tuple(b.images.shape[1:3]) for b, _ in val_batches]
    if shapes != [vl, envelope]:
        raise AssertionError(f"val batch shapes {shapes}, want {[vl, envelope]}")
    host = val_batches[0][0]
    pageable = host_ms(lambda: host.to(DEVICE), 10)
    pinned = {f: torch.from_numpy(np.ascontiguousarray(getattr(host, f))).pin_memory()
              for f in vars(host)}
    pinned_ms = host_ms(lambda: [t.to(DEVICE, non_blocking=True)
                                 for t in pinned.values()], 10)
    mb = sum(t.numel() * t.element_size() for t in pinned.values()) / 1e6
    print(f"  loader: {ips:.1f} images/s with {loader.num_workers} workers (fused "
          f"path); eval batch of {host.images.shape[0]} x {shapes[0]} ({mb:.0f} MB) "
          f"to the card: pinned non-blocking {pinned_ms:.2f} ms, pageable "
          f"{pageable:.2f} ms")
    del pinned

    # 3. the reference detector, imported with fold_bn false and true
    ckpt_dir = scratch_dir()
    path = os.path.join(ckpt_dir, "model_final.pth")
    from veto_tpu_torch.models.backbone.resnet import ResNetFPNBackbone

    with torch.device("meta"):  # the unfolded body's names and shapes
        unfolded = ResNetFPNBackbone(cfg.model.stage_blocks, cfg.model.resnet_groups,
                                     cfg.model.resnet_width_per_group,
                                     cfg.model.fpn_channels, fold_bn=False)
    ref_sd = reference_detector(unfolded, torch.Generator().manual_seed(3), path)
    del unfolded
    b_eval = val_batches[0][0].to(DEVICE)
    logits, pyramids = {}, {}
    for fold in (False, True):
        c = load_config(yaml, [f"model.fold_bn={fold}",
                               f"model.pretrained_detector_ckpt={path}"])
        m = build_model(c)
        lines = []
        loaded, skipped = rtn.load_pretrained_detector(c, m, lines.append)
        n = check_detector_import(m, ref_sd, fold)
        if len(loaded) != n or skipped:
            raise AssertionError(f"fold_bn={fold}: {len(loaded)} loaded of {n}, "
                                 f"skipped {skipped[:4]}")
        print(f"  detector import fold_bn={fold}: {lines[0]}; all {n} tensors "
              "equal the reference under the mapping")
        logits[fold] = check_eval_batch(m, c, b_eval,
                                        f"rel_logits fold_bn={fold} kernels vs plain")
        if not fold:  # the same model, its FrozenBatchNorms' affine in f32
            with f32_frozen_bn():
                logits["f32 bn"] = eval_logits(m, c, b_eval)
        m.backbone.dtype = torch.float32  # the detector in f32, the rest bf16
        with torch.no_grad():
            pyramids[fold] = m.backbone(b_eval.images)
        logits[fold, "f32 body"] = eval_logits(m, c, b_eval)
        del m
        release()
    # The two layouts are one function: in f32 their pyramids agree to f32
    # rounding (a misplaced scale or bias is off by its size), and with the
    # detector in f32 the two models' logits (trunk and kernels in bf16) are
    # held to the main path's whole bf16 tolerance, max and mean.  With the
    # detector in bf16 the layouts round differently in every one of its
    # ~100 convolutions: those logits are held to the max bound and their
    # mean error reported, beside the unfolded model's with its
    # FrozenBatchNorms' scale and bias in f32 (not the cause: PERF.md).
    for lvl, (a, b) in enumerate(zip(pyramids[True], pyramids[False])):
        scale = float(b.abs().max())
        check_close(f"P{lvl + 2} f32 fold_bn=True vs fold_bn=False", a, b,
                    atol=1e-3 * scale, rtol=0.0,
                    mean_tol=1e-4 * float(b.abs().mean()))
    for got, ref, what in (
            (logits[True, "f32 body"], logits[False, "f32 body"],
             "detector in f32"),
            (logits[True], logits[False], "detector in bf16"),
            (logits[True], logits["f32 bn"],
             "detector in bf16, unfolded FrozenBatchNorms in f32")):
        mean_ref = float(ref.abs().mean())
        gated = what == "detector in f32"
        check_close(f"rel_logits fold_bn=True vs fold_bn=False, {what}", got,
                    ref, atol=0.05 * float(ref.abs().max()), rtol=0.0,
                    mean_tol=0.01 * mean_ref if gated else None)
        mean_err = float((got - ref).abs().mean())
        print(f"  (mean |err| {mean_err:.4f}, {mean_err / mean_ref:.2%} of the "
              f"mean |logit|, {what})")
    shutil.rmtree(ckpt_dir)
    del logits, pyramids, b_eval

    # 4. train: 6 steps, a checkpoint every 3, validation at 4
    layers = cfg.veto.enc_layers
    per_step = expected(fused_encoder_layer=layers, encoder_ffn_bwd=layers,
                        encoder_att_bwd=layers, multilevel_roi_align=2,
                        roi_align_backward=1)
    per_val = expected(fused_encoder_layer=layers * len(val_batches),
                       multilevel_roi_align=2 * len(val_batches))
    solver = ["solver.max_iter=6", "solver.val_period=4", "solver.checkpoint_period=3"]
    out_a = scratch_dir()
    cfg_a = load_config(yaml, [f"output_dir={out_a}", *solver])
    events = []

    def log(line):
        kind = line.split(" ", 1)[0]
        if kind in ("iter", "validation"):
            events.append((kind, read_counters(reset=True)))

    print(f"[data path, train] 6 steps of {cfg_a.solver.ims_per_batch} VG-shaped "
          f"images through SGGLoader and the device feeder, checkpoints every 3, "
          f"validation at 4 on {len(val_ds)} images")
    read_counters(reset=True)
    state, history = rtn.train(cfg_a, model=build_model(cfg_a), log=log,
                               datasets=(train_ds, val_ds))
    train_counts(events, per_step, per_val)
    buckets = [r["image_shape"] for r in history]
    if len(history) != 6 or set(buckets) != {land, tall_shape}:
        raise AssertionError(f"{len(history)} steps on {buckets}")
    steps = CheckpointManager(os.path.join(out_a, "ckpt")).steps()
    if steps != [3, 6]:
        raise AssertionError(f"checkpoints {steps}, want [3, 6]")
    mr = history[3]["val_mR100"]
    ctrl = LRController(cfg_a.solver)
    ctrl.report_validation(mr)
    extra = CheckpointManager(os.path.join(out_a, "ckpt")).load(6, "cpu")["extra"]
    if extra != {k: getattr(ctrl, k) for k in extra}:
        raise AssertionError(f"LRController {extra} after validation mR@100 {mr}")
    fed = [r["step_seconds"] for r in history[1:]]
    wait = [r["wait_seconds"] for r in history[1:]]
    dev_ms = 1e3 * float(np.mean([r["seconds"] for r in history[1:]]))
    print(f"  buckets {buckets}; launches exact at every step ({per_step['fused_encoder_layer']} "
          f"B1, B2a, B2b, 2 B3, 1 B3-bwd) and at the validation ({len(val_batches)} "
          f"batches {shapes}); checkpoints {steps}; validation mR@100 {mr:.6f} -> "
          f"LRController {extra}")
    print(f"  train step fed by the loader: {1e3 * np.mean(fed):.1f} ms from one update's "
          f"end to the next ({[round(1e3 * x, 1) for x in fed]}), "
          f"{1e3 * np.mean(wait):.1f} ms of it ({np.sum(wait) / np.sum(fed):.1%}) "
          f"waiting for a batch; {dev_ms:.1f} ms from the batch on the card")

    # 5. the checkpoint of step 6 on the CPU, and evaluate restoring it
    payload = CheckpointManager(os.path.join(out_a, "ckpt")).load(6, "cpu")
    cpu_model = build_model(cfg_a, "cpu")
    cpu_model.load_state_dict(payload["model"])
    for k, v in state.model.state_dict().items():
        if not torch.equal(v.cpu(), cpu_model.state_dict()[k]):
            raise AssertionError(f"{k} differs restored on the CPU")
    del payload, cpu_model
    evaluator = relation_test_net.make_sgg_evaluator(cfg_a, train_ds, val_ds)
    read_counters(reset=True)
    agg, _ = rtn.run_validation(state.model, make_eval_step(
        state.model, cfg_a.relation.max_proposal_pairs), rtn.batches_for(
            cfg_a, val_ds, "val")(0), evaluator, DEVICE)
    train_counts([("validation", read_counters(reset=True))], per_step, per_val)
    lines = []
    restored, _ = relation_test_net.evaluate(cfg_a, split="val", dataset=val_ds,
                                             train_dataset=train_ds, log=lines.append)
    if "evaluating the checkpoint of step 6" not in lines:
        raise AssertionError(f"evaluate did not restore step 6: {lines[:2]}")
    bad = [k for k in agg if restored.get(k) != agg[k]]
    if bad:
        raise AssertionError(f"restored evaluation differs in {bad}")
    print(f"  checkpoint of step 6 restored on the CPU bit-equal; evaluate "
          f"restoring it reproduces the validation of the step-6 model exactly "
          f"(mR@100 {agg['mR'][100]:.6f}, R@100 {agg['R'][100]:.6f}, zero-shot "
          f"triplets {len(evaluator.zeroshot_triplets)})")
    del state, evaluator
    release()

    # 6. resume from step 3 against the same stream without a save
    out_b = scratch_dir()
    os.makedirs(os.path.join(out_b, "ckpt"))
    shutil.copy(os.path.join(out_a, "ckpt", "model_0000003.pth"),
                os.path.join(out_b, "ckpt"))
    cfg_b = load_config(yaml, [f"output_dir={out_b}", *solver])
    events.clear()
    read_counters(reset=True)
    resumed, hist_b = rtn.train(cfg_b, model=build_model(cfg_b), log=log,
                                datasets=(train_ds, val_ds))
    train_counts(events, per_step, per_val)
    if len(hist_b) != 3 or resumed.step != 6:
        raise AssertionError(f"resumed run: {len(hist_b)} steps to {resumed.step}")
    ref = create_train_state(build_model(cfg_b), cfg_b.solver,
                             rtn.rel_class_weights(cfg_b))
    ref.generator = torch.Generator(device=DEVICE).manual_seed(cfg_b.solver.seed)
    ctrl = LRController(cfg_b.solver)
    for lo, hi in ((0, 3), (3, 6)):
        stream = rtn.batches_for(cfg_b, train_ds, "train")(hi, lo)
        for it, (b, _) in enumerate(DeviceFeeder(stream, DEVICE), start=lo):
            train_step(ref, b, ref.generator, ctrl.scale(it),
                       cfg_b.relation.batch_size_per_image,
                       cfg_b.relation.positive_fraction)
    same_train_state(resumed, ref, "resumed at 3 vs 3 + 3 steps on the resumed "
                     "stream without a save")
    # the same step fed from memory: host batches built before, through
    # the feeder (its pinned copies overlapping the step before)
    held = [hb for hb, _ in rtn.batches_for(cfg_b, train_ds, "train")(6)]
    feeder = DeviceFeeder(((hb, []) for hb in held), DEVICE)
    felt, t_prev = [], None
    for it, (b, _) in enumerate(feeder, start=6):
        train_step(ref, b, ref.generator, ctrl.scale(it),
                   cfg_b.relation.batch_size_per_image,
                   cfg_b.relation.positive_fraction)
        torch.cuda.synchronize()
        now = time.perf_counter()
        if t_prev is not None:
            felt.append(now - t_prev)
        t_prev = now
    mem_ms, mem_wait = 1e3 * float(np.mean(felt)), sum(feeder.waits[1:]) / sum(felt)
    print(f"  train step fed from memory through the feeder: {mem_ms:.1f} ms "
          f"from one update's end to the next "
          f"({[round(1e3 * x, 1) for x in felt]}), {mem_wait:.1%} waiting")
    del held, feeder, b
    mgr = CheckpointManager(scratch_dir())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt_file = mgr.save(6, resumed)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mgr.restore(resumed)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    size = os.path.getsize(ckpt_file)
    del resumed
    release()

    # 7. the kernels on both buckets and the envelope, against the plain versions
    landscape, portrait_b = None, None
    for hb, _ in rtn.batches_for(cfg_b, train_ds, "train")(6):
        if hb.images.shape[1] > hb.images.shape[2] and portrait_b is None:
            portrait_b = hb
        elif hb.images.shape[1] < hb.images.shape[2] and landscape is None:
            landscape = hb
    for hb in (landscape, portrait_b):
        phase_train_grads(ref, (), f"VG-shaped {tuple(hb.images.shape[1:3])} bucket",
                          b=hb.to(DEVICE))
    tall = VGShapedDataset([True] * 8, seed=4)
    eval_b = [val_batches[0][0], next(rtn.batches_for(cfg_b, tall, "val")(0))[0],
              val_batches[1][0]]
    for hb in eval_b:
        check_eval_batch(ref.model, cfg_b, hb.to(DEVICE), "rel_logits "
                         f"{tuple(hb.images.shape[1:3])} kernels vs plain")
    del ref
    release()
    phase_roi_align(gen, h=1344, w=800)
    phase_roi_align(gen, h=1344, w=1344)
    phase_roi_align_bwd(gen, h=1344, w=800)
    print(f"[data path numbers] {name}: loader {ips:.1f} images/s with "
          f"{loader.num_workers} workers; train step fed by the loader "
          f"{1e3 * np.mean(fed):.1f} ms ({np.sum(wait) / np.sum(fed):.1%} waiting), "
          f"fed from memory {mem_ms:.1f} ms ({mem_wait:.1%} waiting), fed by the "
          f"synthetic corpus (phase 10, which draws its images per batch) "
          f"{LAST_TRAIN['fed_ms']:.1f} ms ({LAST_TRAIN['wait_share']:.1%} "
          f"waiting); eval batch copy pinned "
          f"{pinned_ms:.2f} ms, pageable {pageable:.2f} ms; checkpoint save "
          f"{save_s:.2f} s, restore {restore_s:.2f} s, {size / 2 ** 20:.0f} MiB")


_SCRATCH = []


def scratch_dir() -> str:
    """A fresh temporary directory (an ``output_dir`` of the tools), removed
    when the script ends."""
    import atexit
    import shutil
    import tempfile

    if not _SCRATCH:
        _SCRATCH.append(tempfile.mkdtemp(prefix="chip_smoke_"))
        atexit.register(shutil.rmtree, _SCRATCH[0], True)
    return tempfile.mkdtemp(dir=_SCRATCH[0])


def release():
    """Give the freed memory of a finished phase back before the next."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


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
    phase_gemm_core(gen)
    kernels = [phase_roi_align(gen), phase_encoder(gen)]
    phase_main_path()
    kernels += [*phase_encoder_bwd(gen), phase_roi_align_bwd(gen),
                *phase_pair_attention(gen), phase_mono_bwd(gen)]
    release()
    state, launches = phase_train()
    phase_train_grads(state)
    del state
    release()
    pa_launches, mono_launches = phase_paths()
    phase_data_path(gen)
    # each kernel's launches on the training path that runs it
    launches.update(pair_attention=pa_launches["pair_attention"],
                    pair_attention_backward=pa_launches["pair_attention_backward"],
                    encoder_mono_bwd=mono_launches["encoder_mono_bwd"])
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
