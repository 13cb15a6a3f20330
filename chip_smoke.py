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
3. ROIAlign kernel vs its plain version at the PredCls eval shapes: P2-P5
   of 8 x 800x1344 images and the 1/16 depth map, 80 rois per image with
   edge cases, bf16 maps (and f32 maps once).
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
7. ROIAlign backward kernel vs autograd of the plain pooling on the 1/16
   depth map of 12 x 800x1344 images, 80 rois each.
8. Pair-attention kernels B4a and B4b vs their plain versions, q/k/v the
   strided thirds of a packed qkv, at 16,384 and 12,288 pairs x 19 x 576
   and at 509 pairs with t_pad 24 > t_valid 19; SDPA with the key mask as
   the yardstick.
9. Monolithic encoder backward B5 vs its plain version at 12,288 pairs,
   with and without the qkv/x1 stash; two kernel runs bit-equal; B5 vs
   B2a + B2b on the same input; the two external dW ``torch.matmul``s
   timed apart.
10. The training main path: ``relation_train_net.train`` for 5 full-width
    PredCls steps from seeded weights, with exact launch counts per step
    (B1, B2a, B2b 6 each, B3 2, B3-bwd 1, B4a, B4b, B5 0), finite losses,
    every trainable tensor changed and the frozen detector bit-unchanged;
    then one step's gradients through the kernels against the same step
    through the plain versions.
11. The ``veto.encoder_impl=pair_attn`` path: 2 eval batches (B4a 6, B3 2
    per batch), 3 train steps (B4a 6, B4b 6, B3 2, B3-bwd 1 per step) and
    one step's gradients against the plain versions.
12. The monolithic-backward path: 3 train steps with
    ``fused_encoder.FUSED_SPLIT = False`` (B1 6, B5 6, B3 2, B3-bwd 1 per
    step), 3 more with ``FUSED_STASH = False`` too, and one step's
    gradients against the plain versions; both constants restored after.
13. One JSON line ``{"kernels": [...]}`` (all eight kernels; ``launches``
    from the training path that runs each) and, last,
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
    from veto_tpu_torch.models.relation.sampling import prepare_test_pairs
    from veto_tpu_torch.models.sgg import build_model
    from veto_tpu_torch.ops import cuda_lib
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


def sdpa_ms(gen, pairs, t, d, heads, backward) -> float:
    """SDPA with the key mask on the strided (P, heads, T, dh) views of a
    packed qkv, as the pair-attention path lays them out: the forward, or
    its backward (timed only; the port never calls it)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = (torch.arange(t, device=DEVICE) < t).expand(t, t)
    qkv = torch.randn(pairs, t, 3 * d, generator=gen, device=DEVICE).bfloat16()
    do = torch.randn(pairs, t, d, generator=gen, device=DEVICE).bfloat16()

    def heads_of(a):
        return a.unflatten(-1, (heads, d // heads)).transpose(1, 2)

    if not backward:
        with torch.inference_mode():
            q4, k4, v4 = (heads_of(a) for a in qkv.chunk(3, dim=-1))
            return cuda_ms(lambda: sdpa(q4, k4, v4, attn_mask=mask), 20)
    q4, k4, v4 = (heads_of(a) for a in qkv.requires_grad_().chunk(3, dim=-1))
    o4 = sdpa(q4, k4, v4, attn_mask=mask)
    return cuda_ms(lambda: o4.backward(heads_of(do), retain_graph=True), 20)


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
    gradient at the PredCls train shape."""
    from veto_tpu_torch.ops import roi_align_windowed as rw

    p, s, scale = 8, 2, 0.0625
    print(f"[roi_align bwd] kernel vs plain, {b} x {h // 16}x{w // 16}x{c} "
          "depth map, 80 rois an image")
    depth = torch.randn(b, h // 16, w // 16, c, generator=gen,
                        device=DEVICE).bfloat16()
    rois = eval_rois(gen, b, 80, h, w)
    g = torch.randn(b, 80, p, p, c, generator=gen, device=DEVICE)

    def kernel():
        return rw._launch_backward([depth], [True], rois, g, (scale,), p, s)[0]

    def plain():
        return rw.reference_multilevel_roi_align_backward(
            [depth], [True], rois, g, (scale,), p, s)[0]

    got, ref = kernel(), plain()
    if got.dtype != depth.dtype or ref.dtype != depth.dtype:
        raise AssertionError(f"grad dtypes {got.dtype}, {ref.dtype}; map {depth.dtype}")
    # both sum the same f32 products in f32 (the atomics in an order that
    # varies from run to run) and round once to bf16: where the two f32
    # sums straddle a rounding boundary they differ by one bf16 ulp, at most
    # 2^-7 of the value
    err = check_close("depth grad bf16", got, ref, atol=1e-5, rtol=2 ** -7)
    ms, plain_ms = cuda_ms(kernel, 50), cuda_ms(plain, 3)
    # in: the f32 gradient and the rois; out: the bf16 map gradient
    nbytes = g.numel() * 4 + rois.numel() * 4 + depth.numel() * 2
    flops = g.numel() * 4 * 4 * 2  # 4 samples x 4 taps, one FMA each
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    print(f"  kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; {nbytes / 1e6:.1f} MB "
          f"-> bound {max(t_bytes, t_ops):.4f} ms")
    return dict(name="roi_align_backward", route="cuda",
                source="veto_tpu_torch/csrc/roi_align.cu",
                replaces="veto_tpu/ops/roi_align.py:175",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


# ------------------------------------------------------------------ phase 8
def phase_pair_attention(gen, d=576, heads=6):
    """B4a and B4b against their plain versions, q/k/v the strided thirds of
    one packed qkv as ``_xla_layer`` passes them: at the eval (16,384
    pairs) and train (12,288) shapes and once at an odd pair count with
    t_pad 24 > t_valid 19; then their times, bounds and SDPA's."""
    from veto_tpu_torch.ops import pair_attention as pa

    t, dh = 19, d // heads
    print(f"[pair attention] B4a/B4b vs plain, q/k/v slices of a packed qkv, "
          f"x {t} tokens x {d}, {heads} heads")
    # same rounding points (bf16 probabilities, bf16(ds * scale), each
    # output once); an f32 sum in another order can flip one bf16 rounding,
    # one ulp (2^-8) of that value: 1% of the largest |value| everywhere,
    # 0.1% on average, as phase 6 holds the encoder backward
    tol = dict(max_tol=1e-2, mean_tol=1e-3)
    errs = {"fwd": 0.0, "bwd": 0.0}

    def inputs(pairs, t_pad):
        qkv = torch.randn(pairs, t_pad, 3 * d, generator=gen, device=DEVICE).bfloat16()
        do = torch.randn(pairs, t_pad, d, generator=gen, device=DEVICE).bfloat16()
        return qkv, qkv.chunk(3, dim=-1), do

    def bwd(q, k, v, do):
        """B4b writing dq, dk, dv packed, as ``pair_attention_qkv`` has it"""
        dqkv = torch.empty(*q.shape[:2], 3 * d, dtype=q.dtype, device=DEVICE)
        pa._launch_backward(q, k, v, do, heads, t, dqkv.chunk(3, dim=-1))
        return dqkv.chunk(3, dim=-1)

    def compare(which, names, got, ref):
        for name, g_, r_ in zip(names, got, ref):
            check_scaled(name, g_, r_, **tol)
            errs[which] = max(errs[which], float((g_.float() - r_.float()).abs().max()))

    times = {}
    with torch.inference_mode():
        for pairs, t_pad in ((16384, t), (12288, t), (509, 24)):
            _, (q, k, v), do = inputs(pairs, t_pad)
            print(f"  {pairs} pairs, t_pad {t_pad}, t_valid {t}")
            compare("fwd", ["B4a out"], [pa._launch_forward(q, k, v, heads, t)],
                    [pa.reference_pair_attention_forward(q, k, v, heads, t)])
            compare("bwd", ["B4b dq", "B4b dk", "B4b dv"], bwd(q, k, v, do),
                    pa.reference_pair_attention_backward(q, k, v, do, heads, t))
            if t_pad == t:
                times[pairs] = dict(
                    fwd=cuda_ms(lambda: pa._launch_forward(q, k, v, heads, t), 20),
                    bwd=cuda_ms(lambda: bwd(q, k, v, do), 20),
                    plain_fwd=cuda_ms(lambda: pa.reference_pair_attention_forward(
                        q, k, v, heads, t), 3),
                    plain_bwd=cuda_ms(lambda: pa.reference_pair_attention_backward(
                        q, k, v, do, heads, t), 3))
    # yardstick: SDPA with the key mask on the same strided (P, heads, T, dh)
    # views; the forward at the eval shape, the backward at the train shape
    lib_fwd = sdpa_ms(gen, 16384, t, d, heads, backward=False)
    lib_bwd = sdpa_ms(gen, 12288, t, d, heads, backward=True)

    out = []
    # B4a: q, k, v in, o out; QK^T and PV.  B4b: q, k, v, do in, dq, dk,
    # dv out; QK^T again, dP, dV, dQ, dK
    for name, key, line, tensors, products, pairs, lib_ms in (
            ("pair_attention", "fwd", 156, 4, 2, 16384, lib_fwd),
            ("pair_attention_backward", "bwd", 176, 7, 5, 12288, lib_bwd)):
        for p_ in sorted(times):
            nbytes = tensors * p_ * t * d * 2
            t_ops = 2 * products * p_ * heads * t * t * dh / PEAK_BF16 * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            print(f"  {name} at {p_} pairs: kernel {times[p_][key]:.3f} ms, plain "
                  f"{times[p_]['plain_' + key]:.3f} ms; {nbytes / 1e9:.3f} GB -> "
                  f"bound {max(t_ops, t_bytes):.3f} ms")
            if p_ == pairs:
                row = dict(name=name, route="cuda",
                           source="veto_tpu_torch/csrc/pair_attention.cu",
                           replaces=f"veto_tpu/ops/pair_attention.py:{line}",
                           max_abs_err=errs[key], ms=times[p_][key],
                           plain_ms=times[p_]["plain_" + key],
                           bound_ms=max(t_ops, t_bytes),
                           bound_by="operations" if t_ops >= t_bytes else "bytes",
                           library_ms=lib_ms)
        out.append(row)
    print(f"  SDPA with the key mask: forward {lib_fwd:.3f} ms at 16384 pairs, "
          f"backward {lib_bwd:.3f} ms at 12288 pairs")
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
                      [f"solver.max_iter={steps}", *opts])
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
        counts.append(read_counters(reset=True))
        print(f"  {line}  launches {json.dumps(counts[-1])}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read_counters(reset=True)
    state, history = train(cfg, model=model, log=log)
    peak = torch.cuda.max_memory_allocated()
    total = {k: sum(c[k] for c in counts) for k in per_step}
    ms = 1e3 * float(np.mean([r["seconds"] for r in history[1:]]))
    print(f"  [{what}] after warm-up {ms:.1f} ms per step "
          f"({[round(1e3 * r['seconds'], 1) for r in history]}); peak memory "
          f"{peak / 2 ** 30:.2f} GiB")
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


def phase_train_grads(state, opts=(), what="main path"):
    """One step's gradients through the kernels against the same step
    through the plain versions, on the card, from the trained state."""
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.engine.train import forward_backward, sample_pairs
    from veto_tpu_torch.ops import cuda_lib
    from veto_tpu_torch.tools.relation_train_net import synthetic_train_dataset

    cfg = load_config(os.path.join(ROOT, "configs", "veto_vg_predcls.yaml"),
                      list(opts))
    bsz = cfg.solver.ims_per_batch
    batch, _ = next(synthetic_train_dataset(cfg).batches(bsz, cfg.data.max_boxes))
    b = batch.to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    samples = sample_pairs(b, gen, cfg.relation.batch_size_per_image,
                           cfg.relation.positive_fraction)
    print(f"[train grads, {what}] one step's gradients, kernels vs plain: {bsz} images, "
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
    # The floor: two kernel runs differ only where the ROIAlign backward's
    # atomics added in another order (the last f32 bits of the depth map's
    # gradient).  Back through the depth ResNet-18 in bf16 those bits grow
    # to a few % in its first layers' gradients, whose sums over every
    # pixel nearly cancel.  Kernels vs plain versions add the encoder's
    # bf16 rounding flips on top.  Each tensor is held to 10% (L2) and 25%
    # (largest element) of its plain version; a dropped or misplaced term
    # is off by about 100%.
    floor = compare(again, got)[0]
    print(f"  two kernel runs: worst |err| / |ref| {floor[0]:.3e} ({floor[2]})")
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
