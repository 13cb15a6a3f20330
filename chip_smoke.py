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
   its bound (bytes).  Then VGG-16's single 512-channel level at 1/16 (8 x
   50 x 84 bf16): B3 at P = 8 and 7 and B3-bwd (two runs bit-equal, its
   tile rows 2 in C and Python) against their plain versions, the
   forward's device ms against its bound.
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
    The reference detector also carries a box head (fc6 in the reference's
    NCHW order): imported into an SGCls model with ``fold_bn`` false and
    true, every tensor equals the reference's (fc6 permuted to NHWC) and
    the box logits equal the unpermuted fc6 on the NCHW flatten of the same
    pooled map; the PredCls models report the box head as skipped.
14. SGCls at full width (``configs/veto_vg_sgcls.yaml``): ``evaluate`` over
    3 batches of 8 images (B1 6, B3 3 per batch: the box head's own 7x7
    pool), one batch's ``rel_logits`` and ``predict_logits`` against the plain
    versions and the card's ``pred_labels`` bit-equal to
    ``obj_prediction_nms`` on the CPU on the card's logits; ``train`` for 5
    steps (B1, B2a, B2b 6, B3 3, B3-bwd 1 per step; finite ``rel_loss`` and
    ``obj_loss``, every trainable tensor changed, the detector and its box
    head bit-unchanged) and one step's gradients against the plain
    versions, two kernel runs bit-equal; the box head's and
    ``obj_prediction_nms``'s device ms and the NMS's launches per batch
    (it must not synchronise); one eval batch of ``configs/gqa_sgcls.yaml``.
15. SGDet at full width (``configs/veto_vg_sgdet.yaml``, nothing cut).
    Kernel N1 (``csrc/nms.cu``: the IoU bitmask, then the greedy scan)
    against the plain blockwise walk on the same sorted problems: the RPN's
    8 x 5 x 6000 (boxes decoded from the real anchors, bf16-quantised
    scores), the box head's 8 x 150 x 1000 per-class walks, ``max_outputs``
    reached early, duplicates, all boxes identical, all inactive, N = 1,
    N = 100 and IoU exactly at the threshold; keep bits bit-equal, two runs
    bit-equal, the scan's shared memory in C against its Python mirror,
    ``topk_first`` on pure ties on the card; both kernels' device ms
    against their bounds, the plain walk's ms.  The frozen
    ``box_predictor.cls_score`` is drawn with the first σ that leaves 40
    detections an image (the config's own 0.01 first).  ``evaluate`` over 3
    batches of 8 (B1 6, B3 3, N1 mask 2, N1 scan 2 a batch, every other
    kernel 0); one batch's proposals and detections through the kernels
    bit-equal to the plain versions' on the same inputs, ``rel_logits`` on
    the same detections at phase 5's tolerances, and no synchronisation
    inside ``detect`` or the post-processing
    (``torch.cuda.set_sync_debug_mode("error")``); ``detect``'s stage times;
    ``train`` for 5 steps of 12 images whose GT boxes and labels are 20
    detections of one earlier ``detect`` of the same images, with seeded
    relations among them (B1, B2a, B2b 6, B3 3, B3-bwd 1, N1 mask 2, N1
    scan 2 a step, the validation of step 4's two batches on top; finite
    ``rel_loss`` and ``obj_loss``, every trainable tensor changed, the
    detector, RPN and box head bit-unchanged, foreground pairs printed) and
    one step's gradients against the plain versions, two kernel runs
    bit-equal; one eval batch of ``configs/gqa_sgdet.yaml``.
16. MEET at full width from seeded weights, nothing cut
    (``configs/veto_meet_vg_predcls.yaml``: the VETO trunk embedding the hard
    labels, 5 f32 group heads of VG's divide4): ``evaluate`` over 2 batches
    of 8 (B1 6, B3 2 a batch, every other kernel 0); one batch's group
    logits through the kernels against the plain versions at phase 5's
    tolerances; the card's post-processing (each group's best predicate of
    each pair, 10,240 candidates an image ranked by a stable sort) against
    the same on the CPU on the card's logits: the same surviving
    candidates, probabilities within 1e-6, the ranking in order up to
    ties of 1e-6, R@K and mR@K equal; the host's ``accumulate_eval``
    seconds a batch; with ``ensemble.expert_group`` (15 heads) one batch
    each with voting C and U, checked the same way; ``train`` for 3 steps
    of 12 (B1, B2a, B2b 6, B3 2, B3-bwd 1 a step; every group loss finite,
    every trainable tensor changed, the detector bit-unchanged) and one
    step's gradients on one routing draw against the plain versions, two
    kernel runs bit-equal; SGDet MEET (``veto_vg_sgdet.yaml`` with
    ``VETOPredictor_MEET`` and ``ensemble.enabled``): one eval batch of 8
    (B1 6, B3 3, N1 mask 2, scan 2) and one train step of 12; one eval
    batch of ``configs/gqa_meet_predcls.yaml`` (groups 5, 10, 20, 65).
17. Detector pretraining at full width (``configs/veto_vg_sgdet.yaml``
    with ``solver.optimizer=sgd``, ``solver.schedule=WarmupMultiStepLR``;
    the model built with ``train_detector=True``: the ResNeXt-101 body,
    FPN, RPN and box head trained, nothing frozen): 5 steps of 12
    VG-shaped images through ``detector_pretrain_net.train`` (checkpoint at
    3, validation at 4) with exact launches at every step (B3 1, B3-bwd 1,
    N1 mask 1, scan 1, every other kernel 0) and in all (the validation's
    two batches: B3 1, N1 2 + 2 each), finite losses, every detector tensor
    changed; ``detector_pretest_net.evaluate`` restoring step 5 into a
    fresh model (every tensor equal, the same detections); the checkpoint's
    size, save and restore seconds; one step's gradients through the
    kernels (two runs, side by side, and whether they are bit-equal)
    against the plain versions on the same draws, at phase 10's
    tolerances; B3 and B3-bwd alone on that step's own box pool (12 x 512
    rois on P2-P5, the sampler's empty slots included) against their plain
    versions, B3-bwd two runs bit-equal, device ms against the bounds; one
    eval batch of 8 through ``detect`` and through the test-time
    augmentation (flip, scale 0.75), timed, its launches exact, its
    proposals and merged detections bit-equal to the plain walks' and its
    box pools against the plain pool.
18. The detector's other data and heads at full width.  (a) Pretraining
    with ``model.mask_on`` and ``model.keypoint_on``: 3 steps of 12
    VG-shaped images with each box's mask and 17 keypoints (the masks
    uint8 through the loader's resize and the feeder) through
    ``detector_pretrain_net.train``, exact launches (B3 3, B3-bwd 3: the
    box pool and the two heads' 14x14 pools; N1 1 + 1), ``loss_mask`` and
    ``loss_kp`` finite and positive, every head tensor changed; one step's
    gradients against the plain versions; B3 and B3-bwd alone on that
    step's own mask pool (12 x 64 rois at P = 14) against their plain
    versions, B3-bwd two runs bit-equal, device ms against the bounds.
    (b) 3 PredCls relation steps with ``model.attribute_on`` on VG-shaped
    images with attribute lists (B3 3 a step: the attribute head's 7x7
    pool), ``attribute_loss`` positive, ``att_score`` changed, the detector
    and its box head bit-unchanged.  (c) A COCO instances JSON and
    ``VOC2007`` / ``VOC2012`` devkits written at VG's image sizes, routed by
    ``build_dataset`` (``coco_2017``; ``VOC2007+VOC2012`` concatenated), the
    pixels seeded in memory (no PIL on the card's machine): 2 pretraining
    steps on each, exact launches; the VOC evaluator on one val batch's
    detections (seeded weights).
19. The legacy relation head at full width (``relation.predictor`` =
    ``MotifPredictor``, ``VCTreePredictor``, ``TransformerPredictor``,
    ``TransLikePredictor``; ``context_hidden_dim`` 512,
    ``context_pooling_dim`` 4096, bf16, the frozen R-101 body shared by
    the builds).  Each of the four in PredCls: one eval batch of 8 (2048
    pairs an image) through ``evaluate`` with exact launches (B3 2: the
    boxes' 7x7 pool into the relation box MLP and the union boxes' 7x7
    pool; B1 0, B3-bwd 0, every other kernel 0), its relation logits
    through the kernels against the plain versions at phase 5's tolerances
    (VCTree: the count of forest nodes that differ between the two runs,
    then the logits with the plain run's forest given to both), the
    context's ms (VCTree: the tree build's and one TreeLSTM pass's), the
    eval forward's busy share; 2 train steps of 12 through ``train`` (B3 2
    a step, no B3-bwd: the body is frozen and no depth is read; finite
    losses, ``binary_loss`` for VCTree, every trainable tensor changed,
    every trainable BatchNorm's statistics updated, the detector
    bit-unchanged) and one step's gradients against the plain versions, in
    f32 (in bf16 from seeded weights the legacy steps are chaotic: a
    rounding flip of a pooled feature moves an attention layer's gradients
    by tens of %).  Motifs and VCTree in SGCls (B3 3) and SGDet (B3 3, N1 mask 2, scan 2;
    the train step on GT from detections): one eval batch and one train
    step each.  ``MotifPredictor_MEET`` with ``ensemble.enabled``: one eval
    batch, its group logits against the plain versions, one train step.
    B3 alone on the eval batch's 16,384 union rois at 7x7 against its
    plain version, device ms against its bound (bytes).
20. The zoo's VGG-16 body and message-passing predictors at full width
    (``phase_zoo``).  ``configs/vgg_vg_predcls.yaml`` (the single 512-channel
    level at 1/16, every anchor size on one stride-16 grid): 2 eval batches
    of 8 (B1 6, B3 2 a batch) with one batch's logits against the plain
    versions, 3 train steps of 12 (B1, B2a, B2b 6, B3 2, B3-bwd 1 a step)
    and one step's gradients against the plain versions; one SGDet eval
    batch of the VGG detector (B1 6, B3 3, N1 2 + 2) whose proposals and
    detections through N1 are bit-equal to the plain walk's, and N1 alone
    on its RPN walk (8 x 6000 on one level) against its bound.  Then IMP,
    BGNN with ``relation.rel_aware=true``, GPSNet and MSDN on the frozen
    R-101 body (``context_hidden_dim`` 512, ``context_pooling_dim`` 4096,
    bf16): each one PredCls eval batch (B3 2) with its logits against the
    plain versions (BGNN: its relness logits too; each run's message
    filter recomputed from the scores it saw; the pairs the two runs'
    filters tell apart counted and each held within the runs' score
    difference of the threshold; the relation logits on the plain run's
    filter) and its busy share, one train step (B3 2), and one step's f32
    gradients against the
    plain versions with two kernel runs bit-equal (cuDNN in its
    deterministic mode); IMP and BGNN also one SGCls (B3 3) and one SGDet
    (B3 3, N1 2 + 2) eval batch and train step.  The phase prints its
    seconds and its numbers.
21. One JSON line ``{"kernels": [...]}`` (all nine kernels, N1 last;
    ``launches`` from the main path's training run, or the path that runs
    each, with the counted runs of phases 19 and 20 added) and, last,
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
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PREDCLS = "veto_vg_predcls.yaml"  # the main path's configuration
SGCLS = "veto_vg_sgcls.yaml"
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
def body_name(cfg) -> str:
    """The detector body of ``cfg``, as the printouts name it."""
    m = cfg.model
    if m.backbone == "VGG-16":
        return "VGG-16 (one 512-channel level at 1/16)"
    return (f"{m.backbone} {m.resnet_groups}x{m.resnet_width_per_group}d "
            f"blocks {tuple(m.stage_blocks)}")


def roi_launches(cfg) -> int:
    """B3 launches of one forward: the relation pool and the depth pool,
    and in SGCls the box head's own 7x7 pool."""
    return 3 if cfg.relation.mode == "sgcls" else 2


def phase_main_path(opts=(), n_batches=3, encoder="fused_encoder_layer",
                    config=PREDCLS):
    """The eval entry point's ``evaluate`` over ``n_batches`` full-width
    batches; per batch exactly ``layers`` launches of the ``encoder``
    kernel, 2 of ROIAlign (3 in SGCls) and none of any other kernel.
    Returns the model, the config, the ms per batch after warm-up and the
    launches counted."""
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.models.sgg import build_model
    from veto_tpu_torch.tools.relation_test_net import (
        evaluate, synthetic_eval_dataset,
    )

    cfg = load_config(os.path.join(ROOT, "configs", config), list(opts))
    model = build_model(cfg)  # cuda, seeded weights, eval mode
    layers = cfg.veto.enc_layers
    print(f"[main{' ' + ' '.join(opts) if opts else ''}] VETO "
          f"{cfg.relation.mode} ({config}, {cfg.model.num_obj_classes} object / "
          f"{cfg.relation.num_classes} predicate classes), "
          f"{body_name(cfg)}, trunk {cfg.veto.t_input_dim} "
          f"x {layers} layers ({cfg.veto.encoder_impl}), {cfg.dtype}; "
          f"{n_batches} batches of {cfg.test.ims_per_batch}, "
          f"{cfg.data.max_boxes} boxes, {cfg.relation.max_proposal_pairs} pairs")
    want = expected(**{encoder: layers * n_batches,
                       "multilevel_roi_align": roi_launches(cfg) * n_batches})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read_counters(reset=True)
    agg, seconds = evaluate(cfg, model=model, max_batches=n_batches,
                            log=lambda s: print("  " + s))
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    ms = 1e3 * float(np.mean(seconds[1:] or seconds))
    print(f"  launches {json.dumps(launches)}; after warm-up "
          f"{ms:.1f} ms per batch "
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
    return model, cfg, ms, launches


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


def eval_forward(model, cfg, b, forest=None):
    """One eval batch's forward (an ``SGGForward``), the model in eval mode;
    VCTree on ``forest`` when one is given."""
    from veto_tpu_torch.models.relation.sampling import prepare_test_pairs

    model.eval()
    with torch.inference_mode():
        pair_idx, pair_mask = prepare_test_pairs(
            b.box_mask, b.box_mask.float(), cfg.relation.max_proposal_pairs)
        return model(b.images, b.depth, b.boxes, b.box_mask, b.labels,
                     b.obj_logits, pair_idx, pair_mask, forest=forest)


def eval_logits(model, cfg, b):
    """One eval batch's ``rel_logits``, the model in eval mode."""
    return eval_forward(model, cfg, b).rel_logits


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
    "nms_mask": ("nms", "MASK_LAUNCHES"),                               # N1
    "nms_scan": ("nms", "SCAN_LAUNCHES"),                               # N1
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


def add_launches(total, *counts):
    """Adds each of ``counts`` (launches by kernel, as read) into ``total``;
    returns ``total``."""
    for c in counts:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


LAST_TRAIN = {}  # the main path's training run: from-memory step times
TRAIN_MS = {}  # each training path's (ms a step after warm-up, peak bytes)


def loss_keys(cfg):
    """The losses a step of ``cfg`` records, ``loss`` first: ``rel_loss``, or
    with MEET each (expert, group) head's, and outside PredCls
    ``obj_loss``."""
    from veto_tpu_torch.tools.relation_train_net import build_meet_config

    meet = build_meet_config(cfg)
    rel = ([f"group_{k}{e + 1}_CE_loss" for e in range(meet.experts_per_group)
            for k in range(len(meet.group_sizes))] if meet else ["rel_loss"])
    return ["loss", *rel] + (["obj_loss"] if cfg.relation.mode != "predcls" else [])


def frozen_state(model):
    """Copies of the frozen detector's tensors (the body, and in SGCls the
    box head)."""
    from veto_tpu_torch.solver.optim import FROZEN_DETECTOR

    return {k: v.clone() for k, v in model.state_dict().items()
            if k.startswith(FROZEN_DETECTOR)}


def phase_train(steps=5, opts=(), encoder=("fused_encoder_layer",
                                           "encoder_ffn_bwd", "encoder_att_bwd"),
                what="main path", config=PREDCLS):
    """A training path: ``relation_train_net.train`` for a few full-width
    steps from seeded weights, with the launch counts read after every step:
    exactly ``layers`` launches of each ``encoder`` kernel, 2 of ROIAlign
    (3 in SGCls), 1 of its backward and none of any other kernel."""
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.models.sgg import build_model
    from veto_tpu_torch.tools.relation_train_net import train

    cfg = load_config(os.path.join(ROOT, "configs", config),
                      [f"solver.max_iter={steps}", f"output_dir={scratch_dir()}",
                       *opts])
    model = build_model(cfg)  # cuda, seeded weights
    layers = cfg.veto.enc_layers
    per_step = expected(**{k: layers for k in encoder},
                        multilevel_roi_align=roi_launches(cfg),
                        roi_align_backward=1)
    print(f"[train, {what}] VETO {cfg.relation.mode} training ({config}), "
          f"{body_name(cfg)} frozen, "
          f"depth ResNet-18 + trunk {cfg.veto.t_input_dim} x {layers} layers "
          f"({cfg.veto.encoder_impl}) trained, {cfg.dtype}; {steps} steps of "
          f"{cfg.solver.ims_per_batch} "
          f"images, {cfg.relation.batch_size_per_image} pairs an image")
    frozen = frozen_state(model)
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
    TRAIN_MS[what] = (ms, peak)
    if len(history) != steps:
        raise AssertionError(f"{len(history)} steps ran, not {steps}")
    for i, c in enumerate(counts):
        if c != per_step:
            raise AssertionError(f"step {i}: launches {c}, want {per_step}")
    losses = loss_keys(cfg) + ["grad_norm"]
    if not all(np.isfinite(r[k]) for r in history for k in losses):
        raise AssertionError(f"non-finite {losses}: {history}")
    if len(losses) > 3:
        print(f"  {', '.join(f'{k} {round(history[-1][k], 4)}' for k in losses[1:-1])} "
              "(the last step)")
    for k, v in frozen_state(model).items():
        if not torch.equal(v, frozen[k]):
            raise AssertionError(f"frozen detector changed: {k}")
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


# gradients that are 0 analytically (by their name's end): a bias under a
# BatchNorm with batch statistics (the legacy heads' position, box and
# overlap nets; not the relness pre-classifier's pos_fc1, which no
# BatchNorm follows) and the attention keys' bias (the softmax ignores a
# shift of the keys)
ANALYTIC_ZERO = ("context_layer.pos_fc1.bias", "pairwise_feature_extractor.pos_fc1.bias",
                 "box_fc.bias", "overlap_fc.bias", "w_ks.bias")


def phase_train_grads(state, opts=(), what="main path", b=None, config=PREDCLS,
                      exact_floor=False, samples=None):
    """One step's gradients through the kernels against the same step
    through the plain versions, on the card, from the trained state; on
    the synthetic train split's first batch unless a device batch ``b`` is
    given, on its sampled pairs unless ``samples`` are given (SGDet's: the
    detections and their pairs), with MEET on one routing draw.
    ``exact_floor``: two kernel runs of the step must give bit-equal
    gradients."""
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.engine.train import forward_backward, sample_pairs
    from veto_tpu_torch.ops import cuda_lib
    from veto_tpu_torch.tools.relation_train_net import synthetic_train_dataset

    cfg = load_config(os.path.join(ROOT, "configs", config), list(opts))
    if b is None:
        bsz = cfg.solver.ims_per_batch
        batch, _ = next(synthetic_train_dataset(cfg).batches(bsz, cfg.data.max_boxes))
        b = batch.to(DEVICE)
    bsz = b.images.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    if samples is None:
        samples = sample_pairs(b, gen, cfg.relation.batch_size_per_image,
                               cfg.relation.positive_fraction)
    print(f"[train grads, {what}] one step's gradients, kernels vs plain: {bsz} "
          f"images of {tuple(b.images.shape[1:3])}, "
          f"{cfg.relation.batch_size_per_image} pairs an image")
    params = [(n, p) for n, p in state.model.named_parameters() if p.requires_grad]
    member = None
    if state.meet is not None:  # one routing draw for every run of the step
        from veto_tpu_torch.models.relation.predictor_meet import meet_route

        pairs = getattr(samples, "pairs", samples)
        member = meet_route(torch.Generator(device=DEVICE).manual_seed(2),
                            pairs.labels, pairs.mask, state.meet.incre_idx,
                            state.meet.sample_rate)

    # VCTree: every run of the step on one forest, the plain run's (the
    # greedy build is an argmax that a last-bit difference can flip)
    from veto_tpu_torch.models.relation.legacy import VCTreePredictor

    tree = isinstance(state.model.relation, VCTreePredictor)
    forest = None

    def grads():
        loss = forward_backward(state, b, samples, member, forest=forest)["loss"]
        return loss, {n: p.grad.detach().clone() for n, p in params}

    if tree:
        seen = {}
        hook = state.model.relation.register_forward_hook(
            lambda mod, inp, out: seen.__setitem__("forest", out.forest))
        try:
            with cuda_lib.plain_kernels():
                grads()
        finally:
            hook.remove()
        forest = seen["forest"]

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
    if tree:
        print("  (VCTree: every run on the plain run's forest)")
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
    elif exact_floor:
        raise AssertionError(f"two kernel runs differ in {varies}")
    else:
        print(f"  two kernel runs: worst |err| / |ref| {floor[0]:.3e} ({floor[2]}); "
              f"{len(varies)} of {len(params)} tensors vary, the one nearest the "
              f"loss in parameter order {varies[0]} (|err| / |ref| "
              f"{next(r[0] for r in compare(again, got) if r[2] == varies[0]):.3e})")
    # a gradient that is 0 analytically holds only rounding, in both runs:
    # held to 1e-2 of the step's largest |g| instead
    top = max(float(ref[n].abs().max()) for n, _ in params)
    zero = [n for n, _ in params if n.endswith(ANALYTIC_ZERO)]
    if zero:
        worst = max(float(t[n].abs().max()) for t in (got, ref) for n in zero)
        print(f"  {len(zero)} gradients 0 analytically ({', '.join(zero)}): "
              f"largest |g| {worst:.3e}, of the step's largest {top:.3e}")
        if worst > 1e-2 * top:
            raise AssertionError(f"analytically zero gradients reach {worst}")
    rows = [r for r in compare(got, ref) if r[2] not in zero]
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
    from ``seed``.  With ``attributes`` each box also carries up to 4 of
    VG's 201 attribute ids (a third of the boxes none); with ``instances``
    its instance mask (the ellipse inscribed in the box, uint8) and 17
    keypoints at fixed fractions of the box, about a third of them not
    visible; both drawn from a second seed, so the rest stays as without
    them.  It stands in for the VG files, which the card's machine does
    not have (nor h5py or PIL to read them)."""

    def __init__(self, portrait, seed, num_obj=151, num_rel=51, max_boxes=80,
                 attributes=False, instances=False):
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
        extra = np.random.RandomState(seed + 7919)
        self._attributes = self._visible = None
        if attributes:
            self._attributes = []
            for b in self._boxes:
                att = np.zeros((len(b), 10), np.int64)
                for j in np.nonzero(extra.rand(len(b)) > 1 / 3)[0]:
                    m = int(extra.randint(1, 5))
                    att[j, :m] = extra.randint(1, 201, m)
                self._attributes.append(att)
        if instances:
            self._visible = [(extra.rand(len(b), 17) > 1 / 3) * 2.0 for b in self._boxes]

    def _instances(self, index):
        """Each box's ellipse mask (n, h, w) uint8 and 17 keypoints (n, 17, 3)."""
        boxes, info = self._boxes[index], self.img_info[index]
        masks = np.zeros((len(boxes), info["height"], info["width"]), np.uint8)
        for j, (xa, ya, xb, yb) in enumerate(boxes):
            y0, x0 = int(ya), int(xa)
            yy, xx = np.mgrid[y0:int(yb) + 1, x0:int(xb) + 1]
            rx, ry = max((xb - xa) / 2, 1.0), max((yb - ya) / 2, 1.0)
            masks[j, y0:int(yb) + 1, x0:int(xb) + 1] = (
                ((xx - (xa + xb) / 2) / rx) ** 2 + ((yy - (ya + yb) / 2) / ry) ** 2 <= 1.0)
        fr = (np.arange(17, dtype=np.float32) + 0.5) / 17
        kps = np.stack([boxes[:, :1] + fr * (boxes[:, 2:3] - boxes[:, :1]),
                        boxes[:, 1:2] + fr[::-1] * (boxes[:, 3:4] - boxes[:, 1:2]),
                        self._visible[index]], -1).astype(np.float32)
        return masks, kps

    def __len__(self):
        return len(self.idx_list)

    def get_groundtruth(self, index, inner_idx=True):
        index = index if inner_idx else self.idx_list[index]
        info, rels = self.img_info[index], self.relationships[index]
        n = len(self._boxes[index])
        rel_matrix = np.zeros((n, n), np.int64)
        rel_matrix[rels[:, 0], rels[:, 1]] = rels[:, 2]
        rec = {"boxes": self._boxes[index].copy(),
               "labels": self.gt_classes[index].astype(np.int32),
               "rel_matrix": rel_matrix, "rel_tuples": rels,
               "size": np.array([info["width"], info["height"]], np.int32),
               "image_id": info["image_id"]}
        if self._attributes is not None:
            rec["attributes"] = self._attributes[index]
        if self._visible is not None:
            rec["masks"], rec["keypoints"] = self._instances(index)
        return rec

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


def reference_detector(body, gen, path, box_head=None):
    """A maskrcnn-benchmark detector state dict at the shapes of the unfolded
    port body ``body`` (seeded: LeCun-normal convs, BN weight in [0.5, 1],
    running var in [0.5, 1.5], small biases and means) and, for ``box_head``
    = (P, MLP width, classes), a box head whose fc6 eats the reference's
    NCHW flatten of a P x P pool; saved with ``torch.save`` to ``path``.
    Returns it as numpy arrays."""
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
    if box_head is not None:
        p, mlp, classes = box_head
        c = body.fpn.fpn_layer1.out_channels
        for name, shape in (("feature_extractor.fc6", (mlp, c * p * p)),
                            ("feature_extractor.fc7", (mlp, mlp)),
                            ("predictor.cls_score", (classes, mlp)),
                            ("predictor.bbox_pred", (4 * classes, mlp))):
            sd[f"roi_heads.box.{name}.weight"] = (
                torch.randn(shape, generator=gen) * shape[1] ** -0.5)
            sd[f"roi_heads.box.{name}.bias"] = 0.1 * torch.randn(shape[0],
                                                                 generator=gen)
    torch.save({"model": sd}, path)
    return {k: v.numpy() for k, v in sd.items()}


def check_box_head_import(path, ref, fold_bn, b):
    """The reference detector at ``path`` imported into an SGCls model
    (``fold_bn`` as given): the body and all eight box-head tensors load,
    fc6 is the reference's with its input axis permuted from the NCHW
    flatten to NHWC, and on the pooled map of batch ``b``'s boxes the box
    logits equal the reference's computation on the NCHW flatten: in f32
    to f32 rounding, and the model's own bf16 head at the main path's bf16
    tolerance."""
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.models.sgg import build_model
    from veto_tpu_torch.tools import relation_train_net as rtn

    c = load_config(os.path.join(ROOT, "configs", SGCLS),
                    [f"model.fold_bn={fold_bn}",
                     f"model.pretrained_detector_ckpt={path}"])
    m = build_model(c)
    lines = []
    loaded, skipped = rtn.load_pretrained_detector(c, m, lines.append)
    n = check_detector_import(m, ref, fold_bn)
    if len(loaded) != n + 8 or skipped:
        raise AssertionError(f"SGCls fold_bn={fold_bn}: {len(loaded)} loaded of "
                             f"{n} + 8, skipped {skipped[:4]}")
    p, ch = c.model.box_pooler_resolution, c.model.fpn_channels
    state = m.state_dict()
    for ours, theirs in (("box_extractor.fc6", "feature_extractor.fc6"),
                         ("box_extractor.fc7", "feature_extractor.fc7"),
                         ("box_predictor.cls_score", "predictor.cls_score"),
                         ("box_predictor.bbox_pred", "predictor.bbox_pred")):
        for leaf in ("weight", "bias"):
            want = ref[f"roi_heads.box.{theirs}.{leaf}"]
            if ours.endswith("fc6") and leaf == "weight":
                want = want.reshape(len(want), ch, p, p).transpose(0, 2, 3, 1)
                want = want.reshape(len(want), -1)
            if not np.array_equal(state[f"{ours}.{leaf}"].cpu().numpy(), want):
                raise AssertionError(f"{ours}.{leaf} is not the imported tensor")
    w = {k[len("roi_heads.box."):]: torch.from_numpy(v).to(DEVICE)
         for k, v in ref.items() if k.startswith("roi_heads.box.")}
    with torch.no_grad():
        feats = m.extract_features(b.images)
        pooled = m._pool_boxes(feats, b.boxes, p)
        got = m._box_logits(feats, b.boxes)
        del feats
        ours = pooled.flatten(2)  # the port's NHWC flatten, its fc6
        nchw = pooled.permute(0, 1, 4, 2, 3).flatten(2)  # the reference's
        x, y = ours, nchw
        for name, mod in (("fc6", m.box_extractor.fc6), ("fc7", m.box_extractor.fc7)):
            x = torch.relu(x @ mod.weight.T + mod.bias)
            y = torch.relu(y @ w[f"feature_extractor.{name}.weight"].T
                           + w[f"feature_extractor.{name}.bias"])
        x = m.box_predictor.cls_score(x)
        ref_logits = (y @ w["predictor.cls_score.weight"].T
                      + w["predictor.cls_score.bias"])
    print(f"  SGCls detector import fold_bn={fold_bn}: {lines[0]}; the body's "
          f"{n} tensors and the box head's 8 equal the reference under the mapping")
    scale = float(ref_logits.abs().max())
    check_close(f"box logits fold_bn={fold_bn}, f32 NHWC flatten vs reference NCHW",
                x, ref_logits, atol=1e-4 * scale, rtol=0.0)
    check_close(f"box logits fold_bn={fold_bn}, the model's bf16 head vs reference "
                "NCHW f32", got, ref_logits, atol=0.05 * scale, rtol=0.0,
                mean_tol=0.01 * float(ref_logits.abs().mean()))
    del m
    release()


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
    oa, ob = a.optimizer.inner.state_dict()["state"], b.optimizer.inner.state_dict()["state"]
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
    pinned = {f: torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
              for f, a in host.fields().items()}
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
    ref_sd = reference_detector(unfolded, torch.Generator().manual_seed(3), path,
                                box_head=(cfg.model.box_pooler_resolution,
                                          cfg.model.box_mlp_head_dim,
                                          cfg.model.num_obj_classes))
    del unfolded
    box_names = {k for k in ref_sd if k.startswith("roi_heads.box.")}
    b_eval = val_batches[0][0].to(DEVICE)
    logits, pyramids = {}, {}
    for fold in (False, True):
        c = load_config(yaml, [f"model.fold_bn={fold}",
                               f"model.pretrained_detector_ckpt={path}"])
        m = build_model(c)
        lines = []
        loaded, skipped = rtn.load_pretrained_detector(c, m, lines.append)
        n = check_detector_import(m, ref_sd, fold)
        # the PredCls model has no box head: its tensors are reported
        if len(loaded) != n or len(skipped) != len(box_names) or any(
                not name.startswith(("box_extractor.", "box_predictor."))
                for _, name in skipped):
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
        check_box_head_import(path, ref_sd, fold, b_eval)
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


# ------------------------------------------------------------------ phase 14
def sgcls_outputs(model, cfg, b):
    """One eval batch's forward (``rel_logits``, ``predict_logits``,
    ``pred_labels``), the model in eval mode."""
    from veto_tpu_torch.models.relation.sampling import prepare_test_pairs

    model.eval()
    with torch.inference_mode():
        pair_idx, pair_mask = prepare_test_pairs(
            b.box_mask, b.box_mask.float(), cfg.relation.max_proposal_pairs)
        return model(b.images, b.depth, b.boxes, b.box_mask, b.labels,
                     b.obj_logits, pair_idx, pair_mask)


def kernel_count(fn) -> int:
    """Device launches (kernels, copies, fills) of one call of ``fn``, by
    ``torch.profiler``; a trace that holds none is taken again, up to
    three times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and (getattr(e, "self_device_time_total", 0) or 0) > 0)
        if n:
            return n
    raise AssertionError("the trace holds no launch")


def phase_sgcls():
    """SGCls at full width from seeded weights (``configs/veto_vg_sgcls.yaml``):
    ``evaluate`` over 3 batches of 8 images (B1 6, B3 3 per batch: the box
    head's own 7x7 pool beside the relation and depth pools); one batch's
    ``rel_logits`` (in ``phase_main_path``) and ``predict_logits`` against
    the plain versions and
    the card's ``pred_labels`` bit-equal to ``obj_prediction_nms`` run on
    the CPU on the card's own logits; ``train`` for 5 steps (B1, B2a, B2b
    6, B3 3, B3-bwd 1 per step; finite rel_loss and obj_loss, every
    trainable tensor changed, the detector and box head bit-unchanged) and
    one step's gradients against the plain versions with two kernel runs
    bit-equal; the device ms of the box head and of ``obj_prediction_nms``
    (with its launches per batch, and no synchronisation inside it); one
    eval batch of ``configs/gqa_sgcls.yaml``."""
    from veto_tpu_torch.ops import cuda_lib
    from veto_tpu_torch.ops.nms import obj_prediction_nms
    from veto_tpu_torch.ops.roi_align_windowed import fpn_level_assignment
    from veto_tpu_torch.tools.relation_test_net import synthetic_eval_dataset
    from veto_tpu_torch.utils.checkpoint import CheckpointManager

    # 8 images a batch, the main path's eval batch (the SGCls configs leave
    # test.ims_per_batch at its default 1)
    eval8 = ("test.ims_per_batch=8",)
    model, cfg, eval_ms, _ = phase_main_path(eval8, config=SGCLS)
    bsz, n = cfg.test.ims_per_batch, cfg.data.max_boxes
    batch, _ = next(synthetic_eval_dataset(cfg, bsz).batches(bsz, n))
    b = batch.to(DEVICE)
    got = sgcls_outputs(model, cfg, b)
    with cuda_lib.plain_kernels():
        ref = sgcls_outputs(model, cfg, b)
    # (phase_main_path held rel_logits) bf16 through the box head's fc6/fc7
    r = ref.predict_logits
    check_close("SGCls predict_logits kernels vs plain", got.predict_logits, r,
                atol=0.05 * float(r.abs().max()), rtol=0.0,
                mean_tol=0.01 * float(r.abs().mean()))
    c = cfg.model.num_obj_classes
    boxes = b.boxes.cpu()
    cpu = obj_prediction_nms(boxes[:, :, None, :].expand(bsz, n, c, 4),
                             got.predict_logits.cpu(), 0.5, b.box_mask.cpu())
    if not torch.equal(got.pred_labels.cpu(), cpu):
        raise AssertionError("pred_labels on the card differ from "
                             "obj_prediction_nms on the CPU on the same logits")
    valid = b.box_mask
    same = float((got.pred_labels == ref.pred_labels)[valid].float().mean())
    print(f"  pred_labels on the card bit-equal to obj_prediction_nms on the CPU "
          f"on the card's logits ({int(valid.sum())} boxes, "
          f"{len(set(got.pred_labels[valid].tolist()))} labels); the plain "
          f"versions' logits give the same label to {same:.1%} of the boxes")
    del got, ref
    release()

    state, launches = phase_train(5, config=SGCLS, what="SGCls")
    phase_train_grads(state, config=SGCLS, what="SGCls", exact_floor=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt = CheckpointManager(scratch_dir()).save(state.step, state)
    save_s = time.perf_counter() - t0
    print(f"  SGCls checkpoint {os.path.getsize(ckpt) / 2 ** 20:.0f} MiB (the box "
          f"head included), saved in {save_s:.2f} s")
    del state
    release()

    with torch.no_grad():
        feats = model.extract_features(b.images)
        logits = model._box_logits(feats, b.boxes)
    p, mlp = cfg.model.box_pooler_resolution, cfg.model.box_mlp_head_dim
    rois, k = bsz * n, p * p * cfg.model.fpn_channels
    box_ms = busy_ms(lambda: model._box_logits(feats, b.boxes), 10)
    pool_ms = device_ms(lambda: model._pool_boxes(feats, b.boxes, p),
                        "roi_align_fwd_kernel", 10)
    pool_bytes = (roi_tap_bytes(feats[:4], b.boxes, fpn_level_assignment(b.boxes),
                                SCALES, p=p)
                  + rois * p * p * cfg.model.fpn_channels * 4 + b.boxes.numel() * 4)
    # the box head's least time: fc6/fc7 in bf16, cls_score in f32; its
    # f32 weights read once, the pooled map read and the logits written
    weights = sum(t.numel() for t in model.box_extractor.parameters()) + sum(
        t.numel() for t in model.box_predictor.cls_score.parameters())
    t_ops = (2 * rois * (k * mlp + mlp * mlp) / PEAK_BF16
             + 2 * rois * mlp * c / PEAK_F32)
    t_bytes = 4 * (weights + rois * k + rois * c) / PEAK_BYTES
    print(f"[SGCls stages] box head (7x7 pool + fc6/fc7 + cls_score) "
          f"{box_ms:.3f} device ms a batch of {rois} rois (bound "
          f"{1e3 * max(t_ops, t_bytes):.3f} ms by "
          f"{'operations' if t_ops >= t_bytes else 'bytes'}); its B3 pool at "
          f"P = {p} {pool_ms:.4f} device ms (bound {1e3 * pool_bytes / PEAK_BYTES:.4f} "
          f"ms by bytes, {pool_bytes / pool_ms / 1e6:.0f} GB/s)")

    def nms():
        return model._predict_labels(b.boxes, logits, b.box_mask)

    nms_ms = busy_ms(nms, 5)
    nms_wall = cuda_ms(nms, 5)
    nms_launches = kernel_count(nms)
    torch.cuda.set_sync_debug_mode("error")  # a synchronising op raises
    try:
        nms()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"  obj_prediction_nms: {nms_ms:.3f} device ms a batch, {nms_wall:.3f} ms "
          f"by CUDA events, {nms_launches} launches ({n} trips); no "
          f"synchronisation; {100 * nms_wall / eval_ms:.2f}% of the "
          f"{eval_ms:.1f} ms eval batch")
    del feats, logits, model, b
    release()
    phase_main_path(eval8, config="gqa_sgcls.yaml", n_batches=1)
    print(f"[SGCls numbers] {card()}: eval {eval_ms:.1f} ms a batch; launches "
          f"over the 5 train steps {json.dumps(launches)}")


# ------------------------------------------------------------------ phase 15
SGDET = "veto_vg_sgdet.yaml"
RPN_MAPS = ((200, 336), (100, 168), (50, 84), (25, 42), (13, 21))  # 800x1344
IOU_OPS = 15  # f32 operations of one IoU and its comparison (csrc/nms.cu)


def rpn_problems(gen, b=8, pre=6000):
    """The RPN's NMS problems at full width: per image and level of an
    800x1344 image, the top ``pre`` of bf16-quantised objectness logits over
    the real anchors, decoded (small random deltas) and clipped, sorted as
    ``nms`` sorts them → (b x 5, pre, 4) boxes, (b x 5, pre) active."""
    import torch.nn.functional as F

    from veto_tpu_torch.models.detector.rpn import _level_candidates, level_anchors
    from veto_tpu_torch.ops.nms import _NEG_INF, _sorted_problems

    anchors = level_anchors(RPN_MAPS, (32, 64, 128, 256, 512), (4, 8, 16, 32, 64),
                            (0.23232838, 0.63365731, 1.28478321, 3.15089189), DEVICE)
    sizes = torch.full((b, 2), 800.0, device=DEVICE)
    sizes[:, 0] = 1344.0
    boxes, live = [], []
    for a in anchors:
        n = a.shape[0]
        o = (2 * torch.randn((b, n), generator=gen, device=DEVICE)).bfloat16()
        r = 0.2 * torch.randn((b, n, 4), generator=gen, device=DEVICE)
        props, sc, valid = _level_candidates(o, r, a, sizes, pre, 0.0)
        pad = pre - sc.shape[1]
        boxes.append(F.pad(props, (0, 0, 0, pad)))
        live.append(F.pad(torch.where(valid, sc, _NEG_INF), (0, pad), value=_NEG_INF))
    boxes = torch.stack(boxes, 1).reshape(b * 5, pre, 4)
    sboxes, _, active = _sorted_problems(boxes, torch.stack(live, 1).reshape(b * 5, pre))
    return sboxes.contiguous(), active


def class_problems(gen, b=8, n=1000, c=150):
    """The box head's per-class problems: ``n`` proposals an image, each
    decoded per class (small deltas) and clipped, scored by a softmax over
    ``c + 1`` classes peaked enough that many pass the 0.01 threshold →
    (b x c, n, 4) boxes, (b x c, n) active, sorted."""
    from veto_tpu_torch.ops.box_ops import clip_to_image, decode_boxes
    from veto_tpu_torch.ops.nms import _NEG_INF, _sorted_problems

    xy = torch.rand((b, n, 2), generator=gen, device=DEVICE) * torch.tensor(
        [1200.0, 700.0], device=DEVICE)
    wh = 16 + 384 * torch.rand((b, n, 2), generator=gen, device=DEVICE)
    props = torch.cat([xy, xy + wh], -1)
    deltas = 0.5 * torch.randn((b, n, 4 * (c + 1)), generator=gen, device=DEVICE)
    sizes = torch.tensor([[1344.0, 800.0]] * b, device=DEVICE)
    bpc = clip_to_image(decode_boxes(deltas, props).reshape(b, n * (c + 1), 4),
                        sizes).reshape(b, n, c + 1, 4)[:, :, 1:]
    prob = torch.softmax(2 * torch.randn((b, n, c + 1), generator=gen,
                                         device=DEVICE), -1)[..., 1:]
    live = torch.where(prob > 0.01, prob, _NEG_INF).transpose(1, 2).reshape(-1, n)
    sboxes, _, active = _sorted_problems(
        bpc.transpose(1, 2).reshape(-1, n, 4), live)
    return sboxes.contiguous(), active


def nms_edge_cases(gen):
    """Small problems at the edges: duplicate boxes, all boxes identical,
    all inactive, N = 1, N = 100 (not a multiple of 64), and pairs whose IoU
    is exactly the threshold 0.5 (never suppressed: the test is strict)."""
    cases = []
    base = 100 * torch.rand((8, 4), generator=gen, device=DEVICE)
    base[:, 2:] += base[:, :2] + 5
    dup = base.repeat(8, 1)                                  # 64 boxes, 8 distinct
    cases.append(("duplicates", dup, torch.ones(64, dtype=torch.bool, device=DEVICE)))
    same = base[:1].repeat(100, 1)
    cases.append(("all identical", same, torch.ones(100, dtype=torch.bool,
                                                    device=DEVICE)))
    cases.append(("all inactive", dup, torch.zeros(64, dtype=torch.bool,
                                                   device=DEVICE)))
    cases.append(("N = 1", base[:1], torch.ones(1, dtype=torch.bool, device=DEVICE)))
    xy = 300 * torch.rand((100, 2), generator=gen, device=DEVICE)
    rnd = torch.cat([xy, xy + 10 + 60 * torch.rand((100, 2), generator=gen,
                                                   device=DEVICE)], -1)
    cases.append(("N = 100", rnd, torch.rand(100, generator=gen, device=DEVICE) > 0.1))
    # [0, 0, 9, 9] against [0, 0, 9, 19]: inter 100, union 200, IoU 0.5
    half = torch.tensor([[0, 0, 9, 9], [0, 0, 9, 19], [0, 0, 19, 19],
                         [0, 0, 9, 9]], dtype=torch.float32, device=DEVICE)
    cases.append(("IoU = threshold", half, torch.ones(4, dtype=torch.bool,
                                                      device=DEVICE)))
    return cases


def scan_bytes(keep: torch.Tensor) -> int:
    """Bytes the scan must move for these keeps: each kept row's mask words
    from its own on, the active flags read, the keep flags written."""
    g, n = keep.shape
    words = -(-n // 64)
    rows = keep.nonzero()[:, 1]
    return int((words - rows // 64).sum()) * 8 + 2 * g * n


def n1_kernel_ms(boxes, active, thr, m, iters=10):
    """Device ms of each of N1's kernels alone: CUDA events around
    ``iters`` launches of its C entry on preallocated buffers (uncounted:
    these are timing launches, not the path's)."""
    import ctypes

    from veto_tpu_torch.ops import cuda_lib
    from veto_tpu_torch.ops import nms as tn

    g, n = active.shape
    table = torch.empty((g, n, tn.mask_words(n)), dtype=torch.int64, device=DEVICE)
    keep = torch.empty((g, n), dtype=torch.bool, device=DEVICE)
    stream = torch.cuda.current_stream().cuda_stream
    lib, mask_fn = tn._entry("nms_mask", [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_float, ctypes.c_void_p,
                                          ctypes.c_void_p])
    _, scan_fn = tn._entry("nms_scan", [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_void_p])

    def mask():
        cuda_lib.check(lib, mask_fn(boxes.data_ptr(), g, n, thr, table.data_ptr(),
                                    stream), "nms_mask")

    def scan():
        cuda_lib.check(lib, scan_fn(table.data_ptr(), active.data_ptr(), g, n, m,
                                    keep.data_ptr(), stream), "nms_scan")

    # the mask first: the scan then walks the table it wrote
    mask_ms = cuda_ms(mask, iters)
    scan_ms = cuda_ms(scan, iters)
    if not torch.equal(keep, tn.greedy_keep_sorted(boxes, active, thr, m)):
        raise AssertionError("the timed launches' keeps differ from the wrapper's")
    return mask_ms, scan_ms


def n1_row(what, boxes, active, thr, m, keep):
    """N1's two kernels timed alone on these sorted problems (``keep``:
    their keep bits), against their bounds and the plain walk; printed and
    returned as the kernels line's fields."""
    from veto_tpu_torch.ops import nms as tn

    g, n = active.shape
    words = -(-n // 64)
    mask_ms, scan_ms = n1_kernel_ms(boxes, active, thr, m)
    plain = cuda_ms(lambda: tn.reference_greedy_keep(boxes, active, thr, m), 2, 1)
    t_ops = IOU_OPS * g * n * (n - 1) / 2 / PEAK_F32 * 1e3
    mask_bytes = g * n * 16 + g * words * (words + 1) // 2 * 64 * 8
    sbytes = scan_bytes(keep)
    t_bytes = (mask_bytes + sbytes) / PEAK_BYTES * 1e3
    depth = int(keep.sum(1).max())
    print(f"  {what}: mask {mask_ms:.4f} + scan {scan_ms:.4f} device ms "
          f"(bound: mask {t_ops:.4f} ms by operations, {IOU_OPS} a pair, "
          f"{mask_bytes / 1e6:.1f} MB of table; scan {sbytes / 1e6:.2f} MB, "
          f"{sbytes / PEAK_BYTES * 1e3:.4f} ms by bytes, but {depth} kept "
          f"rows one after another in its longest problem); plain walk "
          f"{plain:.2f} ms")
    return dict(ms=mask_ms + scan_ms, plain_ms=plain, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def phase_nms(gen):
    """Kernel N1 (``csrc/nms.cu``: the IoU bitmask, then the scan) against
    the plain blockwise walk on the same sorted problems: the RPN's (8 x 5
    x 6000, IoU 0.7, 1000 keeps), the box head's per-class (8 x 150 x 1000,
    IoU 0.3, 300 keeps), ``max_outputs`` reached early, and the edge cases;
    keep bits bit-equal, two runs bit-equal; the C shared-memory size
    against its Python mirror; device ms of both kernels (CUDA events
    around their launches alone) against their bounds, the plain walk's
    ms."""
    from veto_tpu_torch.ops import cuda_lib
    from veto_tpu_torch.ops import nms as tn

    print("[N1 greedy NMS] kernel vs the plain blockwise walk on the same "
          "sorted problems")
    lib = cuda_lib.library("nms")
    for n in (1, 64, 100, 1000, 6000, 49152):
        if lib.nms_scan_smem_bytes(n) != tn.scan_smem_bytes(n):
            raise AssertionError(f"scan shared memory at N = {n}: C "
                                 f"{lib.nms_scan_smem_bytes(n)}, Python "
                                 f"{tn.scan_smem_bytes(n)}")

    def both(what, boxes, active, thr, m):
        got = tn.greedy_keep_sorted(boxes, active, thr, m)
        again = tn.greedy_keep_sorted(boxes, active, thr, m)
        ref = tn.reference_greedy_keep(boxes, active, thr, m)
        if not torch.equal(got, ref):
            bad = (got != ref).any(1).nonzero()[:4, 0].tolist()
            raise AssertionError(f"{what}: kernel keeps differ from the plain "
                                 f"walk's in problems {bad}")
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two kernel runs differ")
        k = got.sum(1)
        print(f"  {what}: {tuple(active.shape)} bit-equal to the plain walk, two "
              f"runs bit-equal; keeps a problem {int(k.min())}-{int(k.max())} "
              f"(total {int(k.sum())}), active {int(active.sum())}")
        return got

    rpn = rpn_problems(gen)
    keep = both("RPN 8 x 5 x 6000, IoU 0.7, 1000 keeps", *rpn, 0.7, 1000)
    both("RPN, max_outputs 5 (reached early)", *rpn, 0.7, 5)
    cls = class_problems(gen)
    keep_cls = both("per class 8 x 150 x 1000, IoU 0.3, 300 keeps", *cls, 0.3, 300)
    for what, boxes, active in nms_edge_cases(gen):
        thr = 0.5 if what == "IoU = threshold" else 0.3
        got = both(what, boxes[None].contiguous(), active[None], thr, 1000)
        if what == "IoU = threshold" and got.sum() != 3:
            raise AssertionError(f"IoU exactly at the threshold suppressed: {got}")
    ties = torch.zeros((4, 1000), device=DEVICE)
    from veto_tpu_torch.models.detector.rpn import topk_first

    if not torch.equal(topk_first(ties, 600)[1],
                       torch.arange(600, device=DEVICE).expand(4, 600)):
        raise AssertionError("topk_first on pure ties is not index order on the card")
    print("  topk_first on pure ties: index order on the card")

    rpn_row = n1_row("RPN", *rpn, 0.7, 1000, keep)
    n1_row("per class", *cls, 0.3, 300, keep_cls)
    return dict(name="greedy_nms", route="cuda", source="veto_tpu_torch/csrc/nms.cu",
                replaces="veto_tpu/ops/nms.py:85 (_greedy_keep_sorted_coords; "
                         "XLA, no Pallas call)",
                max_abs_err=0.0, library_ms=None, **rpn_row)


SIGMAS = (0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0)  # cls_score draws tried, the config's first
MIN_DETECTIONS = 40  # valid detections an image the SGDet checks need


def sgdet_launches(cfg, batches=1):
    """Launches of ``batches`` SGDet forwards (eval batches, or the detect
    and relate of train steps): B1 a layer, B3 3 (the box head's pool of
    the proposals, the relation and depth pools), N1's mask and scan 2
    each (the RPN's walks, then the per-class walks)."""
    return {"fused_encoder_layer": cfg.veto.enc_layers * batches,
            "multilevel_roi_align": 3 * batches,
            "nms_mask": 2 * batches, "nms_scan": 2 * batches}


def mean_detections(model, b) -> float:
    with torch.inference_mode():
        return float(model.detect(b.images, b.sizes).detections.mask.sum(1)
                     .float().mean())


def draw_cls_score(model, cfg, b) -> float:
    """Seeded weights give a near-uniform softmax over the classes, under
    the 0.01 score threshold: draw the frozen ``box_predictor.cls_score``
    with the first σ of ``SIGMAS`` (the config's own 0.01 first) that
    leaves at least ``MIN_DETECTIONS`` valid detections an image of ``b``;
    returns σ."""
    w = model.box_predictor.cls_score.weight
    counts = []
    for sigma in SIGMAS:
        g = torch.Generator(device=DEVICE).manual_seed(cfg.solver.seed + 15)
        with torch.no_grad():
            w.copy_(sigma * torch.randn(w.shape, generator=g, device=DEVICE))
        counts.append(mean_detections(model, b))
        if counts[-1] >= MIN_DETECTIONS:
            break
    print(f"  detections an image by cls_score sigma: "
          f"{dict(zip(SIGMAS, [round(c, 1) for c in counts]))} (sigma 0.01 is "
          f"the config's init); sigma {sigma} taken")
    if counts[-1] < MIN_DETECTIONS:
        raise AssertionError(f"no sigma of {SIGMAS} gives {MIN_DETECTIONS} "
                             f"detections an image: {counts}")
    return sigma


def sgdet_eval_model(config, opts=()):
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.models.sgg import build_model
    from veto_tpu_torch.tools.relation_test_net import synthetic_eval_dataset

    cfg = load_config(os.path.join(ROOT, "configs", config),
                      ["test.ims_per_batch=8", *opts])
    model = build_model(cfg)
    bsz = cfg.test.ims_per_batch
    batch, _ = next(synthetic_eval_dataset(cfg, bsz).batches(bsz, cfg.data.max_boxes))
    b = batch.to(DEVICE)
    sigma = draw_cls_score(model, cfg, b)
    return model, cfg, b, sigma


def counted_evaluate(model, cfg, n_batches, what, per_batch):
    """``relation_test_net.evaluate`` over ``n_batches`` batches with the
    launch counts read at every batch, each held to ``per_batch``; returns
    ms per batch after warm-up, the peak memory, the aggregate and the
    launches counted over the batches."""
    from veto_tpu_torch.tools.relation_test_net import evaluate

    counts = []

    def log(line):
        if line.startswith("batch "):
            counts.append(read_counters(reset=True))
        print(f"  {line}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read_counters(reset=True)
    agg, seconds = evaluate(cfg, model=model, max_batches=n_batches, log=log)
    peak = torch.cuda.max_memory_allocated()
    ms = 1e3 * float(np.mean(seconds[1:] or seconds))
    det = f"; detection mAP {agg['bbox']['mAP']:.4f}" if "bbox" in agg else ""
    print(f"  [{what}] launches a batch {json.dumps(counts[0])}; after warm-up "
          f"{ms:.1f} ms a batch ({[round(1e3 * t, 1) for t in seconds]}); peak "
          f"memory {peak / 2 ** 30:.2f} GiB; R@K {agg['R']}{det}")
    if len(counts) != n_batches or any(c != per_batch for c in counts):
        raise AssertionError(f"launches {counts}, want {per_batch} each batch")
    for m in ("R", "mR"):
        if not all(np.isfinite(v) and 0 <= v <= 100 for v in agg[m].values()):
            raise AssertionError(f"{m}@K out of range: {agg[m]}")
    return ms, peak, agg, add_launches({}, *counts)


def sgdet_evaluate(model, cfg, n_batches, what):
    """:func:`counted_evaluate` at SGDet's launches a batch; returns ms per
    batch after warm-up and the peak memory."""
    ms, peak, _, _ = counted_evaluate(model, cfg, n_batches, what,
                                      expected(**sgdet_launches(cfg)))
    return ms, peak


def sgdet_ladder(model, cfg, b):
    """One batch's cascade on the card, each stage through the kernels and
    through the plain versions on the same input: the proposals (N1 against
    the plain walk) and the detections from the same box logits bit-equal,
    ``rel_logits`` on the same detections at phase 5's tolerances; no
    synchronisation inside ``detect`` or the post-processing.  Returns the
    detections' and pairs' counts an image."""
    from veto_tpu_torch.models.relation.postprocess import postprocess_relations_sgdet
    from veto_tpu_torch.models.relation.sampling import prepare_test_pairs
    from veto_tpu_torch.ops import cuda_lib

    model.eval()
    with torch.inference_mode():
        feats = model.extract_features(b.images)
        obj, reg = model.rpn_maps(feats)
        props = model.propose(obj, reg, b.sizes)
        with cuda_lib.plain_kernels():
            ref = model.propose(obj, reg, b.sizes)
        for f in props._fields:
            if not torch.equal(getattr(props, f), getattr(ref, f)):
                raise AssertionError(f"proposals.{f}: kernels differ from plain")
        logits, deltas = model.box_head(feats, props.boxes)
        dets = model.postprocess_boxes(logits, deltas, props, b.sizes)
        with cuda_lib.plain_kernels():
            ref = model.postprocess_boxes(logits, deltas, props, b.sizes)
        for f in dets._fields:
            if not torch.equal(getattr(dets, f), getattr(ref, f)):
                raise AssertionError(f"detections.{f}: kernels differ from plain")
        idx = dets.orig_idx.long()[..., None].expand(-1, -1, logits.shape[-1])
        det_logits = torch.gather(logits, 1, idx)
        pi, pm = prepare_test_pairs(dets.mask, dets.scores,
                                    cfg.relation.max_proposal_pairs, boxes=dets.boxes,
                                    require_overlap=cfg.test.relation_require_overlap)

        def relate():
            return model.relate(feats, b.depth, dets.boxes, dets.mask, dets.labels,
                                pi, det_logits).rel_logits

        got = relate()
        with cuda_lib.plain_kernels():
            want = relate()
        check_close("SGDet rel_logits kernels vs plain", got, want,
                    atol=0.05 * float(want.abs().max()), rtol=0.0,
                    mean_tol=0.01 * float(want.abs().mean()))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a synchronising op raises
        try:
            det = model.detect(b.images, b.sizes)
            post = postprocess_relations_sgdet(
                got, det.predict_logits, pi, pm, det.detections.boxes_per_cls,
                det.detections.mask, cfg.relation.later_nms_prediction_thres)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if not torch.equal(det.detections.labels, dets.labels):
            raise AssertionError("detect differs from its stages on the same batch")
    nd = dets.mask.sum(1).tolist()
    npairs = pm.sum(1).tolist()
    print(f"  kernels vs plain on one batch: proposals ({int(props.mask.sum())}) and "
          f"detections bit-equal; no synchronisation inside detect or the "
          f"post-processing; detections an image {nd}, pairs an image {npairs}, "
          f"{int(post.pair_mask.sum())} ranked triplets")
    return nd, npairs


def detected_gt_dataset(model, cfg, num_images=24, per_image=20, relations=12):
    """The synthetic train split with its GT replaced by detections: for
    each image, the ``per_image`` best detections of one ``detect`` of the
    same image become its GT boxes and labels, with seeded relations among
    them, so that label assignment and ``detect_relsample`` find
    foreground under seeded weights."""
    from veto_tpu_torch.data.synthetic import SyntheticSGGDataset
    from veto_tpu_torch.tools.relation_train_net import synthetic_train_dataset

    base = synthetic_train_dataset(cfg, num_images)
    gt = []
    for batch, _ in base.batches(cfg.solver.ims_per_batch, cfg.data.max_boxes):
        b = batch.to(DEVICE)
        with torch.inference_mode():
            d = model.detect(b.images, b.sizes).detections
        top = torch.sort(torch.where(d.mask, d.scores, -1.0), dim=1,
                         descending=True, stable=True)[1][:, :per_image]
        for i in range(top.shape[0]):
            keep = top[i][d.mask[i, top[i]]]
            gt.append((d.boxes[i, keep].cpu().numpy(), d.labels[i, keep].cpu().numpy()))

    class Detected(SyntheticSGGDataset):
        def __getitem__(self, idx):
            rec = super().__getitem__(idx)
            boxes, labels = gt[idx % len(gt)]
            n = len(boxes)
            rng = np.random.RandomState(idx)
            rel = np.zeros((n, n), np.int32)
            for _ in range(relations if n > 1 else 0):
                s_, o_ = rng.choice(n, 2, replace=False)
                rel[s_, o_] = rng.randint(1, self.num_rel_classes)
            tuples = np.argwhere(rel > 0)
            rec.update(boxes=boxes.astype(np.float32), labels=labels.astype(np.int32),
                       rel_matrix=rel, rel_tuples=np.column_stack(
                           [tuples, rel[rel > 0]]).astype(np.int64))
            return rec

    return Detected(num_images=base.num_images, image_size=base.image_size,
                    num_obj_classes=base.num_obj_classes,
                    num_rel_classes=base.num_rel_classes,
                    max_objects=base.max_objects, seed=base.seed)


def sgdet_train(model, cfg_opts, steps=5):
    """``relation_train_net.train`` for ``steps`` full-width SGDet steps on
    the detected-GT split with a validation through the SGDet eval step at
    step 4: exact launches at every step (the validation's on top of the
    step it follows), finite losses, every trainable tensor changed, the
    detector, RPN and box head bit-unchanged.  Returns the state, the
    step's launches, ms a step after warm-up, the peak memory and the
    train dataset."""
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.tools.relation_train_net import build_dataset, train

    cfg = load_config(os.path.join(ROOT, "configs", SGDET),
                      [f"solver.max_iter={steps}", f"output_dir={scratch_dir()}",
                       "solver.val_period=4", "test.ims_per_batch=8", *cfg_opts])
    train_ds = detected_gt_dataset(model, cfg)
    val_ds = build_dataset(cfg, "val")
    val_batches = -(-len(val_ds) // cfg.test.ims_per_batch)
    layers = cfg.veto.enc_layers
    per_step = expected(**sgdet_launches(cfg), encoder_ffn_bwd=layers,
                        encoder_att_bwd=layers, roi_align_backward=1)
    with_val = dict(per_step)
    for k, v in sgdet_launches(cfg, val_batches).items():
        with_val[k] += v
    val = (f", validation at step 4 ({val_batches} batches of "
           f"{cfg.test.ims_per_batch})" if steps > 4 else "")
    print(f"[train, SGDet] VETO sgdet training ({SGDET}"
          f"{' ' + ' '.join(cfg_opts) if cfg_opts else ''}), {steps} step(s) of "
          f"{cfg.solver.ims_per_batch} images on GT from detections, "
          f"{cfg.relation.batch_size_per_image} pairs an image{val}")
    frozen = frozen_state(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.requires_grad}
    counts = []

    def log(line):
        if line.startswith("iter "):
            counts.append(read_counters(reset=True))
            line += f"  launches {json.dumps(counts[-1])}"
        print(f"  {line}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read_counters(reset=True)
    state, history = train(cfg, model=model, log=log, datasets=(train_ds, val_ds))
    peak = torch.cuda.max_memory_allocated()
    ms = 1e3 * float(np.mean([r["seconds"] for r in history[1:] or history]))
    want = [with_val if i == 4 else per_step for i in range(steps)]
    if counts != want:
        raise AssertionError(f"launches {counts}, want {want}")
    losses = loss_keys(cfg)
    if not all(np.isfinite(r[k]) for r in history for k in losses + ["grad_norm"]):
        raise AssertionError(f"non-finite losses: {history}")
    val = [r["val_mR100"] for r in history if "val_mR100" in r]
    print(f"  after warm-up {ms:.1f} ms a step "
          f"({[round(1e3 * r['seconds'], 1) for r in history]}); peak memory "
          f"{peak / 2 ** 30:.2f} GiB; "
          f"{', '.join(f'{k} {[round(r[k], 4) for r in history]}' for k in losses[1:])}"
          f"; validation mR@100 {val}")
    for k, v in frozen_state(model).items():
        if not torch.equal(v, frozen[k]):
            raise AssertionError(f"frozen detector changed: {k}")
    still = [n for n, p in model.named_parameters()
             if p.requires_grad and torch.equal(p, before[n])]
    if still:
        raise AssertionError(f"trainable parameters unchanged: {still}")
    print(f"  {len(before)} trainable tensors all changed, {len(frozen)} detector, "
          "RPN and box-head tensors bit-unchanged")
    return state, per_step, ms, peak, train_ds, cfg


def detect_stage_ms(model, b):
    """ms by CUDA events of each stage of ``detect`` on batch ``b``."""
    with torch.inference_mode():
        feats = model.extract_features(b.images)
        obj, reg = model.rpn_maps(feats)
        props = model.propose(obj, reg, b.sizes)
        logits, deltas = model.box_head(feats, props.boxes)
        return {
            "body + FPN": cuda_ms(lambda: model.extract_features(b.images), 3),
            "RPN head": cuda_ms(lambda: model.rpn_maps(feats), 5),
            "propose": cuda_ms(lambda: model.propose(obj, reg, b.sizes), 5),
            "box head": cuda_ms(lambda: model.box_head(feats, props.boxes), 5),
            "post-processing": cuda_ms(
                lambda: model.postprocess_boxes(logits, deltas, props, b.sizes), 5)}


def phase_sgdet(gen):
    """SGDet at full width from seeded weights (``configs/veto_vg_sgdet.yaml``,
    nothing cut): kernel N1 against the plain walk (``phase_nms``);
    ``evaluate`` over 3 batches of 8 (B1 6, B3 3, N1 mask 2, scan 2 a batch,
    every other kernel 0) and one batch's ladder on the card (proposals and
    detections bit-equal to the plain versions', ``rel_logits`` at phase 5's
    tolerances, no synchronisation in ``detect`` or the post-processing);
    ``train`` for 5 steps of 12 on GT taken from detections with a
    validation at step 4, and one step's gradients against the plain
    versions, two kernel runs bit-equal; the stage times of ``detect``; one
    eval batch of ``configs/gqa_sgdet.yaml``.  Returns N1's kernels-line row
    and its launches on the training path."""
    from veto_tpu_torch.engine.train import sample_detections

    row = phase_nms(gen)
    release()
    print(f"[SGDet] {SGDET} at full width from seeded weights: 8 x 800x1344 "
          "images a batch, RPN 6000 / 1000, box head 4096, 80 detections, "
          "2048 test pairs")
    model, cfg, b, sigma = sgdet_eval_model(SGDET)
    eval_ms, eval_peak = sgdet_evaluate(model, cfg, 3, "SGDet eval")
    sgdet_ladder(model, cfg, b)
    stages = detect_stage_ms(model, b)
    print(f"  detect stages (ms by CUDA events, a batch of 8): "
          f"{json.dumps({k: round(v, 2) for k, v in stages.items()})}")
    del b
    release()

    state, per_step, train_ms, train_peak, train_ds, tcfg = sgdet_train(model, ())
    bsz = tcfg.solver.ims_per_batch
    batch, _ = next(train_ds.batches(bsz, tcfg.data.max_boxes))
    tb = batch.to(DEVICE)
    gen_s = torch.Generator(device=DEVICE).manual_seed(1)
    samples = sample_detections(state.model, tb, gen_s,
                                tcfg.relation.batch_size_per_image,
                                tcfg.relation.positive_fraction,
                                tcfg.relation.num_sample_per_gt_rel,
                                tcfg.relation.require_box_overlap)
    fg = (samples.pairs.labels > 0).sum(1).tolist()
    print(f"  foreground pairs an image of a train batch {fg} (of "
          f"{tcfg.relation.batch_size_per_image})")
    if sum(fg) == 0:
        raise AssertionError("the SGDet sampler found no foreground")
    phase_train_grads(state, config=SGDET, what="SGDet", b=tb, exact_floor=True,
                      samples=samples)
    del state, samples, tb
    release()
    gqa_model, gqa_cfg, gb, _ = sgdet_eval_model("gqa_sgdet.yaml")
    print(f"[SGDet GQA] gqa_sgdet.yaml: {gqa_cfg.model.num_obj_classes} object / "
          f"{gqa_cfg.relation.num_classes} predicate classes")
    sgdet_evaluate(gqa_model, gqa_cfg, 1, "SGDet GQA eval")
    del gqa_model, gb, model
    release()
    print(f"[SGDet numbers] {card()}: eval {eval_ms:.1f} ms a batch of 8, peak "
          f"{eval_peak / 2 ** 30:.2f} GiB; train {train_ms:.1f} ms a step of {bsz}, "
          f"peak {train_peak / 2 ** 30:.2f} GiB; cls_score sigma {sigma}")
    return row, 5 * per_step["nms_mask"]


# ------------------------------------------------------------------ phase 16
MEET = "veto_meet_vg_predcls.yaml"
MEET_OPTS = ("test.ims_per_batch=8",)  # the MEET configs leave it at 1
SGDET_MEET = ("relation.predictor=VETOPredictor_MEET", "ensemble.enabled=true")


def meet_model(config, opts=()):
    """A full-width MEET model of ``config`` on the card, seeded, eval mode."""
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.models.sgg import build_model
    from veto_tpu_torch.tools.relation_train_net import build_meet_config

    cfg = load_config(os.path.join(ROOT, "configs", config), [*MEET_OPTS, *opts])
    meet = build_meet_config(cfg)
    model = build_model(cfg)
    heads = meet.experts_per_group * len(meet.group_sizes)
    print(f"[MEET] {config}{' ' + ' '.join(opts) if opts else ''}: "
          f"{cfg.relation.mode}, groups {meet.group_sizes} x {meet.experts_per_group} "
          f"expert(s) = {heads} f32 heads of {cfg.veto.t_input_dim} -> gs + 2, "
          f"voting {meet.voting}; {cfg.test.ims_per_batch} images a batch, "
          f"{cfg.data.max_boxes} boxes, {cfg.relation.max_proposal_pairs} pairs: "
          f"{len(meet.group_sizes) * cfg.relation.max_proposal_pairs} candidates "
          "an image")
    return model, cfg, meet


def meet_forward(model, cfg, b):
    """One eval batch through the model: the group logits [e][k], the
    proposals' logits and the test pairs."""
    from veto_tpu_torch.models.relation.sampling import prepare_test_pairs

    model.eval()
    with torch.inference_mode():
        pi, pm = prepare_test_pairs(b.box_mask, b.box_mask.float(),
                                    cfg.relation.max_proposal_pairs)
        out = model(b.images, b.depth, b.boxes, b.box_mask, b.labels,
                    b.obj_logits, pi, pm)
    return out.rel_logits, out.predict_logits, pi, pm


def meet_candidates(pred, i):
    """Image ``i``'s surviving candidates of a (numpy) ``MeetPrediction``
    keyed by (subject, object, predicate): one key each, since a pair
    proposes one predicate a group and the groups' predicates differ."""
    pm = pred.pair_mask[i]
    pi = pred.pair_idx[i][pm].astype(np.int64)
    key = (pi[:, 0] * 100000 + pi[:, 1]) * 1000 + pred.rel_labels[i][pm]
    return key, pred.rel_scores[i][pm]


def check_meet_post(meet, glogits, predict_logits, pi, pm, b, recs, cfg, what):
    """The MEET post-processing on the card against the same on the CPU, on
    the card's logits: the surviving candidates the same, each one's
    probabilities within 1e-6, the card's ranking sorted by the CPU's
    triple scores up to 1e-6 (the two softmaxes may round one ulp apart),
    and R@K / mR@K of both equal."""
    from veto_tpu_torch.engine.evaluate import MeetEval, accumulate_eval, to_numpy
    from veto_tpu_torch.models.relation.postprocess import object_predictions
    from veto_tpu_torch.models.relation.predictor_meet import postprocess_meet
    from veto_tpu_torch.tools.relation_test_net import make_sgg_evaluator

    num_rel = cfg.relation.num_classes

    def post(dev):
        lg = tuple(tuple(x.to(dev) for x in e) for e in glogits)
        labels, scores = object_predictions(predict_logits.to(dev))
        with torch.inference_mode():
            p = postprocess_meet(meet, lg, labels, scores, pi.to(dev), pm.to(dev),
                                 num_rel)
        return to_numpy(MeetEval(p, b.boxes.to(dev), b.box_mask.to(dev)))

    card_out, cpu_out = post(DEVICE), post("cpu")
    g, c = card_out.prediction, cpu_out.prediction
    if not np.array_equal(g.pair_mask, c.pair_mask):
        raise AssertionError(f"{what}: pair_mask differs, card vs CPU")
    worst, moved, slack = 0.0, 0, 0.0
    for i in range(len(recs)):
        gk, gs = meet_candidates(g, i)
        ck, cs = meet_candidates(c, i)
        go, co = np.argsort(gk, kind="stable"), np.argsort(ck, kind="stable")
        if not np.array_equal(gk[go], ck[co]):
            raise AssertionError(f"{what}: image {i}: other candidates survive")
        worst = max(worst, float(np.abs(gs[go] - cs[co]).max(initial=0)))
        moved += int((gk != ck).sum())
        # the CPU's triple score of each candidate, in the card's order
        obj = c.obj_scores[i]
        pidx = g.pair_idx[i][g.pair_mask[i]]
        rank = np.searchsorted(ck[co], gk)
        triple = (cs[co][rank][:, 1:].max(-1) * obj[pidx[:, 0]] * obj[pidx[:, 1]])
        slack = max(slack, float(np.maximum(np.diff(triple), 0).max(initial=0)))
    if worst > 1e-6 or slack > 1e-6:
        raise AssertionError(f"{what}: rel_scores off by {worst}, ranking out of "
                             f"order by {slack}")
    aggs = []
    for out in (card_out, cpu_out):
        ev = make_sgg_evaluator(cfg)
        accumulate_eval(out, recs, ev, input_sizes=b.sizes.cpu().numpy())
        aggs.append(ev.aggregate())
    if any(aggs[0][m] != aggs[1][m] for m in ("R", "mR")):
        raise AssertionError(f"{what}: R@K card {aggs[0]['R']} / {aggs[0]['mR']}, "
                             f"CPU {aggs[1]['R']} / {aggs[1]['mR']}")
    print(f"  {what}: post-processing on the card vs the CPU on the card's logits: "
          f"{int(g.pair_mask.sum())} surviving candidates the same, rel_scores max "
          f"|err| {worst:.2e}, {moved} candidates ranked elsewhere (ties within "
          f"{slack:.1e}); R@K {aggs[0]['R']}, mR@K {aggs[0]['mR']} equal")
    return card_out


def check_meet_logits(model, cfg, b):
    """One batch's group logits through the kernels against the plain
    versions, at phase 5's tolerances (each head's scale); returns the
    kernels' logits, the proposals' logits and the pairs."""
    from veto_tpu_torch.ops import cuda_lib

    got, predict_logits, pi, pm = meet_forward(model, cfg, b)
    with cuda_lib.plain_kernels():
        ref = meet_forward(model, cfg, b)[0]
    rows = []
    for e, (ge, re) in enumerate(zip(got, ref)):
        for k, (gl, rl) in enumerate(zip(ge, re)):
            err = (gl.float() - rl).abs()
            rows.append((float(err.max()) / float(rl.abs().max()),
                         float(err.mean()) / float(rl.abs().mean()), f"e{e} g{k}",
                         gl.dtype == torch.float32 and bool(torch.isfinite(gl).all())))
    worst = max(rows)
    print(f"  MEET group logits kernels vs plain, {len(rows)} heads: worst max |err| "
          f"{worst[0]:.3e} of max |ref| ({worst[2]}), worst mean |err| "
          f"{max(r[1] for r in rows):.3e} of mean |ref| (phase 5's tolerances: "
          "0.05, 0.01)")
    bad = [r for r in rows if r[0] > 0.05 or r[1] > 0.01 or not r[3]]
    if bad:
        raise AssertionError(f"group logits off: {bad}")
    return got, predict_logits, pi, pm


def host_accumulate_s(step, b, recs, cfg) -> float:
    """Seconds ``accumulate_eval`` takes on the host for one batch's
    predictions (a fresh evaluator)."""
    from veto_tpu_torch.engine.evaluate import accumulate_eval, to_numpy
    from veto_tpu_torch.tools.relation_test_net import make_sgg_evaluator

    preds = to_numpy(step(b))
    ev = make_sgg_evaluator(cfg)
    t0 = time.perf_counter()
    accumulate_eval(preds, recs, ev, input_sizes=b.sizes.cpu().numpy())
    return time.perf_counter() - t0


def phase_meet():
    """MEET at full width from seeded weights, nothing cut:
    ``configs/veto_meet_vg_predcls.yaml`` (VG divide4: 5 groups)
    ``evaluate`` over 2 batches of 8 (B1 6, B3 2 a batch, every other kernel
    0), one batch's group logits through the kernels against the plain
    versions, the card's post-processing against the CPU's on the same
    logits, the host's ``accumulate_eval`` seconds; with
    ``ensemble.expert_group`` (15 heads) one batch each with voting C and U,
    each checked so; ``train`` for 3 steps of 12 (B1, B2a, B2b 6, B3 2,
    B3-bwd 1 a step; every group loss finite) and one step's gradients on
    one routing draw against the plain versions, two kernel runs
    bit-equal; SGDet MEET (``veto_vg_sgdet.yaml`` with
    ``VETOPredictor_MEET`` and the ensemble): one eval batch (B1 6, B3 3, N1
    2 + 2) and one train step; one eval batch of
    ``configs/gqa_meet_predcls.yaml``.  Returns the numbers it prints."""
    from veto_tpu_torch.tools.relation_test_net import synthetic_eval_dataset
    from veto_tpu_torch.tools.relation_train_net import make_eval_fn

    model, cfg, meet = meet_model(MEET)
    per_batch = expected(fused_encoder_layer=cfg.veto.enc_layers,
                         multilevel_roi_align=2)
    eval_ms, eval_peak, _, _ = counted_evaluate(model, cfg, 2, "MEET PredCls eval",
                                                per_batch)
    bsz = cfg.test.ims_per_batch
    batch, recs = next(synthetic_eval_dataset(cfg, bsz).batches(bsz, cfg.data.max_boxes))
    b = batch.to(DEVICE)
    glogits, predict_logits, pi, pm = check_meet_logits(model, cfg, b)
    check_meet_post(meet, glogits, predict_logits, pi, pm, b, recs, cfg,
                    "MEET PredCls")
    step = make_eval_fn(cfg, model)
    host_s = [host_accumulate_s(step, b, recs, cfg) for _ in range(3)]
    print(f"  accumulate_eval on the host: {[round(t, 4) for t in host_s]} s a batch "
          f"of {bsz} ({len(meet.group_sizes) * cfg.relation.max_proposal_pairs} "
          f"candidates an image) beside {eval_ms:.1f} ms of the eval step")
    del model, glogits, predict_logits
    release()

    voting_ms = {}
    model, cfg3, meet3 = meet_model(MEET, ("ensemble.expert_group=true",))
    glogits, predict_logits, pi, pm = check_meet_logits(model, cfg3, b)
    for voting in ("C", "U"):
        from veto_tpu_torch.config import load_config
        from veto_tpu_torch.tools.relation_train_net import build_meet_config

        cfg_v = load_config(os.path.join(ROOT, "configs", MEET),
                            [*MEET_OPTS, "ensemble.expert_group=true",
                             f"ensemble.voting={voting}"])
        voting_ms[voting], _, _, _ = counted_evaluate(
            model, cfg_v, 1, f"MEET PredCls 3 experts, voting {voting}", per_batch)
        check_meet_post(build_meet_config(cfg_v), glogits, predict_logits, pi, pm,
                        b, recs, cfg_v, f"MEET voting {voting}")
    del model, glogits, predict_logits
    release()

    state, launches = phase_train(3, config=MEET, what="MEET")
    phase_train_grads(state, config=MEET, what="MEET", exact_floor=True)
    train_ms, train_peak = TRAIN_MS["MEET"]
    del state
    release()

    sg_model, sg_cfg, _, sigma = sgdet_eval_model(SGDET, SGDET_MEET)
    sg_eval_ms, sg_peak = sgdet_evaluate(sg_model, sg_cfg, 1, "SGDet MEET eval")
    _, _, sg_train_ms, sg_train_peak, _, _ = sgdet_train(sg_model, SGDET_MEET,
                                                         steps=1)
    del sg_model
    release()

    gqa_model, gqa_cfg, _ = meet_model("gqa_meet_predcls.yaml")
    counted_evaluate(gqa_model, gqa_cfg, 1, "MEET GQA eval",
                     expected(fused_encoder_layer=gqa_cfg.veto.enc_layers,
                              multilevel_roi_align=2))
    del gqa_model, b
    release()
    numbers = dict(eval_ms=eval_ms, eval_peak_gib=eval_peak / 2 ** 30,
                   accumulate_eval_s=host_s, voting_ms=voting_ms,
                   train_ms=train_ms, train_peak_gib=train_peak / 2 ** 30,
                   sgdet_eval_ms=sg_eval_ms, sgdet_eval_peak_gib=sg_peak / 2 ** 30,
                   sgdet_train_ms=sg_train_ms,
                   sgdet_train_peak_gib=sg_train_peak / 2 ** 30,
                   cls_score_sigma=sigma, train_launches=launches)
    print(f"[MEET numbers] {card()}: {json.dumps(numbers)}")
    return numbers


# ------------------------------------------------------------------ phase 17
PRETRAIN_OPTS = ("solver.optimizer=sgd", "solver.schedule=WarmupMultiStepLR",
                 "solver.max_iter=5", "solver.checkpoint_period=3",
                 "solver.val_period=4", "test.ims_per_batch=8")
# a pretraining step: the box head's pool and its backward, and the RPN's
# selection (one N1 walk of every image's levels); a detection batch: the
# box head's pool, the RPN's walk and the per-class walks
PRETRAIN_STEP = dict(multilevel_roi_align=1, roi_align_backward=1, nms_mask=1,
                     nms_scan=1)
DETECT_BATCH = dict(multilevel_roi_align=1, nms_mask=2, nms_scan=2)


def pretrain_train(cfg, model, train_ds, val_ds, per_step=PRETRAIN_STEP,
                   heads=()):
    """``detector_pretrain_net.train`` for ``solver.max_iter`` steps (phase
    17: 5, with a checkpoint at 3 and a validation at 4), the launches of
    each step read around it and the run's total read after it: exact at
    every step (``per_step``), the total the steps' plus the validation's
    batches; the losses finite, ``heads``' losses (``loss_mask``,
    ``loss_kp``) positive in some step (a step whose sampled rois hold no
    positive has none).  Returns the state, the history and the peak
    memory."""
    from veto_tpu_torch.engine import pretrain
    from veto_tpu_torch.tools.detector_pretrain_net import train

    steps = cfg.solver.max_iter
    val_batches = (-(-len(val_ds) // cfg.test.ims_per_batch)
                   * (steps // cfg.solver.val_period))
    per_step = expected(**per_step)
    counts, real = [], pretrain.detector_train_step

    def counted(*args, **kw):
        before = read_counters()
        out = real(*args, **kw)
        after = read_counters()
        counts.append({k: after[k] - before[k] for k in after})
        return out

    detector = {n: p.detach().clone() for n, p in model.named_parameters()
                if n.startswith(("backbone", "rpn", "box_"))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read_counters(reset=True)
    pretrain.detector_train_step = counted
    try:
        state, history = train(cfg, model=model, log=lambda line: print(f"  {line}"),
                               datasets=(train_ds, val_ds))
    finally:
        pretrain.detector_train_step = real
    total = read_counters(reset=True)
    peak = torch.cuda.max_memory_allocated()
    want_total = {k: steps * per_step[k] + val_batches * DETECT_BATCH.get(k, 0)
                  for k in per_step}
    print(f"  launches a step {json.dumps(counts[0])}; the run's {json.dumps(total)} "
          f"({steps} steps and {val_batches} validation batches)")
    if len(history) != steps or counts != [per_step] * steps or total != want_total:
        raise AssertionError(f"{len(history)} steps, launches {counts} / {total}, "
                             f"want {per_step} a step, {want_total} in all")
    keys = ("loss", "loss_objectness", "loss_rpn_box_reg", "loss_classifier",
            "loss_box_reg", *heads, "grad_norm")
    if not all(np.isfinite(r[k]) for r in history for k in keys):
        raise AssertionError(f"non-finite losses: {history}")
    if not all(any(r[k] > 0 for r in history) for k in heads):
        raise AssertionError(f"a head's loss is 0 at every step (no positive roi): "
                             f"{history}")
    if val_batches and "val_mAP" not in history[3]:
        raise AssertionError("no validation at step 4")
    still = [n for n, p in model.named_parameters()
             if n in detector and torch.equal(p, detector[n])]
    # an FPN level's output conv takes no gradient when no sampled anchor or
    # roi reads its level, nor the box regression when no sampled roi is
    # positive (VOC's few objects); everything else of the detector always does
    idle = ("backbone.fpn.fpn_layer",) + (
        ("box_predictor.bbox_pred",) if not any(r["loss_box_reg"] for r in history) else ())
    if any(not n.startswith(idle) for n in still):
        raise AssertionError(f"detector parameters unchanged: {still[:5]}")
    print("  " + "; ".join(f"{k} {[round(r[k], 4) for r in history]}" for k in keys))
    print(f"  every detector parameter changed but {still or 'none'}"
          + (f"; validation mAP at 4: {history[3]['val_mAP']:.4f}" if val_batches else ""))
    return state, history, peak


def pretrain_grads(state, b, budgets, resolution=7):
    """One step's gradients through the kernels (twice) against the same
    step through the plain versions, on the same draws, at
    ``phase_train_grads``' tolerances; the two kernel runs side by side.
    Also captures the inputs and the upstream gradient of the step's first
    pool at ``resolution`` (7: the box head's; 14: the mask head's).
    Returns (two kernel runs bit-equal, the pool's maps, rois, gradient)."""
    from veto_tpu_torch.engine.pretrain import DetectorDraws, detector_forward_backward
    from veto_tpu_torch.ops import cuda_lib

    model = state.model
    h, w = b.images.shape[1:3]
    maps = [(-(-h // s), -(-w // s)) for s in model.anchor_strides]
    num_anchors = sum(a.shape[0] for a in model.anchors(maps, b.images.device))
    g = torch.Generator(device=DEVICE).manual_seed(5)
    bsz = b.images.shape[0]
    draws = DetectorDraws(*(torch.rand((bsz, n), generator=g, device=DEVICE) for n in (
        num_anchors, num_anchors, budgets.rpn_fpn_post_nms_top_n,
        budgets.rpn_fpn_post_nms_top_n)))
    params = [(n, p) for n, p in model.named_parameters()]
    pool = {}
    real_pool = model._pool_boxes

    def capture(feats, boxes, res):
        out = real_pool(feats, boxes, res)
        if res == resolution and not pool:
            pool.update(feats=[f.detach() for f in feats[:4]], rois=boxes)
            out.register_hook(lambda grad: pool.__setitem__("grad", grad.detach().clone()))
        return out

    def grads():
        loss = detector_forward_backward(state, b, budgets, draws)["loss"]
        return loss, {n: p.grad.detach().clone() for n, p in params
                      if p.grad is not None}

    model._pool_boxes = capture
    try:
        loss, got = grads()
    finally:
        del model._pool_boxes
    loss2, again = grads()
    with cuda_lib.plain_kernels():
        ref_loss, ref = grads()
    state.optimizer.zero_grad()
    print(f"[pretrain grads] one step's gradients, kernels (two runs) vs plain, "
          f"{bsz} images of {h}x{w}, the same draws: loss {float(loss):.6f}, "
          f"{float(loss2):.6f} (kernels), {float(ref_loss):.6f} (plain)")
    if got.keys() != ref.keys():
        raise AssertionError("the two runs differ in which tensors take a gradient")

    def rel(a, r):
        d = a.float() - r.float()
        return (float(d.norm()) / max(float(r.float().norm()), 1e-30),
                float(d.abs().max()) / max(float(r.abs().max()), 1e-30))

    rows = sorted(((rel(got[n], ref[n]), rel(again[n], ref[n]), n) for n in got),
                  reverse=True)
    for a, a2, n in rows[:5]:
        print(f"  {n}: |err| / |ref| {a[0]:.3e} and {a2[0]:.3e}, max |err| "
              f"{a[1]:.3e} and {a2[1]:.3e} of max |ref| (run 1, run 2)")
    same = [n for n in got if torch.equal(got[n], again[n])]
    exact = len(same) == len(got)
    print(f"  two kernel runs: {len(same)} of {len(got)} gradient tensors bit-equal"
          + ("" if exact else f"; the one nearest the loss that varies: "
             f"{next(n for n, _ in reversed(params) if n in got and n not in same)}"
             " (cuDNN's convolution backward sums in an order of its choosing)"))
    bad = [(a, a2, n) for a, a2, n in rows
           if max(a[0], a2[0]) > 0.1 or max(a[1], a2[1]) > 0.25
           or not bool(torch.isfinite(got[n]).all())]
    if bad:
        raise AssertionError(f"gradients off: {bad[:5]}")
    if abs(float(loss) - float(ref_loss)) > 1e-2 * abs(float(ref_loss)):
        raise AssertionError("loss differs by more than 1%")
    print(f"  {len(got)} gradient tensors within 10% (L2) and 25% (max) of their "
          "plain versions in both runs")
    return exact, pool["feats"], pool["rois"], pool["grad"]


def pretrain_pool(feats, rois, grad, sampled, p=7, what="box"):
    """B3 and B3-bwd alone on one of the step's own pools (P2-P5; the box
    head's 512 rois an image at P = 7, the mask head's 64 at P = 14), the
    slots the sampler left empty (proposal 0 again) included: against the
    plain versions, two runs bit-equal, device ms against the bounds.
    Returns the two kernels' ms and bounds."""
    from veto_tpu_torch.ops import roi_align_windowed as rw

    b, r = rois.shape[:2]
    levels = rw.fpn_level_assignment(rois)
    dup = r - sampled.sum(1)
    hist = torch.bincount(levels.flatten().long(), minlength=4).tolist()
    print(f"[pretrain pool] the step's {what} pool: {b} x {r} rois at P = {p}, P2-P5 "
          f"{[tuple(f.shape[1:3]) for f in feats]}, rois a level {hist}; empty "
          f"slots (proposal 0 again) an image {dup.tolist()}")
    got = rw.multilevel_roi_align_batched(feats, rois, SCALES, p, 2)
    ref = rw.reference_multilevel_roi_align_batched(feats, rois, SCALES, p, 2)
    # the same 16 f32 products summed in another order: a few ulps of the
    # sum of their magnitudes (the trained body's maps reach the hundreds,
    # and their taps cancel)
    mag = rw.reference_multilevel_roi_align_batched([f.abs() for f in feats], rois,
                                                    SCALES, p, 2)
    check_close(f"B3 at the pretraining {what} pool", got, ref, atol=1e-5 + 2.0 ** -20 * mag,
                rtol=1e-5)
    del got, ref, mag
    need = [True] * 4

    def bwd():
        return rw._launch_backward(feats, need, rois, grad, SCALES, p, 2)

    got, again = bwd(), bwd()
    ref = rw.reference_multilevel_roi_align_backward(feats, need, rois, grad,
                                                     SCALES, p, 2)
    mag = rw.reference_multilevel_roi_align_backward(
        [f.float() for f in feats], need, rois, grad.abs(), SCALES, p, 2)
    for lvl in range(4):
        if not torch.equal(got[lvl], again[lvl]):
            raise AssertionError(f"P{lvl + 2} grad: two kernel runs differ")
        # one bf16 rounding of two f32 sums taken in another order (phase 7)
        check_close(f"B3-bwd P{lvl + 2} (two runs bit-equal)", got[lvl], ref[lvl],
                    atol=1e-5 + 2.0 ** -16 * mag[lvl], rtol=2 ** -7)
    del got, again, ref, mag
    fwd_ms = device_ms(lambda: rw.multilevel_roi_align_batched(feats, rois, SCALES, p, 2),
                       "roi_align_fwd_kernel", 10)
    bwd_ms = device_ms(bwd, "roi_align_bwd_kernel", 10)
    out_bytes = b * r * p * p * feats[0].shape[-1] * 4
    fwd_bytes = roi_tap_bytes(feats, rois, levels, SCALES, p) + rois.numel() * 4 + out_bytes
    bwd_bytes = out_bytes + rois.numel() * 4 + sum(f.numel() * 2 for f in feats)
    fwd_bound = max(fwd_bytes / PEAK_BYTES, out_bytes / 4 * 32 / PEAK_F32) * 1e3
    bwd_bound = max(bwd_bytes / PEAK_BYTES, out_bytes / 4 * 32 / PEAK_F32) * 1e3
    print(f"  B3 {fwd_ms:.4f} ms on the device, bound {fwd_bound:.4f} ms "
          f"({fwd_bytes / 1e6:.1f} MB); B3-bwd {bwd_ms:.4f} ms, bound {bwd_bound:.4f} "
          f"ms ({bwd_bytes / 1e6:.1f} MB: the f32 gradient read, the bf16 maps "
          "written)")
    return fwd_ms, fwd_bound, bwd_ms, bwd_bound


def pretrain_tta(model, cfg, b):
    """One eval batch through ``detect`` and through the test-time
    augmentation (flip and scale 0.75), timed; the flip of each image
    within its own width; the TTA's launches exact;
    each of its kernels against its plain version on the same input: every
    augmentation's proposals (N1 on the RPN's maps) bit-equal, every
    augmentation's box pool (B3) at ``pretrain_pool``'s tolerance, and the
    merged filter (N1 on the merged candidates) bit-equal."""
    from veto_tpu_torch.engine import bbox_aug
    from veto_tpu_torch.ops import cuda_lib
    from veto_tpu_torch.ops import roi_align_windowed as rw

    model.eval()
    # the flip mirrors each image within its own width, its padding in place
    widths = b.sizes[:, 0].round().long().tolist()
    flipped = bbox_aug.hflip_images(b.images, b.sizes[:, 0])
    for i, w in enumerate(widths):
        if not (torch.equal(flipped[i, :, :w], torch.flip(b.images[i, :, :w], dims=[1]))
                and torch.equal(flipped[i, :, w:], b.images[i, :, w:])):
            raise AssertionError(f"TTA flip of image {i} ({w} wide) is not its own mirror")
    del flipped
    props, pools, merged = [], [], {}
    real_propose, real_pool = model.propose, model._pool_boxes
    real_filter = bbox_aug.filter_decoded_boxes

    def propose(*args):
        out = real_propose(*args)
        props.append((args, out))
        return out

    def pool(feats, boxes, resolution):
        out = real_pool(feats, boxes, resolution)
        pools.append(([f.contiguous() for f in feats[:4]], boxes, out))
        return out

    def filt(*args, **kw):
        out = real_filter(*args, **kw)
        merged.update(args=args, kw=kw, out=out)
        return out

    scales = (0.75,)
    with torch.inference_mode():
        read_counters(reset=True)
        model.propose, model._pool_boxes = propose, pool
        bbox_aug.filter_decoded_boxes = filt
        try:
            bbox_aug.detect_tta(model, b.images, b.sizes, hflip=True, scales=scales)
        finally:
            del model.propose, model._pool_boxes
            bbox_aug.filter_decoded_boxes = real_filter
        launches = read_counters(reset=True)
        n_aug = 2 + len(scales)
        want = expected(multilevel_roi_align=n_aug, nms_mask=n_aug + 1,
                        nms_scan=n_aug + 1)
        if launches != want:
            raise AssertionError(f"TTA launches {launches}, want {want}")
        whats = ("identity", "flip", "scale 0.75")
        for (args, out), (feats, boxes, pooled), what in zip(props, pools, whats):
            with cuda_lib.plain_kernels():
                ref = real_propose(*args)
            for f in out._fields:
                if not torch.equal(getattr(out, f), getattr(ref, f)):
                    raise AssertionError(f"TTA {what}: proposals.{f} differ from plain")
            ref = rw.reference_multilevel_roi_align_batched(feats, boxes, SCALES, 7, 2)
            mag = rw.reference_multilevel_roi_align_batched(
                [f.abs() for f in feats], boxes, SCALES, 7, 2)
            check_close(f"TTA {what} box pool (B3) vs plain, proposals bit-equal",
                        pooled, ref, atol=1e-5 + 2.0 ** -20 * mag, rtol=1e-5)
            del ref, mag
        with cuda_lib.plain_kernels():
            ref = real_filter(*merged["args"], **merged["kw"])
        for f in ref._fields:
            if not torch.equal(getattr(merged["out"], f), getattr(ref, f)):
                raise AssertionError(f"TTA detections.{f}: N1 differs from the plain walk")
        del props, pools
        detect_ms = cuda_ms(lambda: model.detect(b.images, b.sizes), 3)
        tta_ms = cuda_ms(lambda: bbox_aug.detect_tta(model, b.images, b.sizes,
                                                      hflip=True, scales=scales), 3)
    n = int(merged["out"].mask.sum())
    print(f"  TTA (flip, scale 0.75) on a batch of {b.images.shape[0]} (widths "
          f"{min(widths)}-{max(widths)}, padded to {b.images.shape[2]}): launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}; the merged "
          f"filter bit-equal to the plain walk ({n} detections); detect "
          f"{detect_ms:.1f} ms, TTA {tta_ms:.1f} ms a batch")
    return detect_ms, tta_ms


def phase_pretrain():
    """Detector pretraining at full width (``configs/veto_vg_sgdet.yaml``
    with SGD and the multistep schedule, everything trained): 5 steps of 12
    VG-shaped images through ``detector_pretrain_net.train`` (checkpoint at
    3, validation at 4), exact launches; ``detector_pretest_net`` restoring
    step 5 into a fresh model; the checkpoint's size and its save and
    restore seconds; one step's gradients against the plain versions; B3
    and B3-bwd alone on that step's pool; one eval batch with the TTA.
    Returns the numbers."""
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.engine.pretrain import create_detector_state, detector_budgets
    from veto_tpu_torch.models.sgg import build_model
    from veto_tpu_torch.tools.detector_pretest_net import evaluate
    from veto_tpu_torch.tools.detector_pretrain_net import run_detection_eval
    from veto_tpu_torch.tools.relation_train_net import batches_for
    from veto_tpu_torch.utils.checkpoint import CheckpointManager

    out = scratch_dir()
    cfg = load_config(os.path.join(ROOT, "configs", SGDET),
                      [*PRETRAIN_OPTS, f"output_dir={out}"])
    budgets = detector_budgets(cfg)
    train_ds = VGShapedDataset([False] * 60, seed=21)
    val_ds = VGShapedDataset([False] * 16, seed=22)
    model = build_model(cfg, train_detector=True)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[pretrain] detector pretraining ({SGDET}, SGD + WarmupMultiStepLR): "
          f"{cfg.model.backbone} {cfg.model.resnet_groups}x"
          f"{cfg.model.resnet_width_per_group}d fold_bn={cfg.model.fold_bn}, RPN "
          f"{budgets.rpn_batch_size} anchors @ {budgets.rpn_positive_fraction}, "
          f"{budgets.rpn_pre_nms_top_n} / {budgets.rpn_post_nms_top_n} proposals, box "
          f"head {budgets.box_batch_size} rois @ {budgets.box_positive_fraction}, "
          f"{n_params / 1e6:.1f}M parameters all trained, {cfg.dtype}; 5 steps of "
          f"{cfg.solver.ims_per_batch} VG-shaped images")
    state, history, peak = pretrain_train(cfg, model, train_ds, val_ds)
    ms = 1e3 * float(np.mean([r["seconds"] for r in history[1:]]))
    print(f"  after warm-up {ms:.1f} ms a step ({[round(1e3 * r['seconds'], 1) for r in history]}); "
          f"peak memory {peak / 2 ** 30:.2f} GiB")
    ckpt = CheckpointManager(os.path.join(out, "ckpt"))
    if ckpt.steps() != [3, 5]:
        raise AssertionError(f"checkpoints {ckpt.steps()}, want [3, 5]")
    size = os.path.getsize(ckpt.path(5))
    b_val, recs = next(iter(batches_for(cfg, val_ds, "val")(0)))
    mine = run_detection_eval(cfg, model, [(b_val, recs)], log=lambda s: None)
    trained = {k: v.clone() for k, v in model.state_dict().items()}
    del state, model
    release()

    fresh = build_model(cfg, train_detector=True)
    agg = evaluate(cfg, "val", model=fresh, dataset=val_ds,
                   log=lambda s: print(f"  pretest: {s}"))
    diff = [k for k, v in fresh.state_dict().items() if not torch.equal(v, trained[k])]
    if diff:
        raise AssertionError(f"the pretest's restore differs from the trained model: "
                             f"{diff[:5]}")
    again = run_detection_eval(cfg, fresh, [(b_val, recs)], log=lambda s: None)
    if again != mine:
        raise AssertionError(f"the restored model's detections differ: {again} vs {mine}")
    del trained
    state = create_detector_state(fresh, cfg.solver)
    t0 = time.perf_counter()
    ckpt.restore(state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    other = CheckpointManager(os.path.join(scratch_dir(), "ckpt"))
    t0 = time.perf_counter()
    other.save(state.step, state)
    save_s = time.perf_counter() - t0
    print(f"  pretest restored step 5 into a fresh model (every tensor equal, the "
          f"same detections): val mAP {agg['mAP']:.4f}; checkpoint "
          f"{size / 2 ** 20:.0f} MiB (model and SGD's momentum), save {save_s:.2f} s, "
          f"restore {restore_s:.2f} s")

    b = next(batches_for(cfg, train_ds, "train")(1))[0].to(DEVICE)
    exact, feats, rois, grad = pretrain_grads(state, b, budgets)
    sampled = (grad.abs().amax((2, 3, 4)) > 0)  # the slots whose loss counts
    fwd_ms, fwd_bound, bwd_ms, bwd_bound = pretrain_pool(feats, rois, grad, sampled)
    del feats, rois, grad, b
    release()
    detect_ms, tta_ms = pretrain_tta(fresh, cfg, b_val.to(DEVICE))
    del state, fresh
    release()
    numbers = dict(step_ms=ms, peak_gib=peak / 2 ** 30, checkpoint_mib=size / 2 ** 20,
                   save_s=save_s, restore_s=restore_s, grads_two_runs_bit_equal=exact,
                   b3_ms=fwd_ms, b3_bound_ms=fwd_bound, b3_bwd_ms=bwd_ms,
                   b3_bwd_bound_ms=bwd_bound, detect_ms=detect_ms, tta_ms=tta_ms)
    print(f"[pretrain numbers] {card()}: {json.dumps(numbers)}")
    return numbers


HEAD_OPTS = ("model.mask_on=True", "model.keypoint_on=True")
SHORT_RUN = ("solver.checkpoint_period=1000", "solver.val_period=1000")
# a pretraining step with both heads: the box, mask and keypoint pools and
# their backwards, and the RPN's selection
HEADS_STEP = dict(multilevel_roi_align=3, roi_align_backward=3, nms_mask=1,
                  nms_scan=1)


def heads_pretrain():
    """(a) Detector pretraining with the mask and keypoint heads: 3 steps of
    12 VG-shaped images with masks and 17 keypoints a box through
    ``detector_pretrain_net.train``; exact launches, the heads' losses
    positive and every head tensor changed; one step's gradients against
    the plain versions; B3 and B3-bwd alone on the step's own mask pool
    (12 x 64 rois at P = 14).  Returns the numbers."""
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.engine.pretrain import detector_budgets
    from veto_tpu_torch.models.sgg import build_model
    from veto_tpu_torch.tools.relation_train_net import batches_for

    cfg = load_config(os.path.join(ROOT, "configs", SGDET),
                      [*PRETRAIN_OPTS, *HEAD_OPTS, *SHORT_RUN, "solver.max_iter=3",
                       f"output_dir={scratch_dir()}"])
    budgets = detector_budgets(cfg)
    train_ds = VGShapedDataset([False] * 36, seed=31, instances=True)
    val_ds = VGShapedDataset([False] * 8, seed=32, instances=True)
    model = build_model(cfg, train_detector=True)
    heads = {n: p.detach().clone() for n, p in model.named_parameters()
             if n.startswith(("mask_", "keypoint_"))}
    m = cfg.model
    print(f"[heads: pretraining] {SGDET} with {', '.join(HEAD_OPTS)}: mask head "
          f"{m.mask_conv_layers} at P = {m.mask_pooler_resolution}, keypoint head "
          f"{m.keypoint_conv_layers} at P = {m.keypoint_pooler_resolution} "
          f"({m.num_keypoints} keypoints), {budgets.head_rois_per_image} rois an image; "
          f"{sum(p.numel() for p in heads.values()) / 1e6:.1f}M head parameters; "
          f"3 steps of {cfg.solver.ims_per_batch} VG-shaped images")
    state, history, peak = pretrain_train(cfg, model, train_ds, val_ds,
                                          per_step=HEADS_STEP, heads=("loss_mask", "loss_kp"))
    ms = 1e3 * history[-1]["seconds"]  # the first steps pick cuDNN's algorithms
    still = [n for n, p in model.named_parameters() if n in heads and torch.equal(p, heads[n])]
    if still:
        raise AssertionError(f"head tensors unchanged: {still}")
    host = next(batches_for(cfg, train_ds, "train")(1))[0]
    mask_mb = host.masks.nbytes / 2 ** 20
    print(f"  the third step {ms:.1f} ms "
          f"({[round(1e3 * r['seconds'], 1) for r in history]}), the felt steps "
          f"{[round(1e3 * r['step_seconds'], 1) for r in history]} ms; peak memory "
          f"{peak / 2 ** 30:.2f} GiB; all {len(heads)} head tensors changed; the "
          f"batch's masks {tuple(host.masks.shape)} uint8: {mask_mb:.0f} MiB a step "
          f"({4 * mask_mb:.0f} MiB as f32)")
    b = host.to(DEVICE)
    del host
    exact, feats, rois, grad = pretrain_grads(state, b, budgets, resolution=14)
    sampled = grad.abs().amax((2, 3, 4)) > 0  # the positive rois: the mask loss's
    print(f"  positive rois of the mask pool an image: {sampled.sum(1).tolist()}")
    if not sampled.any():
        raise AssertionError("the gradient step's mask pool has no positive roi")
    fwd_ms, fwd_bound, bwd_ms, bwd_bound = pretrain_pool(feats, rois, grad, sampled,
                                                         p=14, what="mask")
    del state, model, feats, rois, grad, b
    release()
    return dict(step_ms=ms, peak_gib=peak / 2 ** 30, mask_mib_a_step=mask_mb,
                grads_two_runs_bit_equal=exact, b3_p14_ms=fwd_ms,
                b3_p14_bound_ms=fwd_bound, b3_bwd_p14_ms=bwd_ms,
                b3_bwd_p14_bound_ms=bwd_bound)


def heads_attribute():
    """(b) The attribute head in relation training: 3 PredCls steps with
    ``model.attribute_on`` on VG-shaped images whose boxes carry attribute
    lists; exact launches (B3 3 a step: the attribute head's 7x7 pool on
    top of PredCls's 2), ``attribute_loss`` finite and positive,
    ``att_score`` changed, the detector and the box head under it
    bit-unchanged.  Returns the step ms."""
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.models.sgg import build_model
    from veto_tpu_torch.tools.relation_train_net import train

    cfg = load_config(os.path.join(ROOT, "configs", PREDCLS),
                      ["model.attribute_on=True", *SHORT_RUN, "solver.max_iter=3",
                       f"output_dir={scratch_dir()}"])
    model = build_model(cfg)
    layers = cfg.veto.enc_layers
    per_step = expected(fused_encoder_layer=layers, encoder_ffn_bwd=layers,
                        encoder_att_bwd=layers, multilevel_roi_align=3,
                        roi_align_backward=1)
    frozen = frozen_state(model)
    att = model.attribute_predictor.att_score.weight.detach().clone()
    counts = []

    def log(line):
        if line.startswith("iter "):
            counts.append(read_counters(reset=True))
            print(f"  {line}  launches {json.dumps(counts[-1])}")

    print(f"[heads: attribute] {PREDCLS} with model.attribute_on=True "
          f"({cfg.model.num_attributes} attributes, loss weight "
          f"{cfg.model.attribute_loss_weight}); 3 steps of {cfg.solver.ims_per_batch} "
          "VG-shaped images with attribute lists")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read_counters(reset=True)
    _, history = train(cfg, model=model, log=log, datasets=(
        VGShapedDataset([False] * 36, seed=33, attributes=True),
        VGShapedDataset([False] * 8, seed=34, attributes=True)))
    peak = torch.cuda.max_memory_allocated()
    if len(history) != 3 or counts != [per_step] * 3:
        raise AssertionError(f"{len(history)} steps, launches {counts}, want {per_step}")
    if not all(np.isfinite(r[k]) and r[k] > 0 for r in history
               for k in ("loss", "rel_loss", "attribute_loss")):
        raise AssertionError(f"losses: {history}")
    if torch.equal(model.attribute_predictor.att_score.weight, att):
        raise AssertionError("att_score did not change")
    for k, v in frozen_state(model).items():
        if not torch.equal(v, frozen[k]):
            raise AssertionError(f"frozen detector changed: {k}")
    ms = 1e3 * history[-1]["seconds"]
    print(f"  attribute_loss {[round(r['attribute_loss'], 4) for r in history]}; "
          f"the third step {ms:.1f} ms "
          f"({[round(1e3 * r['seconds'], 1) for r in history]}); peak "
          f"{peak / 2 ** 30:.2f} GiB; att_score "
          f"changed, {len(frozen)} detector tensors (box head included) bit-unchanged")
    del model
    release()
    return dict(attribute_step_ms=ms, attribute_peak_gib=peak / 2 ** 30)


def write_det_files(root, rng):
    """A COCO instances JSON (train2017 24 images, val2017 8; 80 categories
    with COCO's gaps in the ids, crowd annotations) and ``VOC2007`` /
    ``VOC2012`` devkits (ImageSets/Main, Annotations XML with difficult
    objects; train 12 each, val 8 and 4), all at VG's image sizes."""
    from veto_tpu_torch.data.voc import VOC_CLASSES

    def size():
        long, short = int(rng.randint(450, 501)), int(rng.randint(300, 376))
        return (long, short) if rng.rand() < 0.8 else (short, long)

    cat_ids = [i for i in range(1, 91) if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
    os.makedirs(os.path.join(root, "annotations"))
    for split, n in (("train", 24), ("val", 8)):
        images, anns = [], []
        for i in range(n):
            w, h = size()
            images.append({"id": 1000 + i, "width": w, "height": h,
                           "file_name": f"{1000 + i:012d}.jpg"})
            for _ in range(rng.randint(5, 31)):
                x, y = rng.uniform(0, w * 0.8), rng.uniform(0, h * 0.8)
                anns.append({"id": len(anns), "image_id": 1000 + i,
                             "bbox": [x, y, rng.uniform(8, w * 0.4), rng.uniform(8, h * 0.4)],
                             "category_id": int(rng.choice(cat_ids)),
                             "iscrowd": int(rng.rand() < 0.05)})
        with open(os.path.join(root, "annotations", f"instances_{split}2017.json"), "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": c, "name": f"c{c}"} for c in cat_ids]}, f)
    for year, splits in (("2007", (("train", 12), ("val", 8))),
                         ("2012", (("train", 12), ("val", 4)))):
        voc = os.path.join(root, f"VOC{year}")
        os.makedirs(os.path.join(voc, "ImageSets", "Main"))
        os.makedirs(os.path.join(voc, "Annotations"))
        for split, n in splits:
            names = [f"{year}_{split}_{i:06d}" for i in range(n)]
            with open(os.path.join(voc, "ImageSets", "Main", f"{split}.txt"), "w") as f:
                f.write("\n".join(names) + "\n")
            for name in names:
                w, h = size()
                objs = []
                for _ in range(rng.randint(2, 11)):
                    x1, y1 = int(rng.randint(1, w * 0.7)), int(rng.randint(1, h * 0.7))
                    objs.append(
                        f"<object><name>{VOC_CLASSES[rng.randint(1, 21)]}</name>"
                        f"<difficult>{int(rng.rand() < 0.1)}</difficult><bndbox>"
                        f"<xmin>{x1}</xmin><ymin>{y1}</ymin>"
                        f"<xmax>{min(x1 + int(rng.randint(10, w * 0.4)), w)}</xmax>"
                        f"<ymax>{min(y1 + int(rng.randint(10, h * 0.4)), h)}</ymax>"
                        "</bndbox></object>")
                with open(os.path.join(voc, "Annotations", f"{name}.xml"), "w") as f:
                    f.write(f"<annotation><size><width>{w}</width><height>{h}</height>"
                            f"</size>{''.join(objs)}</annotation>")


def heads_coco_voc():
    """(c) COCO and VOC: the files of :func:`write_det_files`, routed by
    ``build_dataset`` (``coco_2017``; ``VOC2007+VOC2012`` concatenated for
    train, ``VOC2007`` for val), the pixels seeded in memory through a
    subclass's ``load_image`` (the card's machine has no PIL); 2 pretraining
    steps on each, exact launches; the VOC evaluator on one VOC val batch's
    detections.  Returns the VOC mAP (seeded weights)."""
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.data.coco import COCODetDataset
    from veto_tpu_torch.data.compound import ConcatDataset
    from veto_tpu_torch.data.voc import VOCDataset
    from veto_tpu_torch.engine.evaluate import to_numpy
    from veto_tpu_torch.evaluation.voc_eval import VOCEvaluator
    from veto_tpu_torch.models.sgg import build_model
    from veto_tpu_torch.tools.relation_train_net import batches_for, build_dataset

    class Pixels:
        """Seeded u8 pixels at each image's size, in place of its file."""

        def load_image(self, index):
            info = self.img_info[index]
            rng = np.random.RandomState(index)
            return rng.randint(0, 256, (info["height"], info["width"], 3),
                               dtype=np.uint8).astype(np.float32) / 255.0

    class COCO(Pixels, COCODetDataset):
        pass

    class VOC(Pixels, VOCDataset):
        pass

    root = scratch_dir()
    write_det_files(root, np.random.RandomState(35))

    def in_memory(ds):
        """The routed dataset's in-memory twin, its records checked equal."""
        if isinstance(ds, ConcatDataset):
            twin = ConcatDataset([in_memory(d) for d in ds.datasets])
        elif isinstance(ds, COCODetDataset):
            twin = COCO(ds.ann_file, ds.img_dir)
        else:
            twin = VOC(ds.root, ds.split)
        same = all(np.array_equal(twin.get_groundtruth(i, inner_idx=False)["boxes"],
                                  ds.get_groundtruth(i, inner_idx=False)["boxes"])
                   for i in range(len(ds)))
        if len(twin) != len(ds) or not same:
            raise AssertionError(f"{type(ds).__name__}: the in-memory twin differs")
        return twin

    model, mAP = None, None
    for name in ("coco_2017", "VOC2007+VOC2012"):
        cfg = load_config(os.path.join(ROOT, "configs", SGDET),
                          [*PRETRAIN_OPTS, *SHORT_RUN, "solver.max_iter=2",
                           f"data.data_dir={root}", f"data.dataset={name}",
                           f"output_dir={scratch_dir()}"])
        train_ds = in_memory(build_dataset(cfg, "train"))
        val_ds = in_memory(build_dataset(cfg, "val"))
        print(f"[heads: {name}] train {type(train_ds).__name__} of {len(train_ds)} "
              f"images, val {type(val_ds).__name__} of {len(val_ds)}; 2 pretraining "
              "steps")
        if model is None:
            model = build_model(cfg, train_detector=True)
        pretrain_train(cfg, model, train_ds, val_ds)
    host, recs = next(iter(batches_for(cfg, val_ds, "val")(0)))
    b = host.to(DEVICE)
    model.eval()
    read_counters(reset=True)
    with torch.no_grad():
        dets = to_numpy(model.detect(b.images, b.sizes.float()).detections)
    if read_counters(reset=True) != expected(**DETECT_BATCH):
        raise AssertionError("the VOC batch's detection launches differ from a batch's")
    ev = VOCEvaluator(use_07_metric=True)
    for i, rec in enumerate(recs):
        m = dets.mask[i]
        ev.add_image(dets.boxes[i][m], dets.labels[i][m], dets.scores[i][m],
                     rec["boxes"], rec["labels"], rec["difficult"])
    agg = ev.aggregate()
    mAP = agg["map"]
    print(f"  VOCEvaluator (07 11-point) on one val batch of {len(recs)}: "
          f"{int(dets.mask.sum())} detections, mAP {mAP:.4f} (seeded weights: no "
          "detector was trained to this)")
    del model
    release()
    return dict(voc_map_seeded=mAP)


def phase_heads():
    """Phase 18: the detector's other data and heads at full width."""
    numbers = {**heads_pretrain(), **heads_attribute(), **heads_coco_voc()}
    print(f"[heads numbers] {card()}: {json.dumps(numbers)}")
    return numbers


# ------------------------------------------------------------------ phase 19
LEGACY = ("MotifPredictor", "VCTreePredictor", "TransformerPredictor",
          "TransLikePredictor")
LEGACY_STEPS = 2  # PredCls train steps a predictor


def legacy_cfg(config, predictor, opts=()):
    """The config with ``relation.predictor`` and 8 images an eval batch."""
    from veto_tpu_torch.config import load_config

    return load_config(os.path.join(ROOT, "configs", config),
                       ["test.ims_per_batch=8", f"relation.predictor={predictor}",
                        f"output_dir={scratch_dir()}", *opts])


def legacy_model(cfg, body):
    """A full-width legacy model of ``cfg`` on the card, seeded, eval mode,
    its frozen detector body the one of ``body`` (a state dict, shared by
    the builds: the seeded draw gives every build the same body) when
    given; returns the model and its body's state dict."""
    from veto_tpu_torch.models.sgg import build_model

    t0 = time.perf_counter()
    model = build_model(cfg)
    if body is not None:
        model.backbone.load_state_dict(body)
    print(f"  built {cfg.relation.predictor} ({cfg.relation.mode}, hidden "
          f"{cfg.relation.context_hidden_dim}, pooling "
          f"{cfg.relation.context_pooling_dim}, {cfg.dtype}) in "
          f"{time.perf_counter() - t0:.1f} s")
    return model, model.backbone.state_dict()


def flat_logits(out):
    """The relation logits as a list of tensors (MEET's [e][k] flattened)."""
    if torch.is_tensor(out):
        return [out]
    return [t for e in out for t in e]


def check_legacy_logits(model, cfg, b, what):
    """One eval batch's relation logits through the kernels against the
    plain versions, at phase 5's tolerances; VCTree first reports how many
    forest nodes (left, right, parent, root) of the two runs differ, then
    compares the logits with the plain run's forest given to both."""
    from veto_tpu_torch.models.relation.legacy.vctree import forest_differences
    from veto_tpu_torch.ops import cuda_lib

    out = eval_forward(model, cfg, b)
    got, tree = out.rel_logits, out.forest
    with cuda_lib.plain_kernels():
        out = eval_forward(model, cfg, b)
    ref, plain_tree = out.rel_logits, out.forest
    note = ""
    if tree is not None:
        diff = forest_differences(tree, plain_tree)
        got = eval_forward(model, cfg, b, plain_tree).rel_logits
        note = (f"; the two runs' forests differ at {diff} of "
                f"{int(plain_tree.in_tree.sum())} nodes, the logits compared on "
                "the plain run's forest")
    print(f"  {what}: kernels vs plain{note}")
    for i, (g, r) in enumerate(zip(flat_logits(got), flat_logits(ref))):
        if g.dtype != torch.float32:
            raise AssertionError(f"{what}: logits {g.dtype}")
        check_close(f"{what} logits {i}", g, r, atol=0.05 * float(r.abs().max()),
                    rtol=0.0, mean_tol=0.01 * float(r.abs().mean()))
    return got


def legacy_evaluate(model, cfg, what, per_batch):
    """One eval batch of 8 through ``relation_test_net.evaluate`` at exact
    launches; returns its ms, peak memory and launches counted."""
    ms, peak, _, counted = counted_evaluate(model, cfg, 1, what, per_batch)
    return ms, peak, counted


def legacy_train(model, cfg, per_step, what, steps, datasets=None, idle=()):
    """``relation_train_net.train`` for ``steps`` full-width steps: exact
    launches at every step, finite losses (``binary_loss`` for VCTree),
    every trainable tensor changed (but those under the ``idle`` prefixes,
    which no loss of the step reaches), the frozen detector bit-unchanged,
    every trainable BatchNorm's statistics updated.  Returns the state, ms
    a step (the last), the peak memory and the launches counted."""
    from veto_tpu_torch.tools.relation_train_net import train

    cfg = cfg.override("solver.max_iter", steps)
    frozen = frozen_state(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.requires_grad}
    stats0 = {n: b.clone() for n, b in model.named_buffers()
              if not n.startswith("backbone.")
              and n.endswith(("running_mean", "running_var"))}
    counts = []

    def log(line):
        if line.startswith("iter "):
            counts.append(read_counters(reset=True))
            line += f"  launches {json.dumps(counts[-1])}"
        print(f"  {line}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read_counters(reset=True)
    try:
        state, history = train(cfg, model=model, log=log, datasets=datasets)
    finally:  # a checkpoint of the full-width model holds about 1.7 GB
        shutil.rmtree(cfg.output_dir, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    if counts != [per_step] * steps:
        raise AssertionError(f"{what}: launches {counts}, want {per_step} a step")
    keys = [k for k in history[-1] if k.endswith("loss")] + ["grad_norm"]
    if not all(np.isfinite(r[k]) for r in history for k in keys):
        raise AssertionError(f"{what}: non-finite losses: {history}")
    if cfg.relation.predictor.startswith("VCTree") and "binary_loss" not in keys:
        raise AssertionError(f"{what}: no binary_loss")
    for k, v in frozen_state(model).items():
        if not torch.equal(v, frozen[k]):
            raise AssertionError(f"{what}: frozen detector changed: {k}")
    still = [n for n, p in model.named_parameters()
             if p.requires_grad and torch.equal(p, before[n]) and not n.startswith(idle)]
    same = [n for n, b in model.named_buffers()
            if n in stats0 and torch.equal(b, stats0[n])]
    if still or same:
        raise AssertionError(f"{what}: unchanged: {still} {same}")
    ms = 1e3 * history[-1]["seconds"]
    print(f"  [{what}] {steps} step(s): {', '.join(f'{k} {history[-1][k]:.4f}' for k in keys)}"
          f" (the last); {[round(1e3 * r['seconds'], 1) for r in history]} ms a step; "
          f"peak memory {peak / 2 ** 30:.2f} GiB; {len(before)} trainable tensors "
          f"changed, {len(stats0)} BatchNorm statistics updated, {len(frozen)} "
          "detector tensors bit-unchanged")
    return state, ms, peak, add_launches({}, *counts)


def legacy_context_ms(model, cfg, b):
    """ms by CUDA events of the predictor's context (the LSTMs / the tree
    passes / the attention stacks) on one eval batch's inputs, and for
    VCTree of the tree build and one bidirectional TreeLSTM pass."""
    from veto_tpu_torch.models.relation.legacy.vctree import build_vctree

    seen = {}
    ctx = model.relation.context_layer
    hooks = [ctx.register_forward_pre_hook(
        lambda m, args, kw: seen.__setitem__("ctx", (args, kw)), with_kwargs=True)]
    if hasattr(ctx, "obj_ctx_rnn") and hasattr(ctx, "pair_scores"):
        hooks.append(ctx.obj_ctx_rnn.register_forward_pre_hook(
            lambda m, args: seen.__setitem__("tree", args)))
    try:
        eval_logits(model, cfg, b)
    finally:
        for h in hooks:
            h.remove()
    args, kw = seen["ctx"]
    out = {}
    with torch.inference_mode():
        out["context_ms"] = cuda_ms(lambda: ctx(*args, **kw), 3, warmup=1)
        if "tree" in seen:
            obj_pre, forest = seen["tree"]
            mask = args[2]
            scores = torch.rand(mask.shape + mask.shape[-1:], device=DEVICE)
            out["tree_build_ms"] = cuda_ms(lambda: build_vctree(scores, mask), 3, 1)
            out["bi_tree_lstm_ms"] = cuda_ms(lambda: ctx.obj_ctx_rnn(obj_pre, forest),
                                             3, 1)
    return out


def legacy_predcls(predictor, b, body, numbers, launches):
    """One predictor in PredCls: an eval batch (B3 2: the box pool and the
    union pool; no other kernel), its logits through the kernels against the
    plain versions, the context's ms, the eval's busy share; then
    ``LEGACY_STEPS`` train steps (B3 2 a step, no B3-bwd: the body is frozen
    and no depth is read) and one step's gradients against the plain
    versions (in f32: :func:`legacy_grads_f32`).  The counted runs'
    launches go into ``launches``."""
    cfg = legacy_cfg(PREDCLS, predictor)
    model, body = legacy_model(cfg, body)
    per = expected(multilevel_roi_align=2)
    eval_ms, eval_peak, counted = legacy_evaluate(model, cfg,
                                                  f"{predictor} PredCls eval", per)
    add_launches(launches, counted)
    check_legacy_logits(model, cfg, b, f"{predictor} PredCls")
    fwd = lambda: eval_logits(model, cfg, b)  # noqa: E731
    wall, busy = cuda_ms(fwd, 2, 1), busy_ms(fwd, 2)
    ctx = legacy_context_ms(model, cfg, b)
    state, train_ms, train_peak, counted = legacy_train(model, cfg, per,
                                                        f"{predictor} train",
                                                        LEGACY_STEPS)
    add_launches(launches, counted)
    del state, model
    release()
    legacy_grads_f32(predictor)
    numbers[predictor] = dict(eval_ms=eval_ms, eval_forward_ms=wall,
                              eval_busy_share=busy / wall,
                              eval_peak_gib=eval_peak / 2 ** 30, train_ms=train_ms,
                              train_peak_gib=train_peak / 2 ** 30, **ctx)
    print(f"  [{predictor}] eval forward {wall:.1f} ms by CUDA events, {busy:.1f} ms "
          f"busy on the device ({busy / wall:.2f}); context {json.dumps(ctx)}")
    return body


def legacy_grads_f32(predictor):
    """One PredCls step's gradients through the kernels against the plain
    versions, the model (body included) in f32.  In bf16 from seeded
    weights the legacy heads' steps are chaotic: the relation logits reach
    the hundreds (loss 30-90), and a bf16 rounding flip of a pooled feature
    (B3 and its plain version differ in the last f32 bits) moved the
    Transformer's first attention layer's gradients by 19% (L2) in the first
    card run; in f32 the comparison is well posed."""
    from veto_tpu_torch.engine.train import create_train_state
    from veto_tpu_torch.tools.relation_train_net import (
        build_meet_config, rel_class_weights,
    )

    cfg = legacy_cfg(PREDCLS, predictor, ("dtype=float32",))
    model, _ = legacy_model(cfg, None)
    state = create_train_state(model, cfg.solver, rel_class_weights(cfg),
                               mode=cfg.relation.mode, meet=build_meet_config(cfg))
    phase_train_grads(state, (f"relation.predictor={predictor}", "dtype=float32"),
                      what=f"{predictor} PredCls, f32")
    del state, model
    release()


def legacy_other_modes(predictor, body, numbers, launches):
    """One predictor in SGCls (B3 3: the box head's pool too) and in SGDet
    (B3 3: the box head's pool of the proposals, then the box and union
    pools of the detections; N1 mask 2, scan 2: the RPN's and the
    per-class walks): one eval batch and one train step each (SGDet's on
    GT taken from detections, as phase 15's).  The counted runs' launches
    go into ``launches``."""
    cfg = legacy_cfg(SGCLS, predictor)
    model, body = legacy_model(cfg, body)
    per = expected(multilevel_roi_align=3)
    eval_ms, eval_peak, counted = legacy_evaluate(model, cfg,
                                                  f"{predictor} SGCls eval", per)
    _, train_ms, train_peak, counted_train = legacy_train(
        model, cfg, per, f"{predictor} SGCls train", 1)
    add_launches(launches, counted, counted_train)
    numbers[f"{predictor} sgcls"] = dict(eval_ms=eval_ms, train_ms=train_ms,
                                         eval_peak_gib=eval_peak / 2 ** 30,
                                         train_peak_gib=train_peak / 2 ** 30)
    del model
    release()

    from veto_tpu_torch.tools.relation_test_net import synthetic_eval_dataset
    from veto_tpu_torch.tools.relation_train_net import build_dataset

    cfg = legacy_cfg(SGDET, predictor)
    model, body = legacy_model(cfg, body)
    batch, _ = next(synthetic_eval_dataset(cfg, 8).batches(8, cfg.data.max_boxes))
    sigma = draw_cls_score(model, cfg, batch.to(DEVICE))
    per = expected(multilevel_roi_align=3, nms_mask=2, nms_scan=2)
    eval_ms, eval_peak, counted = legacy_evaluate(model, cfg,
                                                  f"{predictor} SGDet eval", per)
    datasets = (detected_gt_dataset(model, cfg), build_dataset(cfg, "val"))
    _, train_ms, train_peak, counted_train = legacy_train(
        model, cfg, per, f"{predictor} SGDet train", 1, datasets)
    add_launches(launches, counted, counted_train)
    numbers[f"{predictor} sgdet"] = dict(eval_ms=eval_ms, train_ms=train_ms,
                                         eval_peak_gib=eval_peak / 2 ** 30,
                                         train_peak_gib=train_peak / 2 ** 30,
                                         cls_score_sigma=sigma)
    del model
    release()
    return body


def legacy_union_pool(b):
    """B3 alone on one eval batch's union boxes: 8 images x 2048 pairs =
    16,384 rois at 7x7 on the frozen body's P2-P5, against its plain
    version; device ms against the bound (bytes: the taps the rois read,
    the rois, the f32 output)."""
    from veto_tpu_torch.config import load_config
    from veto_tpu_torch.models.relation.sampling import prepare_test_pairs
    from veto_tpu_torch.models.relation.union_features import union_boxes
    from veto_tpu_torch.models.sgg import build_model
    from veto_tpu_torch.ops import roi_align_windowed as rw

    cfg = load_config(os.path.join(ROOT, "configs", PREDCLS),
                      ["relation.predictor=MotifPredictor"])
    model = build_model(cfg)
    with torch.inference_mode():
        feats = [f.contiguous() for f in model.extract_features(b.images)[:4]]
        pi, _ = prepare_test_pairs(b.box_mask, b.box_mask.float(),
                                   cfg.relation.max_proposal_pairs)
        rois = union_boxes(b.boxes, pi)[0].contiguous()
    del model
    p = 7
    levels = rw.fpn_level_assignment(rois)
    share = [round(float((levels == k).float().mean()), 3) for k in range(4)]
    got = rw.multilevel_roi_align_batched(feats, rois, SCALES, p, 2)
    ref = rw.reference_multilevel_roi_align_batched(feats, rois, SCALES, p, 2)
    err = check_close(f"union pool, {rois.shape[0]} x {rois.shape[1]} rois", got, ref,
                      atol=1e-5, rtol=1e-5)
    del got, ref
    ms = device_ms(lambda: rw.multilevel_roi_align_batched(feats, rois, SCALES, p, 2),
                   "roi_align_fwd_kernel", 10)
    plain_ms = cuda_ms(lambda: rw.reference_multilevel_roi_align_batched(
        feats, rois, SCALES, p, 2), 2, 1)
    c = feats[0].shape[-1]
    out_bytes = rois.shape[0] * rois.shape[1] * p * p * c * 4
    in_bytes = roi_tap_bytes(feats, rois, levels, SCALES, p) + rois.numel() * 4
    bound = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
    print(f"  union pool: rois by level P2-P5 {share}; kernel {ms:.4f} ms on the "
          f"device, plain {plain_ms:.3f} ms; moves {in_bytes / 1e6:.1f} MB of taps "
          f"and rois + {out_bytes / 1e6:.1f} MB out -> bound {bound:.4f} ms (bytes), "
          f"{(in_bytes + out_bytes) / ms / 1e6:.0f} GB/s")
    return dict(rois=int(rois.shape[0] * rois.shape[1]), level_share=share, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, max_abs_err=err)


def phase_legacy():
    """Phase 19: the legacy relation head at full width (see the module
    docstring).  Returns its numbers and the launches of its counted
    runs."""
    from veto_tpu_torch.tools.relation_test_net import synthetic_eval_dataset

    print("[legacy] the legacy relation head at full width: Motifs, VCTree, "
          "Transformer, TransLike (context_hidden_dim 512, context_pooling_dim "
          "4096, bf16) on the frozen R-101 body, seeded weights")
    cfg = legacy_cfg(PREDCLS, "MotifPredictor")
    batch, _ = next(synthetic_eval_dataset(cfg, 8).batches(8, cfg.data.max_boxes))
    b = batch.to(DEVICE)
    numbers, body, launches = {}, None, {}
    for predictor in LEGACY:
        body = legacy_predcls(predictor, b, body, numbers, launches)
    for predictor in LEGACY[:2]:
        body = legacy_other_modes(predictor, body, numbers, launches)

    meet = ("ensemble.enabled=true",)
    cfg = legacy_cfg(PREDCLS, "MotifPredictor_MEET", meet)
    model, body = legacy_model(cfg, body)
    per = expected(multilevel_roi_align=2)
    eval_ms, _, counted = legacy_evaluate(model, cfg, "MotifPredictor_MEET eval", per)
    check_legacy_logits(model, cfg, b, "MotifPredictor_MEET")
    _, train_ms, _, counted_train = legacy_train(model, cfg, per,
                                                 "MotifPredictor_MEET train", 1)
    add_launches(launches, counted, counted_train)
    numbers["MotifPredictor_MEET"] = dict(eval_ms=eval_ms, train_ms=train_ms)
    del model
    release()
    numbers["union_pool"] = legacy_union_pool(b)
    numbers["launches"] = {k: v for k, v in launches.items() if v}
    release()
    print(f"[legacy numbers] {card()}: {json.dumps(numbers)}")
    return numbers, launches


# ------------------------------------------------------------------ phase 20
VGG = "vgg_vg_predcls.yaml"
# the message-passing predictors and the options each runs with
ZOO = (("IMPPredictor", ()), ("BGNNPredictor", ("relation.rel_aware=true",)),
       ("GPSNetPredictor", ()), ("MSDNPredictor", ()))


def vgg_level_pool(gen, b=8, h=800, w=1344, c=512):
    """B3 and B3-bwd on VGG-16's single 512-channel level at 1/16 (bf16, 80
    rois an image): the RGB pool at P = 8 and the box head's at P = 7
    against their plain versions; the backward (its tile rows 2 at 512 bf16
    channels, C and Python agreeing) against the plain backward, two runs
    bit-equal; the forward's device ms against its bound (bytes).  Returns
    its numbers."""
    from veto_tpu_torch.ops import cuda_lib
    from veto_tpu_torch.ops import roi_align_windowed as rw

    rows = cuda_lib.library("roi_align").roi_align_bwd_tile_rows(c, 1)
    if rows != rw.bwd_tile_rows(c, torch.bfloat16) or rows != 2:
        raise AssertionError(f"tile rows at {c} bf16: C {rows}, Python "
                             f"{rw.bwd_tile_rows(c, torch.bfloat16)}, want 2")
    fmap = torch.randn(b, h // 16, w // 16, c, generator=gen, device=DEVICE).bfloat16()
    rois = eval_rois(gen, b, 80, h, w)
    scale, errs = (0.0625,), []
    print(f"[roi_align, VGG-16 level] kernel vs plain, {b} x {h // 16}x{w // 16}x{c} "
          "bf16 map, 80 rois an image")
    for p in (8, 7):
        got = rw.multilevel_roi_align_batched([fmap], rois, scale, p, 2)
        ref = rw.reference_multilevel_roi_align_batched([fmap], rois, scale, p, 2)
        errs.append(check_close(f"P = {p}", got, ref, atol=1e-5, rtol=1e-5))
    g = torch.randn(b, 80, 8, 8, c, generator=gen, device=DEVICE)
    got, again = (rw._launch_backward([fmap], [True], rois, g, scale, 8, 2)[0]
                  for _ in range(2))
    ref = rw.reference_multilevel_roi_align_backward([fmap], [True], rois, g, scale,
                                                     8, 2)[0]
    if not torch.equal(got, again):
        raise AssertionError("512-channel backward: two kernel runs differ")
    errs.append(check_close("backward bf16 (two kernel runs bit-equal)", got, ref,
                            atol=1e-5, rtol=2 ** -7))
    del got, again, ref, g
    fwd = lambda: rw.multilevel_roi_align_batched([fmap], rois, scale, 8, 2)  # noqa: E731
    ms = device_ms(fwd, "roi_align_fwd_kernel", 20)
    plain_ms = cuda_ms(lambda: rw.reference_multilevel_roi_align_batched(
        [fmap], rois, scale, 8, 2), 2, 1)
    out_bytes = b * 80 * 8 * 8 * c * 4
    in_bytes = (roi_tap_bytes([fmap], rois, torch.zeros_like(rois[..., 0]), scale)
                + rois.numel() * 4)
    flops = b * 80 * 8 * 8 * c * 16 * 2
    t_bytes, t_ops = (in_bytes + out_bytes) / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    print(f"  P = 8: kernel {ms:.4f} ms on the device, plain {plain_ms:.3f} ms; "
          f"{in_bytes / 1e6:.1f} MB of taps and rois + {out_bytes / 1e6:.1f} MB out "
          f"-> bound {max(t_bytes, t_ops):.4f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'}), "
          f"{(in_bytes + out_bytes) / ms / 1e6:.0f} GB/s")
    del fmap
    release()
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                max_abs_err=max(errs))


def zoo_vgg(numbers, launches, level_pool):
    """``configs/vgg_vg_predcls.yaml`` at full width: 2 eval batches of 8
    (B1 6, B3 2 a batch) with one batch's logits against the plain
    versions, 3 train steps of 12 (B1, B2a, B2b 6, B3 2, B3-bwd 1 a step)
    and one step's gradients against the plain versions, and one SGDet
    eval batch of the VGG detector whose proposals and detections through
    N1 are bit-equal to the plain walk's.  The counted runs' launches go
    into ``launches``; ``level_pool`` is phase 3's row of the 512-channel
    pools alone (:func:`vgg_level_pool`)."""
    vgg = ("test.ims_per_batch=8",)
    model, cfg, eval_ms, counted = phase_main_path(vgg, n_batches=2, config=VGG)
    add_launches(launches, counted)
    b = next(synthetic_eval_dataset_batches(cfg))
    fwd = lambda: eval_logits(model, cfg, b)  # noqa: E731
    wall, busy = cuda_ms(fwd, 2, 1), busy_ms(fwd, 2)
    del model
    release()
    state, counted = phase_train(3, vgg, what="VGG-16", config=VGG)
    add_launches(launches, counted)
    phase_train_grads(state, vgg, what="VGG-16", config=VGG)
    train_ms, train_peak = TRAIN_MS["VGG-16"]
    del state
    release()
    sg = ("relation.use_gt_box=False", "relation.use_gt_object_label=False")
    print(f"[zoo, VGG-16 SGDet] {VGG} {' '.join(sg)}: one eval batch of 8")
    model, cfg, b, sigma = sgdet_eval_model(VGG, sg)
    per = expected(**sgdet_launches(cfg))
    sgdet_ms, sgdet_peak, _, counted = counted_evaluate(model, cfg, 1,
                                                        "VGG-16 SGDet eval", per)
    add_launches(launches, counted)
    nd, _ = sgdet_ladder(model, cfg, b)
    walk = vgg_rpn_walk(model, b)
    del model
    release()
    numbers["VGG-16"] = dict(eval_ms=eval_ms, eval_forward_ms=wall,
                             eval_busy_share=busy / wall, train_ms=train_ms,
                             train_peak_gib=train_peak / 2 ** 30, sgdet_eval_ms=sgdet_ms,
                             sgdet_peak_gib=sgdet_peak / 2 ** 30, cls_score_sigma=sigma,
                             detections=nd, level_pool=level_pool, rpn_walk=walk)


def vgg_rpn_walk(model, b):
    """N1 on the VGG detector's RPN walk of batch ``b``: the one level's
    6000 best anchors an image, as ``propose`` hands them to the greedy
    walk (recorded there), timed alone against its bound and the plain
    walk."""
    from veto_tpu_torch.ops import nms as tn

    seen, real = [], tn.greedy_keep_sorted

    def record(boxes, active, thr, m, *args):
        seen.append((boxes.float().contiguous(), active.contiguous(), thr, m))
        return real(boxes, active, thr, m, *args)

    tn.greedy_keep_sorted = record
    try:
        with torch.inference_mode():
            obj, reg = model.rpn_maps(model.extract_features(b.images))
            model.propose(obj, reg, b.sizes)
    finally:
        tn.greedy_keep_sorted = real
    boxes, active, thr, m = seen[0]
    keep = real(boxes, active, thr, m)
    return n1_row(f"VGG-16 RPN walk {tuple(active.shape)}, IoU {thr}, {m} keeps",
                  boxes, active, thr, m, keep)


def synthetic_eval_dataset_batches(cfg):
    """The synthetic eval split's batches of the config, on the card."""
    from veto_tpu_torch.tools.relation_test_net import synthetic_eval_dataset

    bsz = cfg.test.ims_per_batch
    for batch, _ in synthetic_eval_dataset(cfg, bsz).batches(bsz, cfg.data.max_boxes):
        yield batch.to(DEVICE)


def zoo_grads(predictor, opts):
    """One PredCls step's gradients through the kernels against the plain
    versions, in f32 (as phase 19 holds them), two kernel runs of the step
    bit-equal: the predictors' segment sums and gathers are products with
    the incidence matrix, with no atomics.  cuDNN runs its deterministic
    algorithms for this check: its default weight-gradient algorithm for
    the union features' first rect conv (shared by every legacy predictor)
    adds in another order from run to run (on an NVIDIA H100 without it,
    ``union_extractor.rect_conv1.weight`` was the one tensor that
    varied)."""
    from veto_tpu_torch.engine.train import create_train_state
    from veto_tpu_torch.tools.relation_train_net import rel_class_weights

    opts = (*opts, "dtype=float32")
    cfg = legacy_cfg(PREDCLS, predictor, opts)
    model, _ = legacy_model(cfg, None)
    state = create_train_state(model, cfg.solver, rel_class_weights(cfg),
                               mode=cfg.relation.mode)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        phase_train_grads(state, (f"relation.predictor={predictor}", *opts),
                          what=f"{predictor} PredCls, f32, cuDNN deterministic",
                          exact_floor=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del state, model
    release()


def check_zoo_logits(model, cfg, b, what):
    """:func:`check_legacy_logits`; for BGNN / MSDN with ``rel_aware`` the
    relness pre-classifier's logits too, at the same tolerances, and each
    run's message filter recomputed on the CPU from the scores it saw (the
    ``>=`` threshold at the ``mp_valid_pairs``-th valid score of each
    image, ties passing).  The two runs' filters may then differ only at
    pairs whose score lies within the runs' score difference of the
    threshold, a band that the relness logits' tolerance bounds (the
    sigmoid's slope is at most 1/4); the relation logits are compared with
    the plain run's filter given to both: the threshold is a selection that
    a last-bit difference of a bf16 pooled feature can flip, as VCTree's
    forest is."""
    from veto_tpu_torch.ops import cuda_lib

    head = model.relation
    if not getattr(head, "rel_aware", False):
        return check_legacy_logits(model, cfg, b, what)
    real, seen = head.message_pairs, {}

    def run(key, keep=None):
        def message_pairs(scores, pair_mask):
            out = real(scores, pair_mask) if keep is None else keep
            seen[key] = (scores.double().cpu(), pair_mask.cpu(), out.cpu())
            return out

        head.message_pairs = message_pairs
        try:
            return eval_forward(model, cfg, b)
        finally:
            del head.message_pairs

    out = run("kernels")
    with cuda_lib.plain_kernels():
        ref = run("plain")
    got = run("pinned", keep=seen["plain"][2].to(DEVICE)).rel_logits
    g, r = out.relness_logits, ref.relness_logits
    check_close(f"{what} relness logits", g, r, atol=0.05 * float(r.abs().max()),
                rtol=0.0, mean_tol=0.01 * float(r.abs().mean()))
    kth = {}
    for key in ("kernels", "plain"):
        scores, mask, keep = seen[key]
        masked = torch.where(mask, scores, float("-inf"))
        kth[key] = torch.topk(masked, min(head.mp_valid_pairs, mask.shape[1]),
                              dim=-1).values[..., -1:]
        if not torch.equal(keep, mask & (masked >= kth[key])):
            raise AssertionError(f"{what}: the {key} run's message filter is not the "
                                 "threshold at the k-th score")
    (sk, mask, keep_k), (sp, _, keep_p) = seen["kernels"], seen["plain"]
    moved = keep_k != keep_p
    band = float((sk - sp).abs()[mask].max() + (kth["kernels"] - kth["plain"]).abs().max())
    off = float((sp - kth["plain"]).abs()[moved].max()) if moved.any() else 0.0
    print(f"  {what}: kernels vs plain; the two runs' message filters differ at "
          f"{int(moved.sum())} of {int(keep_p.sum())} passing pairs, each within "
          f"{off:.3e} of the plain threshold (band {band:.3e}: the runs' largest "
          "score and threshold differences); the logits compared on the plain "
          "run's filter")
    if off > band:
        raise AssertionError(f"{what}: a filtered pair {off} from the threshold, "
                             f"outside the band {band}")
    check_close(f"{what} logits", got, ref.rel_logits,
                atol=0.05 * float(ref.rel_logits.abs().max()), rtol=0.0,
                mean_tol=0.01 * float(ref.rel_logits.abs().mean()))
    return got


def zoo_predictor(predictor, opts, b, body, numbers, launches):
    """One message-passing predictor in PredCls on the frozen R-101 body:
    one eval batch (B3 2: the box and union pools) with its logits against
    the plain versions and its busy share, one train step (B3 2, no
    B3-bwd), and the f32 step gradients of :func:`zoo_grads`.  The counted
    runs' launches go into ``launches``."""
    cfg = legacy_cfg(PREDCLS, predictor, opts)
    model, body = legacy_model(cfg, body)
    per = expected(multilevel_roi_align=2)
    eval_ms, eval_peak, counted = legacy_evaluate(model, cfg,
                                                  f"{predictor} PredCls eval", per)
    check_zoo_logits(model, cfg, b, f"{predictor} PredCls")
    out = eval_forward(model, cfg, b)
    if (out.relness_logits is not None) != ("relation.rel_aware=true" in opts):
        raise AssertionError(f"{predictor}: relness logits {out.relness_logits}")
    fwd = lambda: eval_logits(model, cfg, b)  # noqa: E731
    wall, busy = cuda_ms(fwd, 2, 1), busy_ms(fwd, 2)
    _, train_ms, train_peak, counted_train = legacy_train(model, cfg, per,
                                                          f"{predictor} train", 1)
    add_launches(launches, counted, counted_train)
    del model
    release()
    zoo_grads(predictor, opts)
    numbers[predictor] = dict(eval_ms=eval_ms, eval_forward_ms=wall,
                              eval_busy_share=busy / wall,
                              eval_peak_gib=eval_peak / 2 ** 30, train_ms=train_ms,
                              train_peak_gib=train_peak / 2 ** 30)
    print(f"  [{predictor}] eval forward {wall:.1f} ms by CUDA events, {busy:.1f} ms "
          f"busy on the device ({busy / wall:.2f})")
    return body


def zoo_other_modes(predictor, opts, body, numbers, launches):
    """SGCls (B3 3) and SGDet (B3 3, N1 2 + 2): one eval batch and one train
    step each, as phase 19 runs Motifs and VCTree; their launches go into
    ``launches``."""
    from veto_tpu_torch.tools.relation_train_net import build_dataset

    for config, per, mode in ((SGCLS, expected(multilevel_roi_align=3), "SGCls"),
                              (SGDET, expected(multilevel_roi_align=3, nms_mask=2,
                                               nms_scan=2), "SGDet")):
        cfg = legacy_cfg(config, predictor, opts)
        model, body = legacy_model(cfg, body)
        datasets = None
        if mode == "SGDet":
            b = next(synthetic_eval_dataset_batches(cfg))
            draw_cls_score(model, cfg, b)
        eval_ms, eval_peak, counted = legacy_evaluate(model, cfg,
                                                      f"{predictor} {mode} eval", per)
        if mode == "SGDet":
            datasets = (detected_gt_dataset(model, cfg), build_dataset(cfg, "val"))
        # the JAX SGDet step takes no pre_rel_classify_loss: BGNN's relness
        # pre-classifier trains in PredCls and SGCls only
        idle = ("relation.relation_conf_aware_models.",) if mode == "SGDet" else ()
        _, train_ms, train_peak, counted_train = legacy_train(
            model, cfg, per, f"{predictor} {mode} train", 1, datasets, idle)
        add_launches(launches, counted, counted_train)
        numbers[f"{predictor} {mode}"] = dict(
            eval_ms=eval_ms, train_ms=train_ms, eval_peak_gib=eval_peak / 2 ** 30,
            train_peak_gib=train_peak / 2 ** 30)
        del model
        release()
    return body


def phase_zoo(level_pool):
    """Phase 20: the VGG-16 body and the message-passing predictors at full
    width (see the module docstring); ``level_pool`` is phase 3's row of B3
    on VGG-16's level.  Returns its numbers and the launches of its counted
    runs."""
    t0 = time.perf_counter()
    numbers, launches = {}, {}
    zoo_vgg(numbers, launches, level_pool)
    print("[zoo] IMP, BGNN (relation.rel_aware=true), GPSNet, MSDN on the frozen "
          "R-101 body (context_hidden_dim 512, context_pooling_dim 4096, bf16)")
    cfg = legacy_cfg(PREDCLS, "IMPPredictor")
    b = next(synthetic_eval_dataset_batches(cfg))
    body = None
    for predictor, opts in ZOO:
        body = zoo_predictor(predictor, opts, b, body, numbers, launches)
    for predictor, opts in ZOO[:2]:
        body = zoo_other_modes(predictor, opts, body, numbers, launches)
    numbers["launches"] = {k: v for k, v in launches.items() if v}
    numbers["seconds"] = time.perf_counter() - t0
    release()
    print(f"[zoo numbers] {card()}: {json.dumps(numbers)}")
    print(f"[zoo] phase 20 took {numbers['seconds']:.1f} s")
    return numbers, launches


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
    kernels = [phase_roi_align(gen)]
    level_pool = vgg_level_pool(gen)  # phase 3 on VGG-16's 512-channel level
    kernels.append(phase_encoder(gen))
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
    phase_sgcls()
    n1, n1_launches = phase_sgdet(gen)
    kernels.append(n1)
    phase_meet()
    phase_pretrain()
    phase_heads()
    _, legacy_launches = phase_legacy()
    _, zoo_launches = phase_zoo(level_pool)
    # each kernel's launches on the training path that runs it, and those
    # of phases 19 and 20's counted runs (N1's: its mask launches)
    launches.update(pair_attention=pa_launches["pair_attention"],
                    pair_attention_backward=pa_launches["pair_attention_backward"],
                    encoder_mono_bwd=mono_launches["encoder_mono_bwd"],
                    greedy_nms=n1_launches)
    for counted in (legacy_launches, zoo_launches):
        for name, n in counted.items():
            if name in launches:
                launches[name] += n
        launches["greedy_nms"] += counted.get("nms_mask", 0)
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
