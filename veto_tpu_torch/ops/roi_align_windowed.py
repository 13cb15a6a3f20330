"""Batched multi-level ROIAlign: the CUDA kernel and its plain version.

Replaces the Pallas kernel of ``veto_tpu/ops/roi_align_windowed.py``
(``_windowed_pool_raw`` → ``_pool_kernel_factory``), the TPU's multi-level
ROIAlign forward.  That kernel DMAs a fixed 32x64 window of each roi's
assigned level into VMEM and falls back to the full-map separable pooler
when a roi's taps leave the window.  Window, ``fits`` check and fallback
exist only because of VMEM; the CUDA kernel (``csrc/roi_align.cu``) reads
the assigned level directly, so it equals
:func:`veto_tpu_torch.ops.roi_align.multilevel_roi_align` for every roi.

Bound on the H100: memory.  At the PredCls eval shapes (8 images x 80
rois, 8x8 bins, 256 channels) it writes 42 MB of f32 output and reads the
bf16 taps its rois touch; its arithmetic (16 multiply-adds per output) is
negligible, so its floor is those bytes over 3.35 TB/s.  Design: one block
per (roi, bin row), threads across channels so every NHWC tap load is
coalesced; the block's 2x2 sample taps and weights are computed once into
shared memory; f32 weights and f32 accumulation.

The PredCls slice pools twice per batch through here: the RGB FPN levels
P2-P5 and the 1/16 depth map (one level, no level assignment).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import cuda_lib
from .roi_align import fpn_level_assignment, pool_levels

MAX_LEVELS = 4
KERNEL_LAUNCHES = 0  # CUDA kernel launches since the last reset


def _levels(rois: torch.Tensor, num_levels: int) -> torch.Tensor:
    if num_levels == 1:  # single-level pooling skips the level mapper
        return torch.zeros(rois.shape[:2], dtype=torch.int32, device=rois.device)
    return fpn_level_assignment(rois)


def reference_multilevel_roi_align_batched(
        feats: Sequence[torch.Tensor], rois: torch.Tensor,
        scales: Sequence[float], output_size: int,
        sampling_ratio: int = 2) -> torch.Tensor:
    """Plain version: per-level gather pooling, (B, R, P, P, C) f32."""
    return pool_levels(feats, rois, _levels(rois, len(feats)), scales,
                       output_size, sampling_ratio)


def multilevel_roi_align_batched(
        feats: Sequence[torch.Tensor], rois: torch.Tensor,
        scales: Sequence[float], output_size: int,
        sampling_ratio: int = 2) -> torch.Tensor:
    """Batched multi-level ROIAlign → (B, R, P, P, C) f32.

    feats: per level (B, H_l, W_l, C) NHWC, finest first, bf16 or f32;
    rois: (B, R, 4) xyxy image coords.  One level means single-level
    pooling (every roi at that level).  CUDA tensors launch the kernel,
    CPU tensors run the plain version.
    """
    if sampling_ratio <= 0:
        raise ValueError("adaptive sampling_ratio not supported; configs use 2")
    if len(feats) != len(scales):
        raise ValueError("one scale per level")
    if not cuda_lib.use_kernel(rois):
        return reference_multilevel_roi_align_batched(
            feats, rois, scales, output_size, sampling_ratio)
    return _launch(feats, rois, scales, output_size, sampling_ratio)


def _launch(feats, rois, scales, p, s):
    global KERNEL_LAUNCHES
    n_lv = len(feats)
    if not 1 <= n_lv <= MAX_LEVELS:
        raise ValueError(f"the kernel takes 1..{MAX_LEVELS} levels, got {n_lv}")
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    dtype = feats[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"feature maps must be f32 or bf16, got {dtype}")
    for f in feats:
        if (f.device != rois.device or f.dtype != dtype or f.dim() != 4
                or f.shape[0] != b or f.shape[-1] != c
                or not f.is_contiguous()):
            raise ValueError("levels must be contiguous NHWC (B, H, W, C) "
                             "maps of one dtype on the rois' device")
    if rois.dtype != torch.float32 or rois.shape[-1] != 4 or rois.dim() != 3:
        raise ValueError("rois must be (B, R, 4) float32")
    rois = rois.contiguous()
    levels = _levels(rois, n_lv).contiguous()
    out = torch.empty((b, r, p, p, c), dtype=torch.float32, device=rois.device)
    if out.numel() == 0:
        return out
    lib = cuda_lib.library("roi_align")
    fn = lib.roi_align_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    ptrs = (ctypes.c_void_p * MAX_LEVELS)(*[f.data_ptr() for f in feats])
    hs = (ctypes.c_int * MAX_LEVELS)(*[f.shape[1] for f in feats])
    ws = (ctypes.c_int * MAX_LEVELS)(*[f.shape[2] for f in feats])
    sc = (ctypes.c_float * MAX_LEVELS)(*scales)
    status = fn(ptrs, hs, ws, sc, n_lv, rois.data_ptr(), levels.data_ptr(),
                out.data_ptr(), b, r, c, p, s, int(dtype == torch.bfloat16),
                cuda_lib.stream_ptr(rois.device))
    cuda_lib.check(lib, status, "roi_align_forward")
    KERNEL_LAUNCHES += 1
    return out
