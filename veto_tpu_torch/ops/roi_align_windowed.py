"""Batched multi-level ROIAlign: the CUDA kernels and their plain versions.

Replaces the Pallas kernel of ``veto_tpu/ops/roi_align_windowed.py``
(``_windowed_pool_raw`` → ``_pool_kernel_factory``), the TPU's multi-level
ROIAlign forward.  That kernel DMAs a fixed 32x64 window of each roi's
assigned level into VMEM and falls back to the full-map separable pooler
when a roi's taps leave the window.  Window, ``fits`` check and fallback
exist only because of VMEM; the CUDA kernel (``csrc/roi_align.cu``) reads
the assigned level directly, so it equals
:func:`veto_tpu_torch.ops.roi_align.multilevel_roi_align` for every roi.

Bound on the H100: bytes.  At the PredCls eval shapes (8 images x 80 rois,
8x8 bins, 256 channels) it writes 42 MB of f32 output and reads the bf16
taps its rois touch; its arithmetic (16 multiply-adds per output) is
negligible.  The taps are separable: a sample's y depends on (bin row,
sample row) only and its x on (bin column, sample column) only, so one
block per roi computes the roi's ``P s`` row taps and ``P s`` column taps
once (:func:`axis_taps` mirrors them) and reuses them over all its bins; a
lane owns 8 consecutive bf16 channels (4 f32), so every tap is one 16-byte
load and every output one or two 16-byte stores.

The PredCls slice pools twice per batch through here: the RGB FPN levels
P2-P5 and the 1/16 depth map (one level, no level assignment).

Gradient: every call goes through a ``torch.autograd.Function`` whose
backward, for the maps that need one, is the transpose of the pooling: the
CUDA kernel ``roi_align_backward`` on the card, autograd of the plain
version on the CPU.  The kernel has no atomics: one block per (image,
level, tile of :func:`bwd_tile_rows` x :data:`BWD_TILE_W` pixels) owns its
tile, finds the rois whose taps reach it (a ballot on :func:`tap_box`; the
hits in roi order, 32 at a time), stages the bins they send the tile
(:func:`sample_range` of the tile's rows and columns) in shared memory
with each bin's separable weight at each pixel of the tile, and each
owning thread sums its pixel's contributions in f32 in one fixed order
(roi, bin row, bin column) and writes it once, in the map's dtype.
No map is zero-filled first and no cast follows; two runs give the same
bits.  In PredCls training only the trainable depth map takes it (JAX
differentiates its separable ``roi_align`` there, ``veto_tpu/models/
sgg.py:551-556``); the RGB levels come from the frozen detector and need
none.  The rois get no gradient, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from . import cuda_lib
from .roi_align import fpn_level_assignment, pool_levels

# the kernels' limits (csrc/roi_align.cu)
MAX_LEVELS = 4
MAX_AXIS = 32        # output_size * sampling_ratio: a roi's samples a side
MAX_SAMPLING = 4
BWD_THREADS = 512    # threads of a backward block
BWD_TILE_W = 8       # backward tile columns
BWD_PIX = 2          # pixels a slot of a backward block owns
MAX_UNITS = BWD_THREADS // BWD_TILE_W  # lanes a pixel's channels may take
BWD_CHUNK = 32       # hit rois whose taps a backward block holds at once
# CUDA kernel launches since the last reset: forward (B3) and backward
KERNEL_LAUNCHES = 0
BWD_LAUNCHES = 0


def lane_channels(dtype: torch.dtype) -> int:
    """Channels a lane owns: one 16-byte load of the map."""
    return 8 if dtype == torch.bfloat16 else 4


def bwd_tile_rows(channels: int, dtype: torch.dtype) -> int:
    """Rows of a backward tile (``BWD_TILE_W`` columns): a block's threads
    in slots of ``channels / lane_channels``, each slot owning ``BWD_PIX``
    pixels; 0 when the kernel cannot take the count.  Mirrors
    ``roi_align_bwd_tile_rows``."""
    v = lane_channels(dtype)
    if channels <= 0 or channels % v or channels // v > MAX_UNITS:
        return 0
    return BWD_PIX * (BWD_THREADS // (channels // v) // BWD_TILE_W)


# ------------------------------------------------- the kernels' tap rules
# numpy float32, one rounding per operation, as the kernels compute them
def roi_axis(roi, axis: int, scale: float, pooled: int):
    """A roi's start and bin size along axis 0 (x) or 1 (y) of a level."""
    f32 = np.float32
    a = f32(roi[axis]) * f32(scale)
    b = f32(roi[axis + 2]) * f32(scale)
    return a, np.maximum(b - a, f32(1.0)) / f32(pooled)


def sample_coords(start, bin_size, pooled: int, sampling: int) -> np.ndarray:
    """The coordinate of every sample k = bin * sampling + sub of one axis."""
    k = np.arange(pooled * sampling)
    off = ((k % sampling).astype(np.float32) + np.float32(0.5)) / np.float32(sampling)
    return start + ((k // sampling).astype(np.float32) + off) * bin_size


def axis_taps(coords: np.ndarray, size: int):
    """(lo, hi, wl, wh) of every sample of one axis: its low and high pixel
    and their weights; lo = hi = -1, weights 0, off the map."""
    n = np.float32(size)
    off = (coords < -1) | (coords > n)
    c = np.maximum(coords, np.float32(0))
    low = np.minimum(np.floor(c), n - 1)
    high = np.minimum(low + 1, n - 1)
    c = np.where(low >= n - 1, low, c)
    frac = c - low
    lo = np.where(off, -1, low.astype(np.int64))
    hi = np.where(off, -1, high.astype(np.int64))
    return (lo, hi, np.where(off, np.float32(0), np.float32(1) - frac),
            np.where(off, np.float32(0), frac))


def roi_taps(roi, scale: float, pooled: int, sampling: int, h: int, w: int):
    """The row taps and the column taps of one roi on an h x w level."""
    ys, yb = roi_axis(roi, 1, scale, pooled)
    xs, xb = roi_axis(roi, 0, scale, pooled)
    return (axis_taps(sample_coords(ys, yb, pooled, sampling), h),
            axis_taps(sample_coords(xs, xb, pooled, sampling), w))


def tap_box(roi, scale: float, pooled: int, sampling: int, h: int, w: int):
    """The backward ballot's bounding box ((y0, y1), (x0, x1)), inclusive:
    the first sample's low tap to the last sample's high tap of each axis,
    on or off the map (coordinates rise with the sample index)."""
    out = []
    for axis, size in ((1, h), (0, w)):
        start, bin_size = roi_axis(roi, axis, scale, pooled)
        c = sample_coords(start, bin_size, pooled, sampling)[[0, -1]]
        low = np.minimum(np.floor(np.maximum(c, np.float32(0))), np.float32(size - 1))
        out.append((int(low[0]), int(min(low[1] + 1, size - 1))))
    return tuple(out)


def footprint(roi, scale: float, pooled: int, sampling: int, h: int, w: int):
    """The pixels a roi's taps reach on a level, ((y0, y1), (x0, x1))
    inclusive, or None: from the low tap of the first sample on the map to
    the high tap of the last, on each axis."""
    (ylo, yhi, _, _), (xlo, xhi, _, _) = roi_taps(roi, scale, pooled, sampling, h, w)
    if (ylo < 0).all() or (xlo < 0).all():
        return None
    on_y, on_x = ylo >= 0, xlo >= 0
    return ((int(ylo[on_y].min()), int(yhi[on_y].max())),
            (int(xlo[on_x].min()), int(xhi[on_x].max())))


def sample_range(lo: np.ndarray, hi: np.ndarray, p0: int, p1: int):
    """The samples [k0, k1) of one axis whose taps land in pixels [p0, p1)
    (k0 >= k1 when none): a backward block stages the bins of these samples
    along its tile's rows (columns)."""
    k = np.nonzero(((lo >= p0) & (lo < p1)) | ((hi >= p0) & (hi < p1)))[0]
    return (int(k[0]), int(k[-1]) + 1) if k.size else (0, 0)


# ------------------------------------------------------------ plain versions
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


class _RoiAlign(torch.autograd.Function):
    """Pooling with the owner-computes backward; no gradient for the rois."""

    @staticmethod
    def forward(ctx, rois, scales, output_size, sampling_ratio, *feats):
        ctx.save_for_backward(rois, *feats)
        ctx.args = (scales, output_size, sampling_ratio)
        if cuda_lib.use_kernel(rois):
            return _launch(feats, rois, scales, output_size, sampling_ratio)
        return reference_multilevel_roi_align_batched(
            feats, rois, scales, output_size, sampling_ratio)

    @staticmethod
    def backward(ctx, grad):
        rois, *feats = ctx.saved_tensors
        need = ctx.needs_input_grad[4:]
        scales, p, s = ctx.args
        if cuda_lib.use_kernel(grad):
            grads = _launch_backward(feats, need, rois, grad, scales, p, s)
        else:
            grads = reference_multilevel_roi_align_backward(
                feats, need, rois, grad, scales, p, s)
        return (None, None, None, None, *grads)


def reference_multilevel_roi_align_backward(feats, need, rois, grad, scales,
                                            output_size, sampling_ratio):
    """Plain backward: autograd of the plain pooling, taken in f32 (f32
    copies of the maps, so the scatter sums in f32 as the kernel does) and
    cast to each map's dtype; None for the maps not in ``need``, zeros for
    a map that no roi is assigned to."""
    with torch.enable_grad():
        leaves = [f.detach().float().requires_grad_(n) for f, n in zip(feats, need)]
        out = reference_multilevel_roi_align_batched(
            leaves, rois, scales, output_size, sampling_ratio)
        wrt = [f for f, n in zip(leaves, need) if n]
        got = iter(torch.autograd.grad(out, wrt, grad, allow_unused=True))
    grads = []
    for f, n in zip(feats, need):
        g = next(got) if n else None
        grads.append(None if not n else torch.zeros_like(f) if g is None
                     else g.to(f.dtype))
    return grads


def multilevel_roi_align_batched(
        feats: Sequence[torch.Tensor], rois: torch.Tensor,
        scales: Sequence[float], output_size: int,
        sampling_ratio: int = 2) -> torch.Tensor:
    """Batched multi-level ROIAlign → (B, R, P, P, C) f32.

    feats: per level (B, H_l, W_l, C) NHWC, finest first, bf16 or f32;
    rois: (B, R, 4) xyxy image coords.  One level means single-level
    pooling (every roi at that level).  CUDA tensors launch the kernels
    (and raise on what they cannot take, see :func:`_check`), CPU tensors
    run the plain version; differentiable in the maps.
    """
    if sampling_ratio <= 0:
        raise ValueError("adaptive sampling_ratio not supported; configs use 2")
    if len(feats) != len(scales):
        raise ValueError("one scale per level")
    return _RoiAlign.apply(rois, tuple(scales), output_size, sampling_ratio,
                           *feats)


# ------------------------------------------------------------ the launches
def _level_arrays(maps, scales, ptrs):
    """ctypes arrays of the per-level pointers (``ptrs``: the maps' own in
    the forward, their gradients' in the backward), heights, widths,
    scales."""
    return ((ctypes.c_void_p * MAX_LEVELS)(*ptrs),
            (ctypes.c_int * MAX_LEVELS)(*[f.shape[1] for f in maps]),
            (ctypes.c_int * MAX_LEVELS)(*[f.shape[2] for f in maps]),
            (ctypes.c_float * MAX_LEVELS)(*scales))


def _entry(name):
    """The library and its C entry ``name`` (both take the same arguments:
    four per-level arrays, the level count, three pointers, six ints and
    the stream)."""
    lib = cuda_lib.library("roi_align")
    fn = getattr(lib, name)
    if fn.argtypes is None:  # first use: ctypes would pass 32-bit ints
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def _check(feats, rois, p, s):
    """Refuse what the kernels cannot take, before any library is loaded:
    a dtype other than f32/bf16 (``TypeError``); more than four levels,
    output_size x sampling_ratio over ``MAX_AXIS``, sampling_ratio over
    ``MAX_SAMPLING``, channels not a whole number of lanes (8 bf16, 4 f32)
    or more than ``MAX_UNITS`` lanes, maps that are not contiguous NHWC of
    one dtype and device or not 16-byte aligned (``ValueError``); then
    tensors that are not on a CUDA device (``TypeError``)."""
    if not 1 <= len(feats) <= MAX_LEVELS:
        raise ValueError(f"the kernel takes 1..{MAX_LEVELS} levels, got {len(feats)}")
    if p <= 0 or not 1 <= s <= MAX_SAMPLING or p * s > MAX_AXIS:
        raise ValueError(f"output_size {p} x sampling_ratio {s}: the kernel takes "
                         f"sampling_ratio 1..{MAX_SAMPLING} and at most "
                         f"{MAX_AXIS} samples a side")
    b = rois.shape[0]
    c = feats[0].shape[-1]
    dtype = feats[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"feature maps must be f32 or bf16, got {dtype}")
    v = lane_channels(dtype)
    if c % v or c // v > MAX_UNITS:
        raise ValueError(f"{c} channels: the kernel takes multiples of {v} up "
                         f"to {v * MAX_UNITS} for {dtype} maps")
    for f in feats:
        if (f.device != rois.device or f.dtype != dtype or f.dim() != 4
                or f.shape[0] != b or f.shape[-1] != c
                or not f.is_contiguous() or f.data_ptr() % 16):
            raise ValueError("levels must be contiguous, 16-byte aligned NHWC "
                             "(B, H, W, C) maps of one dtype on the rois' device")
    if rois.dtype != torch.float32 or rois.shape[-1] != 4 or rois.dim() != 3:
        raise ValueError("rois must be (B, R, 4) float32")
    if not rois.is_cuda:
        raise TypeError("the ROIAlign kernels take CUDA tensors; the plain "
                        "version serves CPU tensors")


def _launch(feats, rois, scales, p, s):
    global KERNEL_LAUNCHES
    if torch.is_grad_enabled() and any(f.requires_grad for f in feats):
        raise RuntimeError("the CUDA ROIAlign forward records no gradient; "
                           "call multilevel_roi_align_batched, whose autograd "
                           "Function runs the backward kernel")
    _check(feats, rois, p, s)
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    rois = rois.contiguous()
    levels = _levels(rois, len(feats)).contiguous()
    out = torch.empty((b, r, p, p, c), dtype=torch.float32, device=rois.device)
    if out.numel() == 0:
        return out
    lib, fn = _entry("roi_align_forward")
    status = fn(*_level_arrays(feats, scales, [f.data_ptr() for f in feats]),
                len(feats), rois.data_ptr(),
                levels.data_ptr(), out.data_ptr(), b, r, c, p, s,
                int(feats[0].dtype == torch.bfloat16),
                cuda_lib.stream_ptr(rois.device))
    cuda_lib.check(lib, status, "roi_align_forward")
    KERNEL_LAUNCHES += 1
    return out


def _launch_backward(feats, need, rois, grad, scales, p, s):
    """Gradients of the maps in ``need`` (the rest None), each in its map's
    dtype: the kernel writes every element of each once, with no atomics,
    no zero-fill and no cast pass."""
    global BWD_LAUNCHES
    _check(feats, rois, p, s)
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    if grad.shape != (b, r, p, p, c) or grad.dtype != torch.float32:
        raise ValueError(f"grad must be f32 {(b, r, p, p, c)}")
    grad = grad.contiguous()
    if grad.data_ptr() % 16:  # a view into a larger buffer: 16-byte loads
        grad = grad.clone()
    grads = [torch.empty_like(f) if n else None for f, n in zip(feats, need)]
    if any(g is not None and g.numel() for g in grads):
        rois = rois.contiguous()
        levels = _levels(rois, len(feats)).contiguous()
        lib, fn = _entry("roi_align_backward")
        ptrs = [0 if g is None else g.data_ptr() for g in grads]
        status = fn(*_level_arrays(feats, scales, ptrs), len(feats),
                    rois.data_ptr(), levels.data_ptr(), grad.data_ptr(), b, r, c,
                    p, s, int(feats[0].dtype == torch.bfloat16),
                    cuda_lib.stream_ptr(rois.device))
        cuda_lib.check(lib, status, "roi_align_backward")
        BWD_LAUNCHES += 1
    return grads
