"""The NMS family (``veto_tpu/ops/nms.py``): greedy IoU suppression for the
RPN and the box head's per-class filter, and the object-label NMS.

Greedy suppression (``nms``, ``batched_nms``, ``multiclass_nms_mask``) keeps,
in score order, every box whose IoU with each earlier kept box is at most
the threshold (strictly greater suppresses), and cuts the keeps at a
budget.  Each call solves many independent problems at once (the RPN's
(image, level) walks, the box head's (image, class) walks): sorting stays
plain tensor code (one stable sort on the negated score, ties to the lower
index, as the JAX package's ``lax.sort``), and the walk over the sorted
boxes, :func:`greedy_keep_sorted`, is

  * on a CUDA tensor, kernel N1 (``csrc/nms.cu``): ``nms_mask_kernel``
    writes the IoU bitmask of every box against the later boxes, then
    ``nms_scan_kernel`` walks the rows in order on the card, one warp per
    problem, and stops at the budget: two launches per call, whatever the
    number of problems, and no synchronisation with the host;
  * on a CPU tensor, its plain version: the JAX package's blockwise walk
    (``_greedy_keep_sorted_coords``), with the block fixpoint as a Python
    loop.

``nms_sequential`` (one kept box per trip) is the semantics reference the
tests hold both against.  The IoU is f32 with ``TO_REMOVE``, in the JAX
package's order of operations; the kernel rounds each operation as it
does (no contraction into FMAs).

The object-label NMS (``obj_prediction_nms``) is the global-argmax label
assignment that SGCls runs over the frozen box head's logits (and SGDet
over its detections), batched over images: the JAX package vmaps its
per-image ``fori_loop``, the port runs the same N trips on a (B, N, C)
tensor.  Every trip is a fixed sequence of tensor ops: no ``.item()``, no
branch on the data, so the card never waits for the host inside the loop.
It stays plain PyTorch: the JAX package has no Pallas kernel for it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import cuda_lib
from .box_ops import TO_REMOVE, box_area

_NEG_INF = -1e10
TILE = 64               # boxes a side of a mask tile (csrc/nms.cu)
SCAN_WARPS = 4          # problems a scan block walks, one warp each
SCAN_SMEM_MAX = 48 * 1024  # the scan's shared memory, without opt-in
MAX_PROBLEMS = 65535    # the mask grid's z extent
# kernel N1's launches since the last reset: the mask and the scan
MASK_LAUNCHES = 0
SCAN_LAUNCHES = 0


def first_argmax(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Index of the first maximal entry along the last axis of a NaN-free
    ``x``, as ``jnp.argmax`` defines it; ``idx`` is ``arange`` over that
    axis, expanded to ``x``'s shape.  The rule is written out, not left to
    ``torch.argmax``'s tie order on a device: the NMS picks among exact
    ties on nearly every trip."""
    top = x.amax(-1, keepdim=True)
    return torch.where(x == top, idx, x.shape[-1]).amin(-1)


def class_overlaps(boxes_per_cls: torch.Tensor,
                   nms_thresh: float) -> torch.Tensor:
    """(B, N, C, 4) boxes → (B, C, N, N) bool: the class-c IoU of boxes i
    and j, with ``TO_REMOVE``, is at least ``nms_thresh`` (``nms_overlaps``
    of the reference, in the JAX package's f32 arithmetic)."""
    bpc = boxes_per_cls.float().transpose(1, 2)            # (B, C, N, 4)
    lt = torch.maximum(bpc[:, :, :, None, :2], bpc[:, :, None, :, :2])
    rb = torch.minimum(bpc[:, :, :, None, 2:], bpc[:, :, None, :, 2:])
    wh = torch.clamp(rb - lt + TO_REMOVE, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = box_area(bpc)
    iou = inter / (area[..., :, None] + area[..., None, :] - inter)
    return iou >= nms_thresh


def obj_prediction_nms(boxes_per_cls: torch.Tensor, pred_logits: torch.Tensor,
                       nms_thresh: float = 0.3,
                       valid_mask: Optional[torch.Tensor] = None,
                       overwrite: bool = False,
                       bg_init: Optional[float] = None) -> torch.Tensor:
    """Per-box labels (B, N) int32 from (B, N, C, 4) boxes and (B, N, C)
    logits; 0 is background or never assigned.

    ``prob = softmax(logits)``, the background column set to ``bg_init``
    (default 0, or -1 with ``overwrite``), masked boxes' rows to -1.  Then N
    trips, each in every image at once: take the first maximal (box, class)
    of the flattened box-major (N, C) table; label the box with the class
    if it has no label yet (always, with ``overwrite``); zero that class
    for every box whose class IoU with it is at least ``nms_thresh``;
    retire the box's row with -1.  A table with nothing left above -1 picks
    box 0, class 0, as ``jnp.argmax`` does, and the trip goes on with it.
    A NaN counts as the maximum, as in ``jnp.argmax``: NaNs become +inf
    once, which no probability reaches, so every pick is the same.

    A trip is 15 launches (13 with ``overwrite``), each over the whole
    batch.
    """
    b, n, c = pred_logits.shape
    dev = pred_logits.device
    prob = torch.softmax(pred_logits.float(), dim=-1)
    if bg_init is None:
        bg_init = -1.0 if overwrite else 0.0
    prob[..., 0] = bg_init
    if valid_mask is not None:
        prob = torch.where(valid_mask[..., None], prob, -1.0)
    prob = torch.where(prob.isnan(), float("inf"), prob).contiguous()
    flat = prob.view(b, n * c)
    # the overlap of every box with a picked (box, class): row box * C + cls
    # of a (B, N * C, N) table, so the flat pick indexes it directly
    overlap = (class_overlaps(boxes_per_cls, nms_thresh).transpose(1, 2)
               .reshape(b, n * c, n))
    labels = torch.zeros((b, n), dtype=torch.long, device=dev)
    flat_ar = torch.arange(n * c, device=dev).expand(b, n * c)
    boxes_ar = torch.arange(n, device=dev)
    cls_ar = torch.arange(c, device=dev)
    for _ in range(n):
        pick = first_argmax(flat, flat_ar)
        box, cls = pick // c, pick % c
        row = boxes_ar == box[:, None]                       # (B, N)
        take = row if overwrite else row & (labels <= 0)
        labels = torch.where(take, cls[:, None], labels)
        suppress = overlap.gather(1, pick[:, None, None].expand(b, 1, n))
        prob.masked_fill_(suppress.view(b, n, 1)
                          & (cls_ar == cls[:, None])[:, None, :], 0.0)
        prob.masked_fill_(row[:, :, None], -1.0)
    return labels.to(torch.int32)


# ---------------------------------------------------------------- greedy NMS
def mask_words(n: int) -> int:
    """64-bit words of a mask row of ``n`` boxes."""
    return -(-n // TILE)


def scan_smem_bytes(n: int) -> int:
    """Shared memory of one scan block (``nms_scan_smem_bytes`` in C): each
    warp holds its problem's ``removed`` and ``kept`` words."""
    return SCAN_WARPS * 2 * mask_words(n) * 8


def _iou_coords(a: Sequence[torch.Tensor], a_areas: torch.Tensor,
                b: Sequence[torch.Tensor], b_areas: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of coordinate-separated boxes: ``a`` (..., M) and ``b``
    (..., K) x1, y1, x2, y2 → (..., M, K), as ``_iou_matrix_coords``."""
    iw = (torch.minimum(a[2][..., :, None], b[2][..., None, :])
          - torch.maximum(a[0][..., :, None], b[0][..., None, :]) + TO_REMOVE)
    ih = (torch.minimum(a[3][..., :, None], b[3][..., None, :])
          - torch.maximum(a[1][..., :, None], b[1][..., None, :]) + TO_REMOVE)
    inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
    return inter / (a_areas[..., :, None] + b_areas[..., None, :] - inter)


def reference_greedy_keep(boxes: torch.Tensor, active: torch.Tensor,
                          iou_threshold: float, max_outputs: int,
                          block: int = 512,
                          early_exit: bool = False) -> torch.Tensor:
    """The plain walk: the JAX package's ``_greedy_keep_sorted_coords`` over
    G problems at once.  ``boxes`` (G, N, 4) f32 sorted by descending score,
    ``active`` (G, N) bool (selectable; the active boxes form a prefix) →
    (G, N) bool, the first ``max_outputs`` greedy keeps.

    Block by block: suppress the block by the keeps before it (one (block,
    N) IoU plane), then iterate ``keep_i = active_i & !any_{j<i}(iou_ji > t &
    keep_j)`` inside the block to its fixpoint (a Python loop).
    ``early_exit`` stops once every problem is past its active prefix or
    has ``max_outputs`` keeps; that changes no result."""
    g, n = active.shape
    block = max(1, min(block, n))
    pad = (-n) % block
    co = [F.pad(boxes[..., k].float(), (0, pad)) for k in range(4)]
    act_p = F.pad(active, (0, pad))
    areas = (co[2] - co[0] + TO_REMOVE) * (co[3] - co[1] + TO_REMOVE)
    upper = torch.ones((block, block), dtype=torch.bool,
                       device=active.device).triu(1)
    pos = torch.arange(n + pad, device=active.device)
    keep = torch.zeros_like(act_p)
    n_active = int(act_p.sum(1).max()) if early_exit else 0
    for lo in range(0, n + pad, block):
        if early_exit and (lo >= n_active
                           or bool((keep.sum(1) >= max_outputs).all())):
            break
        sl = slice(lo, lo + block)
        iou = _iou_coords([c[:, sl] for c in co], areas[:, sl], co, areas)
        over = iou > iou_threshold                        # (G, block, Npad)
        prev = keep & (pos < lo)
        act = act_p[:, sl] & ~(over & prev[:, None, :]).any(2)
        omat = over[:, :, sl] & upper
        k = act
        while True:
            knew = act & ~(omat & k[:, :, None]).any(1)
            if torch.equal(knew, k):
                break
            k = knew
        keep[:, sl] = k
    keep = keep[:, :n]
    return keep & (keep.cumsum(1) - 1 < max_outputs)


def _check_greedy(boxes: torch.Tensor, active: torch.Tensor) -> None:
    """Refuse what kernel N1 cannot take, before any library is loaded
    (``ValueError``, then ``TypeError`` for tensors off the card)."""
    if (boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[-1] != 4
            or not boxes.is_contiguous()):
        raise ValueError("boxes must be contiguous (G, N, 4) float32")
    if (active.dtype != torch.bool or tuple(active.shape) != tuple(boxes.shape[:2])
            or not active.is_contiguous()):
        raise ValueError("active must be a contiguous (G, N) bool tensor")
    g, n = active.shape
    if not 1 <= g <= MAX_PROBLEMS:
        raise ValueError(f"{g} problems: the kernel takes 1..{MAX_PROBLEMS}")
    if scan_smem_bytes(n) > SCAN_SMEM_MAX:
        raise ValueError(f"N = {n}: the scan's removed words need "
                         f"{scan_smem_bytes(n)} bytes of shared memory, more "
                         f"than the {SCAN_SMEM_MAX} it plans for")
    if not (boxes.is_cuda and active.is_cuda and boxes.device == active.device):
        raise TypeError("kernel N1 takes CUDA tensors on one device; the plain "
                        "walk serves CPU tensors")


def _entry(name: str, argtypes):
    lib = cuda_lib.library("nms")
    fn = getattr(lib, name)
    if fn.argtypes is None:  # first use: ctypes would pass 32-bit ints
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


def _launch_greedy(boxes: torch.Tensor, active: torch.Tensor,
                   iou_threshold: float, max_outputs: int) -> torch.Tensor:
    """Kernel N1 on the card: the mask, then the scan → (G, N) bool."""
    global MASK_LAUNCHES, SCAN_LAUNCHES
    _check_greedy(boxes, active)
    g, n = active.shape
    words = mask_words(n)
    mask = torch.empty((g, n, words), dtype=torch.int64, device=boxes.device)
    keep = torch.empty((g, n), dtype=torch.bool, device=boxes.device)
    stream = cuda_lib.stream_ptr(boxes.device)
    lib, fn = _entry("nms_mask", [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_float, ctypes.c_void_p,
                                  ctypes.c_void_p])
    # the threshold as the f32 the JAX package compares with (weak type)
    cuda_lib.check(lib, fn(boxes.data_ptr(), g, n, float(torch.tensor(
        iou_threshold, dtype=torch.float32)), mask.data_ptr(), stream),
        "nms_mask")
    MASK_LAUNCHES += 1
    lib, fn = _entry("nms_scan", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p])
    cuda_lib.check(lib, fn(mask.data_ptr(), active.data_ptr(), g, n,
                           max_outputs, keep.data_ptr(), stream), "nms_scan")
    SCAN_LAUNCHES += 1
    return keep


def greedy_keep_sorted(boxes: torch.Tensor, active: torch.Tensor,
                       iou_threshold: float, max_outputs: int,
                       block: int = 512, early_exit: bool = False) -> torch.Tensor:
    """Greedy keep mask of G problems of score-sorted boxes: ``boxes`` (G, N,
    4), ``active`` (G, N) bool → (G, N) bool, at most ``max_outputs`` keeps
    a problem.  Kernel N1 on a CUDA tensor, the plain walk on a CPU tensor
    (``block`` and ``early_exit`` shape only the plain walk's work)."""
    if max_outputs < 1 or active.shape[-1] == 0:
        return torch.zeros_like(active)
    if cuda_lib.use_kernel(boxes):
        return _launch_greedy(boxes.float().contiguous(), active.contiguous(),
                              iou_threshold, max_outputs)
    return reference_greedy_keep(boxes, active, iou_threshold, max_outputs,
                                 block, early_exit)


def _sorted_problems(boxes: torch.Tensor, live: torch.Tensor):
    """One stable sort of each row of ``live`` (G, N) on the negated score
    (ties to the lower index): the sorted boxes (G, N, 4) f32, the original
    indices and the active mask."""
    _, order = torch.sort(-live, dim=-1, stable=True)
    sboxes = torch.gather(boxes.float(), 1, order[..., None].expand(boxes.shape))
    active = torch.gather(live, 1, order) > _NEG_INF / 2
    return sboxes, order, active


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_outputs: int, valid_mask: Optional[torch.Tensor] = None,
        block: int = 512, early_exit: bool = False
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of each problem: ``boxes`` (..., N, 4) xyxy, ``scores``
    (..., N), ``valid_mask`` (..., N) (False is never selected) →
    ``(indices, ok)``, each (..., max_outputs): the kept boxes' indices in
    descending-score keep order (padding 0) and the mask of real keeps."""
    lead, n = scores.shape[:-1], scores.shape[-1]
    live = scores.float().reshape(-1, n)
    if valid_mask is not None:
        live = torch.where(valid_mask.reshape(-1, n), live, _NEG_INF)
    sboxes, order, active = _sorted_problems(boxes.reshape(-1, n, 4), live)
    keep = greedy_keep_sorted(sboxes, active, iou_threshold, max_outputs,
                              block, early_exit)
    g = live.shape[0]
    spos = torch.where(keep, keep.cumsum(1) - 1, max_outputs)
    out_idx = torch.zeros((g, max_outputs + 1), dtype=torch.int64,
                          device=live.device)
    out_idx.scatter_(1, spos, order)      # slot max_outputs: dropped
    out_ok = torch.zeros((g, max_outputs + 1), dtype=torch.bool,
                         device=live.device)
    out_ok.scatter_(1, spos, keep)
    return (out_idx[:, :max_outputs].to(torch.int32).reshape(lead + (max_outputs,)),
            out_ok[:, :max_outputs].reshape(lead + (max_outputs,)))


def nms_sequential(boxes: torch.Tensor, scores: torch.Tensor,
                   iou_threshold: float, max_outputs: int,
                   valid_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select-argmax greedy NMS, one kept box per trip (the JAX package's
    ``nms_sequential``): the semantics reference of :func:`nms`, batched
    over leading axes the same way."""
    lead, n = scores.shape[:-1], scores.shape[-1]
    bx = boxes.float().reshape(-1, n, 4)
    live = scores.float().reshape(-1, n)
    if valid_mask is not None:
        live = torch.where(valid_mask.reshape(-1, n), live, _NEG_INF)
    g = live.shape[0]
    areas = box_area(bx)
    idx_ar = torch.arange(n, device=live.device).expand(g, n)
    out_idx = torch.zeros((g, max_outputs), dtype=torch.int32, device=live.device)
    out_ok = torch.zeros((g, max_outputs), dtype=torch.bool, device=live.device)
    rows = torch.arange(g, device=live.device)
    for i in range(min(max_outputs, n)):
        idx = first_argmax(live, idx_ar)
        ok = live[rows, idx] > _NEG_INF / 2
        pick = bx[rows, idx]                                       # (G, 4)
        iou = _iou_coords([pick[:, k, None] for k in range(4)], areas[rows, idx][:, None],
                          [bx[..., k] for k in range(4)], areas)[:, 0]
        live = torch.where((iou > iou_threshold) & ok[:, None], _NEG_INF, live)
        live = torch.where((idx_ar == idx[:, None]) & ok[:, None], _NEG_INF, live)
        out_idx[:, i] = torch.where(ok, idx, 0).to(torch.int32)
        out_ok[:, i] = ok
    return (out_idx.reshape(lead + (max_outputs,)),
            out_ok.reshape(lead + (max_outputs,)))


def multiclass_nms_mask(boxes_per_cls: torch.Tensor, scores: torch.Tensor,
                        score_thresh: float, iou_threshold: float,
                        max_keep_per_cls: int,
                        valid_mask: Optional[torch.Tensor] = None,
                        block: int = 256) -> torch.Tensor:
    """Per-class greedy NMS keep mask (the box head's ``filter_results``
    loop, every image and class at once): ``boxes_per_cls`` (..., N, C, 4),
    ``scores`` (..., N, C), ``valid_mask`` (..., N) → (..., N, C) bool.  The
    candidates of a class score above ``score_thresh``; at most
    ``max_keep_per_cls`` keeps a class.  One (image, class) is one problem of
    :func:`greedy_keep_sorted`; the keep bits go back to box order by the
    sort's indices."""
    *lead, n, c = scores.shape
    live = scores.float().transpose(-1, -2)                        # (..., C, N)
    if valid_mask is not None:
        live = torch.where(valid_mask[..., None, :], live, _NEG_INF)
    live = torch.where(live > score_thresh, live, _NEG_INF).reshape(-1, n)
    boxes_t = boxes_per_cls.float().transpose(-2, -3).reshape(-1, n, 4)
    sboxes, order, active = _sorted_problems(boxes_t, live)
    keep_sorted = greedy_keep_sorted(sboxes, active, iou_threshold,
                                     max_keep_per_cls, block)
    keep = torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)
    return keep.reshape(tuple(lead) + (c, n)).transpose(-1, -2)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor,
                iou_threshold: float, max_outputs: int,
                valid_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS of one problem (N, 4) by the coordinate-offset trick:
    boxes of different ``idxs`` never suppress each other."""
    max_coord = boxes.abs().max() + 1.0
    offsets = idxs.to(boxes.dtype)[:, None] * (max_coord * 2.0 + 2.0)
    return nms(boxes + offsets, scores, iou_threshold, max_outputs, valid_mask)
