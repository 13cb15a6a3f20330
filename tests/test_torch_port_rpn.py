"""Port parity for SGDet's detector stages: the anchors, the box geometry
(decode, clip, IoU), the RPN head and its proposal selection, and the box
head's post-processing and label assignment, against the JAX package on
the same numpy inputs.

Elementwise stages with a transcendental (``exp`` in the box decoding,
``sigmoid``, ``softmax``) may differ from XLA's on the CPU by an ulp; they
are held to 1e-6 of their scale (boxes) or 2e-7 (scores).  Every selection
(top-k, NMS, the duplicate filter, the top-80) is held exactly, given the
JAX package's own input to that stage; the inputs keep their near-ties
apart by far more than an ulp (bf16-quantised logits, random boxes), as
the card's do.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import veto_tpu.models.detector.rpn as jrpn
from veto_tpu.models.detector.anchors import fpn_anchors as j_fpn_anchors
from veto_tpu.models.detector.box_head import (
    assign_labels_to_proposals as j_assign, box_postprocess as j_box_postprocess,
    filter_decoded_boxes as j_filter,
)
from veto_tpu.ops import box_ops as jbo

from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

import veto_tpu_torch.models.detector.rpn as trpn
from veto_tpu_torch.models.detector.anchors import fpn_anchors
from veto_tpu_torch.models.detector.box_head import (
    assign_labels_to_proposals, box_postprocess, filter_decoded_boxes,
)
from veto_tpu_torch.ops import box_ops as tbo
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict

RATIOS = (0.23232838, 0.63365731, 1.28478321, 3.15089189)
SIZES, STRIDES = (32, 64, 128, 256, 512), (4, 8, 16, 32, 64)
IMG = (64, 96)


def _t(a):
    return torch.from_numpy(np.array(a))


def _scaled(got, ref, tol, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, atol=tol * max(float(np.abs(ref).max()), 1.0),
                               rtol=0, err_msg=what)


def _boxes(rng, shape, span=60.0):
    xy = rng.uniform(0, span, shape + (2,))
    return np.concatenate([xy, xy + rng.uniform(1, 40, shape + (2,))], -1
                          ).astype(np.float32)


# ---------------------------------------------------------------- anchors
@pytest.mark.parametrize("hw", [(64, 96), (800, 1344), (1344, 800)])
def test_anchors_equal_jax(hw):
    """The copy's ``fpn_anchors`` and the model's per-map anchors
    (``level_anchors`` over the FPN maps' sizes) equal JAX's exactly."""
    ref = j_fpn_anchors(hw, SIZES, STRIDES, RATIOS)
    ours = fpn_anchors(hw, SIZES, STRIDES, RATIOS)
    maps = [(-(-hw[0] // s), -(-hw[1] // s)) for s in STRIDES]
    levels = trpn.level_anchors(maps, SIZES, STRIDES, RATIOS, "cpu")
    for (ra, rv), (oa, ov), la in zip(ref, ours, levels):
        np.testing.assert_array_equal(oa, ra)
        np.testing.assert_array_equal(ov, rv)
        np.testing.assert_array_equal(la.numpy(), ra)


# ----------------------------------------------------------- box geometry
def test_box_geometry_matches_jax():
    """``decode_boxes`` (both weight sets, the clamp reached), within 1e-6
    of the box scale (``exp`` may differ by an ulp); ``clip_to_image``,
    ``box_iou`` and ``nonempty_mask`` exactly."""
    rng = np.random.RandomState(0)
    boxes = _boxes(rng, (3, 20))
    codes = (rng.randn(3, 20, 4 * 5) * 2).astype(np.float32)
    codes[0, 0, 2] = 40.0  # dw past BBOX_XFORM_CLIP at weight 5
    for w in ((10.0, 10.0, 5.0, 5.0), (1.0, 1.0, 1.0, 1.0)):
        ref = jbo.decode_boxes(jnp.asarray(codes), jnp.asarray(boxes), weights=w)
        got = tbo.decode_boxes(_t(codes), _t(boxes), weights=w)
        _scaled(got, ref, 1e-6, f"decode {w}")
    sizes = np.array([[50, 40], [96, 64], [30, 70]], np.float32)
    dec = np.array(jbo.decode_boxes(jnp.asarray(codes), jnp.asarray(boxes)))
    np.testing.assert_array_equal(
        tbo.clip_to_image(_t(dec), _t(sizes)).numpy(),
        np.asarray(jax.vmap(jbo.clip_to_image)(jnp.asarray(dec), jnp.asarray(sizes))))
    b1, b2 = _boxes(rng, (2, 9)), _boxes(rng, (2, 7))
    b2[0, 0, 2:] = b2[0, 0, :2] - 1.0  # an empty box
    np.testing.assert_array_equal(tbo.box_iou(_t(b1), _t(b2)).numpy(),
                                  np.asarray(jbo.box_iou(jnp.asarray(b1),
                                                         jnp.asarray(b2))))
    np.testing.assert_array_equal(tbo.nonempty_mask(_t(b2), 3.0).numpy(),
                                  np.asarray(jbo.nonempty_mask(jnp.asarray(b2), 3.0)))


# --------------------------------------------------------------- the RPN
def _levels(rng, b=2):
    """Per-level NHWC maps of an IMG image: bf16-quantised logits (few
    distinct values, exact ties) and small deltas."""
    maps = [(-(-IMG[0] // s), -(-IMG[1] // s)) for s in STRIDES]
    obj = [np.array(jnp.asarray(rng.randn(b, h, w, 4) * 2, jnp.bfloat16)
                    .astype(jnp.float32)) for h, w in maps]
    reg = [(rng.randn(b, h, w, 16) * 0.3).astype(np.float32) for h, w in maps]
    return obj, reg


def test_rpn_head_matches_jax():
    """``RPNHead`` through the weight bridge: the shared 3x3 conv and both
    1x1 heads on every level, f32 at summation order."""
    rng = np.random.RandomState(1)
    feats = [rng.randn(2, h, w, 32).astype(np.float32)
             for h, w in ((16, 24), (8, 12), (4, 6))]
    jh = jrpn.RPNHead(mid_channels=256, num_anchors=4, dtype=jnp.float32)
    variables = jh.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats])
    params = jax.tree.map(lambda a: np.array(a) + 0.01 * rng.randn(*a.shape)
                          .astype(np.float32), variables["params"])
    ref_o, ref_r = jh.apply({"params": params}, [jnp.asarray(f) for f in feats])
    head = trpn.RPNHead(32, 256, 4)
    head.load_state_dict(flax_to_state_dict({"params": params}), strict=True)
    with torch.no_grad():
        got_o, got_r = head([_t(f) for f in feats])
    for g, r in zip(got_o + got_r, ref_o + ref_r):
        _scaled(g, r, 1e-5, "rpn maps")


@pytest.mark.parametrize("batch_levels", [True, False])
def test_rpn_select_proposals_matches_jax(monkeypatch, batch_levels):
    """Both paths (the levels' walks batched into one call, or one call per
    level) from the same maps: the per-level top-k (with ties), decoding,
    clipping to each image's size, NMS at 0.7 and the cross-level top-k
    select exactly JAX's proposals, in JAX's order."""
    monkeypatch.setattr(jrpn, "RPN_BATCH_LEVELS", batch_levels)
    monkeypatch.setattr(trpn, "RPN_BATCH_LEVELS", batch_levels)
    rng = np.random.RandomState(2)
    obj, reg = _levels(rng)
    anchors = [a for a, _ in j_fpn_anchors(IMG, SIZES, STRIDES, RATIOS)]
    sizes = np.array([[96, 64], [70, 50]], np.float32)
    kw = dict(pre_nms_top_n=120, post_nms_top_n=40, nms_thresh=0.7,
              fpn_post_nms_top_n=60, min_size=0.0)

    def one(i):
        flat = [jrpn.flatten_level(jnp.asarray(o[i]), jnp.asarray(r[i]))
                for o, r in zip(obj, reg)]
        return jrpn.rpn_select_proposals([f[0] for f in flat], [f[1] for f in flat],
                                         [jnp.asarray(a) for a in anchors],
                                         jnp.asarray(sizes[i]), **kw)

    refs = [one(i) for i in range(2)]
    flat = [trpn.flatten_level(_t(o), _t(r)) for o, r in zip(obj, reg)]
    got = trpn.rpn_select_proposals([f[0] for f in flat], [f[1] for f in flat],
                                    [_t(a) for a in anchors], _t(sizes), **kw)
    for i, ref in enumerate(refs):
        np.testing.assert_array_equal(got.mask[i].numpy(), np.asarray(ref.mask))
        _scaled(got.boxes[i], ref.boxes, 1e-6, "proposal boxes")
        np.testing.assert_allclose(got.objectness[i].numpy(),
                                   np.asarray(ref.objectness), atol=2e-7, rtol=0)
    assert 20 < int(got.mask.sum()) <= 120


# --------------------------------------------------- box post-processing
def _head_outputs(rng, b=2, p=40, c=11):
    props = _boxes(rng, (b, p), span=50.0)
    logits = (rng.randn(b, p, c) * 2.5).astype(np.float32)
    deltas = (rng.randn(b, p, 4 * c) * 0.5).astype(np.float32)
    mask = rng.rand(b, p) > 0.1
    return props, logits, deltas, mask


@pytest.mark.parametrize("dup", [True, False])
def test_filter_decoded_boxes_matches_jax(dup):
    """Given JAX's own softmax and decoded boxes: per-class NMS, the
    duplicate filter (one label a box, survivors in ascending box order) or
    the cat-boxlists branch, the top-k budget: every field exactly, the
    padding included (its ``boxes_per_cls`` rows are the proposals the
    top-k picked among the -inf entries, lowest index first)."""
    rng = np.random.RandomState(3 + dup)
    props, logits, deltas, mask = _head_outputs(rng)
    prob = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    bpc = np.array(jax.vmap(lambda d, pr: jbo.clip_to_image(
        jbo.decode_boxes(d, pr).reshape(40, 11, 4), jnp.asarray([96.0, 64.0])))(
        jnp.asarray(deltas), jnp.asarray(props)))
    # at most 3 keeps in each of 10 classes, so 35 slots leave padding
    kw = dict(score_thresh=0.05, nms_thresh=0.3, post_nms_per_cls_topn=3,
              nms_filter_duplicates=dup, detections_per_img=35)
    got = filter_decoded_boxes(_t(prob), _t(bpc), _t(mask), **kw)
    for i in range(2):
        ref = j_filter(jnp.asarray(prob[i]), jnp.asarray(bpc[i]), jnp.asarray(mask[i]),
                       **kw)
        for name in ref._fields:
            np.testing.assert_array_equal(getattr(got, name)[i].numpy(),
                                          np.asarray(getattr(ref, name)), name)
    assert got.mask.any(1).all() and (~got.mask).any(1).all()


def test_box_postprocess_matches_jax():
    """From JAX's logits, deltas and proposals: the softmax and decoding to
    their ulp tolerances and the whole selection exactly."""
    rng = np.random.RandomState(5)
    props, logits, deltas, mask = _head_outputs(rng)
    sizes = np.array([[96, 64], [80, 60]], np.float32)
    kw = dict(score_thresh=0.05, nms_thresh=0.3, post_nms_per_cls_topn=6,
              detections_per_img=12)
    got = box_postprocess(_t(logits), _t(deltas), _t(props), _t(mask), _t(sizes), **kw)
    for i in range(2):
        ref = j_box_postprocess(jnp.asarray(logits[i]), jnp.asarray(deltas[i]),
                                jnp.asarray(props[i]), jnp.asarray(mask[i]),
                                jnp.asarray(sizes[i]), **kw)
        for name in ("labels", "mask", "orig_idx"):
            np.testing.assert_array_equal(getattr(got, name)[i].numpy(),
                                          np.asarray(getattr(ref, name)), name)
        _scaled(got.boxes[i], ref.boxes, 1e-6, "boxes")
        _scaled(got.boxes_per_cls[i], ref.boxes_per_cls, 1e-6, "boxes_per_cls")
        np.testing.assert_allclose(got.scores[i].numpy(), np.asarray(ref.scores),
                                   atol=2e-7, rtol=0)


def test_assign_labels_to_proposals_matches_jax():
    """Best-IoU GT (the first of equal IoUs: duplicate GT boxes), the 0.5
    foreground threshold, masked GT and proposals: labels and matches
    exactly."""
    rng = np.random.RandomState(6)
    gt = _boxes(rng, (2, 6))
    gt[:, 3] = gt[:, 1]  # a duplicate GT box of another class
    props = np.concatenate([gt + rng.randn(2, 6, 4).astype(np.float32),
                            _boxes(rng, (2, 10))], 1)
    labels = rng.randint(1, 11, (2, 6)).astype(np.int32)
    gmask = np.array([[1] * 6, [1] * 4 + [0] * 2], bool)
    pmask = rng.rand(2, 16) > 0.1
    got = assign_labels_to_proposals(_t(props), _t(pmask), _t(gt), _t(labels),
                                     _t(gmask))
    for i in range(2):
        ref = j_assign(jnp.asarray(props[i]), jnp.asarray(pmask[i]), jnp.asarray(gt[i]),
                       jnp.asarray(labels[i]), jnp.asarray(gmask[i]))
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1][i].numpy(), np.asarray(ref[1]))
    assert (got[0] > 0).sum() >= 6
