"""Port parity for ``obj_prediction_nms`` (``veto_tpu_torch/ops/nms.py``):
the port's batched loop against the JAX package's per-image ``fori_loop``
(vmapped, as its callers run it), on inputs drawn with numpy from a seed.
Labels are compared exactly; ties, which are the rule after a few trips,
must resolve to the first maximal flat index on both sides."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from veto_tpu.ops.nms import obj_prediction_nms as j_nms

from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.ops.nms import class_overlaps, first_argmax, obj_prediction_nms

B, N, C = 3, 12, 9


def _boxes(rng, b=B, n=N, c=C, per_class=False):
    """(b, n, c, 4) xyxy boxes: one box per proposal tiled over the classes
    (SGCls), or a box per class (SGDet's ``boxes_per_cls``)."""
    shape = (b, n, c if per_class else 1)
    x1y1 = rng.uniform(0, 40, shape + (2,))
    boxes = np.concatenate([x1y1, x1y1 + rng.uniform(1, 30, shape + (2,))], -1)
    return np.broadcast_to(boxes, (b, n, c, 4)).astype(np.float32)


def _case(name, rng):
    """(boxes, logits, mask, overwrite, bg_init) for one named case."""
    boxes = _boxes(rng, per_class=name == "per_class_boxes")
    logits = (rng.randn(B, N, C) * 2).astype(np.float32)
    mask = np.ones((B, N), bool)
    overwrite, bg_init = False, None
    if name == "duplicate_boxes":
        boxes = boxes.copy()
        boxes[:, 1::3] = boxes[:, 0:1]  # every third box repeats box 0
        boxes[:, 5] = boxes[:, 2]
        logits[:, 5] = logits[:, 2]     # and one repeats its logits too
    elif name == "masked":
        mask = rng.rand(B, N) > 0.4
        mask[1] = False                 # an image with no box at all
        mask[2, :2] = False
    elif name == "all_equal_logits":
        logits[:] = 0.0                 # every entry ties
        mask[0, 7:] = False
    elif name == "overwrite":
        overwrite = True
        mask[2, 9:] = False
    elif name == "bg_init":
        bg_init = 0.05
        logits[:, :, 0] += 3.0          # the background is often the largest
    elif name == "nan_logits":
        logits[0, 3] = np.nan           # a NaN row is the maximum, first col
        logits[2, 7, 4] = np.nan
    return boxes, logits, mask, overwrite, bg_init


def _jax_labels(boxes, logits, mask, overwrite, bg_init):
    fn = jax.jit(jax.vmap(functools.partial(
        lambda b, lg, m, ov, bg: j_nms(b, lg, 0.5, valid_mask=m, overwrite=ov,
                                       bg_init=bg),
        ov=overwrite, bg=bg_init)))
    return np.asarray(fn(jnp.asarray(boxes), jnp.asarray(logits),
                         jnp.asarray(mask)))


CASES = ("random", "per_class_boxes", "duplicate_boxes", "masked",
         "all_equal_logits", "overwrite", "bg_init", "nan_logits")


@pytest.mark.parametrize("name", CASES)
def test_obj_prediction_nms_matches_jax(name):
    rng = np.random.RandomState(CASES.index(name))
    boxes, logits, mask, overwrite, bg_init = _case(name, rng)
    ref = _jax_labels(boxes, logits, mask, overwrite, bg_init)
    got = obj_prediction_nms(torch.from_numpy(boxes), torch.from_numpy(logits),
                             0.5, torch.from_numpy(mask), overwrite=overwrite,
                             bg_init=bg_init)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, N)
    np.testing.assert_array_equal(got.numpy(), ref)
    if name == "masked":
        assert (ref[1] == 0).all()
    # batched over images = one image at a time
    for i in range(B):
        one = obj_prediction_nms(
            torch.from_numpy(boxes[i:i + 1]), torch.from_numpy(logits[i:i + 1]),
            0.5, torch.from_numpy(mask[i:i + 1]), overwrite=overwrite,
            bg_init=bg_init)
        np.testing.assert_array_equal(one[0].numpy(), got[i].numpy())


def test_without_a_mask_every_box_takes_part():
    rng = np.random.RandomState(7)
    boxes, logits, _, _, _ = _case("random", rng)
    got = obj_prediction_nms(torch.from_numpy(boxes), torch.from_numpy(logits),
                             0.3)
    ref = jax.vmap(lambda b, lg: j_nms(b, lg, 0.3))(jnp.asarray(boxes),
                                                    jnp.asarray(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_first_argmax_takes_the_first_of_equal_maxima():
    """The tie rule, written out: the first maximal index
    (``jnp.argmax``'s rule), on rows made of ties; +inf (a NaN, in the
    NMS) is the maximum."""
    x = np.array([[0.0, 0.0, 0.0, 0.0],
                  [-1.0, 0.5, -1.0, 0.5],
                  [-1.0, -1.0, -1.0, -1.0],
                  [0.2, np.inf, 0.9, np.inf],
                  [0.3, 0.1, 0.3, 0.2]], np.float32)
    got = first_argmax(torch.from_numpy(x), torch.arange(4).expand(5, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.argmax(x, -1)))
    np.testing.assert_array_equal(got.numpy(), [0, 1, 0, 1, 0])


def test_class_overlaps_match_the_jax_iou():
    """The per-class IoU test with ``TO_REMOVE``, degenerate (zero) boxes
    included: padded boxes of a batch are all-zero."""
    from veto_tpu.ops.box_ops import box_iou as j_iou

    rng = np.random.RandomState(8)
    boxes = _boxes(rng, b=2, n=6, c=3, per_class=True).copy()
    boxes[1, 4:] = 0.0
    got = class_overlaps(torch.from_numpy(boxes), 0.5).numpy()
    for i in range(2):
        for c in range(3):
            iou = np.asarray(j_iou(jnp.asarray(boxes[i, :, c]),
                                   jnp.asarray(boxes[i, :, c])))
            np.testing.assert_array_equal(got[i, c], iou >= 0.5)
