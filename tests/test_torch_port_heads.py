"""Port parity for the detector's mask, keypoint and attribute heads against
the JAX package, on the same seeded numpy inputs and the same weights
(brought across by the weight bridge): each head's forward (f32, and the
mask head once in bf16), both transposed-convolution kernels through the
bridge, the mask targets, loss, post-processing and pasting, the keypoint
heat-map targets, loss and decoding (the port's own bicubic resize against
the JAX package's OpenCV call), the attribute targets and loss on JAX's
uniforms; then the slice as a whole: one detector pretraining step with
both heads against ``make_detector_train_step(mask_on=True,
keypoint_on=True)``, and one PredCls relation step with the attribute head
against ``make_train_step(attribute_cfg=)``.

The two steps run tiny models (ResNet stage blocks (1, 1, 1, 1), FPN 32,
64x64 images, f32, the ``xla`` encoder); each JAX step is compiled once
with LLVM's optimisations off, and its gradients come out of its own
optimizer state."""

import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from veto_tpu.config.defaults import SolverConfig as JSolverConfig
from veto_tpu.engine.batch import SGGBatch as JBatch
from veto_tpu.engine.train import TrainState as JTrainState
from veto_tpu.engine.train import make_train_step as j_make_train_step
from veto_tpu.models.detector import attribute_head as jah
from veto_tpu.models.detector import keypoint_head as jkh
from veto_tpu.models.detector import mask_head as jmh
from veto_tpu.models.relation.sampling import gtbox_relsample as j_relsample
from veto_tpu.models.sgg import SGGModel as JModel
from veto_tpu.solver.optim import make_optimizer as j_make_optimizer
from veto_tpu.structures.keypoints import keypoints_to_heat_map as j_heat_map

from torch_port_det_steps import jax_draws, keep_grads, run_jax_detector_step
from torch_port_flax_tree import flax_variables
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401
from veto_tpu_torch.config import SolverConfig
from veto_tpu_torch.data.synthetic import SyntheticSGGDataset
from veto_tpu_torch.engine import pretrain as tpretrain
from veto_tpu_torch.engine.pretrain import (
    DetectorBudgets, create_detector_state, detector_forward_backward,
)
from veto_tpu_torch.engine.train import create_train_state, train_on_pairs
from veto_tpu_torch.models.detector import attribute_head as tah
from veto_tpu_torch.models.detector import keypoint_head as tkh
from veto_tpu_torch.models.detector import mask_head as tmh
from veto_tpu_torch.models.detector.rpn import Proposals
from veto_tpu_torch.models.relation.sampling import RelSample
from veto_tpu_torch.models.sgg import SGGModel, init_weights
from veto_tpu_torch.solver.optim import FROZEN_DETECTOR
from veto_tpu_torch.structures.keypoints import keypoints_to_heat_map
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _scaled(got, ref, tol, what):
    got, ref = _np(got), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, err_msg=what,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30))


def _perturb(tree, rng):
    """Non-zero biases (flax starts them at 0), so that their cast and
    addition are held too."""
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (np.asarray(v) + rng.uniform(-0.1, 0.1, np.shape(v)).astype(np.float32)
                      if p[-1].key == "bias" else np.asarray(v)), tree)


def _rois(rng, b, p, h, w):
    x1, y1 = rng.uniform(-4, w * 0.7, (b, p)), rng.uniform(-4, h * 0.7, (b, p))
    bw, bh = rng.uniform(1, w * 0.5, (b, p)), rng.uniform(1, h * 0.5, (b, p))
    return np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)


# --------------------------------------------------------- the head modules
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mask_head_forward_matches_jax(dtype):
    """The extractor's 3x3 stack, ``conv5_mask`` (2x2 stride 2, transposed)
    and the f32 1x1 logits, and the 1x1 predictor, on one pool of 14 x 14
    rois: f32 to 1e-5 of the largest |logit|; bf16 (the convolutions
    rounded to bf16 on both sides, their products summed in other orders)
    to 2e-2."""
    rng = np.random.RandomState(0)
    x = rng.randn(5, 14, 14, 8).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ext = jmh.MaskFeatureExtractor(conv_layers=(16, 16), dtype=jdt)
    pred = jmh.MaskPredictor(num_classes=7, dim_reduced=16, dtype=jdt)
    one = jmh.MaskConv1x1Predictor(num_classes=7, dtype=jdt)
    ev = ext.init(jax.random.PRNGKey(0), x)
    feats = ext.apply(ev, x)
    params = {"mask_extractor": _perturb(ev["params"], rng),
              "mask_predictor": _perturb(pred.init(jax.random.PRNGKey(1), feats)["params"], rng),
              "mask_one": _perturb(one.init(jax.random.PRNGKey(2), feats)["params"], rng)}
    feats = ext.apply({"params": params["mask_extractor"]}, x)
    ref = pred.apply({"params": params["mask_predictor"]}, feats)
    ref_one = one.apply({"params": params["mask_one"]}, feats)

    head = torch.nn.ModuleDict({
        "mask_extractor": tmh.MaskFeatureExtractor(8, (16, 16), dtype=tdt),
        "mask_predictor": tmh.MaskPredictor(16, 7, 16, tdt),
        "mask_one": tmh.MaskConv1x1Predictor(16, 7)})
    head.load_state_dict(flax_to_state_dict({"params": params}), strict=True)
    with torch.no_grad():
        got_feats = head["mask_extractor"](_t(x))
        got = head["mask_predictor"](got_feats)
        got_one = head["mask_one"](got_feats)
    assert got_feats.dtype == tdt and got.dtype == got_one.dtype == torch.float32
    assert tuple(got.shape) == (5, 28, 28, 7) and tuple(got_one.shape) == (5, 14, 14, 7)
    tol = 1e-5 if dtype == "float32" else 2e-2
    _scaled(got_feats, np.asarray(feats, np.float32), tol, "features")
    _scaled(got, ref, tol, "mask logits")
    _scaled(got_one, ref_one, tol, "1x1 logits")


def test_keypoint_head_forward_matches_jax():
    """The extractor's 3x3 stack, ``kps_score_lowres`` (4x4 stride 2,
    transposed, "SAME") and the 2x bilinear upsample: (R, 4P, 4P, K), f32
    to 1e-5."""
    rng = np.random.RandomState(1)
    x = rng.randn(3, 14, 14, 8).astype(np.float32)
    ext = jkh.KeypointFeatureExtractor(conv_layers=(16, 16), dtype=jnp.float32)
    pred = jkh.KeypointPredictor(num_keypoints=5, dtype=jnp.float32)
    ev = ext.init(jax.random.PRNGKey(0), x)
    params = {"keypoint_extractor": _perturb(ev["params"], rng),
              "keypoint_predictor": _perturb(
                  pred.init(jax.random.PRNGKey(1), ext.apply(ev, x))["params"], rng)}
    ref = pred.apply({"params": params["keypoint_predictor"]},
                     ext.apply({"params": params["keypoint_extractor"]}, x))
    head = torch.nn.Sequential()
    head.add_module("keypoint_extractor",
                    tkh.KeypointFeatureExtractor(8, (16, 16), torch.float32))
    head.add_module("keypoint_predictor", tkh.KeypointPredictor(16, 5, torch.float32))
    head.load_state_dict(flax_to_state_dict({"params": params}), strict=True)
    with torch.no_grad():
        got = head(_t(x))
    assert tuple(got.shape) == (3, 56, 56, 5)
    _scaled(got, ref, 1e-5, "keypoint logits")


@pytest.mark.parametrize("name,kernel,padding", [("conv5_mask", 2, 0),
                                                 ("kps_score_lowres", 4, 1)])
def test_transposed_conv_kernels_cross_the_bridge(name, kernel, padding):
    """flax's ``ConvTranspose`` (stride 2, its default "SAME" padding) does
    not flip its kernel; the bridge turns its (kh, kw, I, O) kernel into
    the (I, O, kh, kw) weight of torch's ``ConvTranspose2d`` reversed in
    both spatial axes, and "SAME" is torch's ``padding`` 0 (k = 2) or 1
    (k = 4): the same (R, 2H, 2W, O) output to 1e-5.  The test helper's
    inverse gives the flax kernel back bit for bit; the weight without the
    flip computes something else."""
    from torch_port_flax_tree import CONV_TRANSPOSE

    assert name in CONV_TRANSPOSE
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 5, 8).astype(np.float32)
    conv = fnn.ConvTranspose(4, (kernel, kernel), strides=(2, 2))
    params = _perturb(conv.init(jax.random.PRNGKey(3), x)["params"], rng)
    ref = np.asarray(conv.apply({"params": params}, x))
    sd = flax_to_state_dict({"params": {name: params}})
    tconv = torch.nn.ConvTranspose2d(8, 4, kernel, stride=2, padding=padding)
    tconv.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        got = tconv(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        unflipped = torch.nn.functional.conv_transpose2d(
            _t(x).permute(0, 3, 1, 2), _t(params["kernel"]).permute(2, 3, 0, 1),
            tconv.bias, 2, padding).permute(0, 2, 3, 1)
    assert tuple(got.shape) == ref.shape == (2, 12, 10, 4)
    _scaled(got, ref, 1e-5, name)
    assert float((unflipped - _t(ref)).abs().max()) > 1e-2
    back = sd[f"{name}.weight"].numpy().transpose(2, 3, 0, 1)[::-1, ::-1]
    np.testing.assert_array_equal(back, params["kernel"])


def test_attribute_predictor_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, 32).astype(np.float32)
    jp = jah.AttributePredictor(num_attributes=21, dtype=jnp.float32)
    params = _perturb(jp.init(jax.random.PRNGKey(0), x)["params"], rng)
    head = torch.nn.ModuleDict({"attribute_predictor": tah.AttributePredictor(
        32, 21, torch.float32)})
    head.load_state_dict(flax_to_state_dict({"params": {"attribute_predictor": params}}))
    with torch.no_grad():
        got = head["attribute_predictor"](_t(x))
    _scaled(got, jp.apply({"params": params}, x), 1e-5, "att_score")


# ------------------------------------------------------------- mask pieces
def _mask_case(rng, b=2, t=4, p=9, h=40, w=56):
    masks = (rng.rand(b, t, h, w) > 0.5).astype(np.uint8)
    rois = _rois(rng, b, p, h, w)
    # halves (rounded to even), past the image, and a zero-size box
    rois[0, 0] = [2.5, 3.5, 20.5, 30.5]
    rois[0, 1] = [-10.0, -5.0, 80.0, 70.0]
    rois[1, 0] = [10.0, 10.0, 10.0, 10.0]
    matched = rng.randint(-1, t, (b, p)).astype(np.int32)
    return masks, rois, matched


def test_project_masks_on_boxes_matches_jax():
    """The crop (round half to even, clamped, at least a pixel) and the
    half-pixel resample of uint8 masks, against the JAX package's on f32
    masks of the same values: 1e-6."""
    masks, rois, matched = _mask_case(np.random.RandomState(4))
    got = tmh.project_masks_on_boxes(_t(masks), _t(matched), _t(rois), 14)
    ref = jax.vmap(lambda g, m, r: jmh.project_masks_on_boxes(g, m, r, 14))(
        masks.astype(np.float32), matched, rois)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_mask_loss_postprocess_and_paste_match_jax():
    """``mask_loss`` (each image's mean BCE over its positives' elements,
    one image with none) and its gradient to 1e-5; ``mask_postprocess``
    1e-6; ``paste_masks_in_image`` at a threshold and below 0, equal."""
    rng = np.random.RandomState(5)
    masks, rois, matched = _mask_case(rng)
    b, p, c = 2, 9, 6
    logits = (rng.randn(b, p, 28, 28, c) * 2).astype(np.float32)
    labels = rng.randint(0, c, (b, p)).astype(np.int32)
    valid = rng.rand(b, p) > 0.2
    labels[1] = 0  # no positive in image 1

    def jloss(lg):
        out = jax.vmap(jmh.mask_loss)(lg, labels, matched, masks.astype(np.float32),
                                      rois, valid)
        return out.loss.sum(), out
    (_, ref), ref_g = jax.value_and_grad(jloss, has_aux=True)(logits)
    x = _t(logits).requires_grad_(True)
    got = tmh.mask_loss(x, _t(labels), _t(matched), _t(masks), _t(rois), _t(valid))
    got.loss.sum().backward()
    np.testing.assert_allclose(got.loss.detach().numpy(), np.asarray(ref.loss), rtol=1e-5)
    np.testing.assert_array_equal(got.num_pos.numpy(), np.asarray(ref.num_pos))
    assert int(ref.num_pos[0]) > 0 and int(ref.num_pos[1]) == 0
    _scaled(x.grad, ref_g, 1e-5, "d mask logits")

    probs = tmh.mask_postprocess(_t(logits[0]), _t(labels[0]))
    ref_p = np.asarray(jmh.mask_postprocess(logits[0], labels[0]))
    np.testing.assert_allclose(probs.numpy(), ref_p, atol=1e-6, rtol=0)
    boxes = np.array([[3.2, 4.9, 30.1, 22.0], [-5.0, 10.0, 50.0, 60.0],
                      [10.0, 10.0, 11.0, 11.0]], np.float32)
    for thresh in (0.5, -1.0):
        got_im = tmh.paste_masks_in_image(ref_p[:3], boxes, (48, 40), thresh)
        ref_im = jmh.paste_masks_in_image(ref_p[:3], boxes, (48, 40), thresh)
        assert got_im.shape == (3, 1, 40, 48)
        np.testing.assert_array_equal(got_im, ref_im)


# --------------------------------------------------------- keypoint pieces
def _keypoint_case(rng, b=2, p=7, k=5, h=60, w=80):
    rois = _rois(rng, b, p, h, w)
    kps = np.zeros((b, p, k, 3), np.float32)
    kps[..., 0] = rois[..., None, 0] + rng.uniform(-0.2, 1.2, (b, p, k)) * (
        rois[..., None, 2] - rois[..., None, 0])
    kps[..., 1] = rois[..., None, 1] + rng.uniform(-0.2, 1.2, (b, p, k)) * (
        rois[..., None, 3] - rois[..., None, 1])
    kps[..., 2] = rng.choice([0.0, 1.0, 2.0], (b, p, k))
    kps[0, 0, 0, :2] = rois[0, 0, 2:]  # on the right and lower edges: the last cell
    kps[0, 0, 0, 2] = 2.0
    return kps, rois


def test_keypoints_to_heat_map_matches_jax():
    """Cells and validity equal, the exact edge snapping to the last cell
    and keypoints off the grid or invisible invalid."""
    kps, rois = _keypoint_case(np.random.RandomState(6))
    lin, valid = keypoints_to_heat_map(_t(kps), _t(rois), 56)
    ref_lin, ref_valid = jax.vmap(lambda k, r: j_heat_map(k, r, 56))(kps, rois)
    np.testing.assert_array_equal(lin.numpy(), np.asarray(ref_lin))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    assert int(lin[0, 0, 0]) == 56 * 56 - 1
    assert 0 < int(valid.sum()) < valid.numel()


def test_keypoint_loss_matches_jax():
    """Each image's mean cross-entropy of the spatial softmax over its valid
    keypoints of positive rois, and its gradient: 1e-5."""
    rng = np.random.RandomState(7)
    kps, rois = _keypoint_case(rng)
    logits = rng.randn(2, 7, 56, 56, 5).astype(np.float32)
    pos = rng.rand(2, 7) > 0.3

    def jloss(lg):
        out = jax.vmap(jkh.keypoint_loss)(lg, kps, rois, pos)
        return out.loss.sum(), out
    (_, ref), ref_g = jax.value_and_grad(jloss, has_aux=True)(logits)
    x = _t(logits).requires_grad_(True)
    got = tkh.keypoint_loss(x, _t(kps), _t(rois), _t(pos))
    got.loss.sum().backward()
    np.testing.assert_allclose(got.loss.detach().numpy(), np.asarray(ref.loss), rtol=1e-5)
    np.testing.assert_array_equal(got.num_valid.numpy(), np.asarray(ref.num_valid))
    _scaled(x.grad, ref_g, 1e-5, "d keypoint logits")


def test_heatmaps_to_keypoints_matches_opencv():
    """The port's bicubic resize (no OpenCV) against the JAX package's
    ``cv2.resize(INTER_CUBIC)``: rois smaller and larger than the 56 x 56
    maps, fractional extents; each keypoint's argmax cell (so its x, y)
    equal, its score within 1e-5 of the largest |score|."""
    rng = np.random.RandomState(8)
    d, k = 6, 5
    # smooth maps with one peak a keypoint, as a trained head gives
    yy, xx = np.mgrid[0:56, 0:56]
    cy, cx = rng.uniform(5, 50, (2, d, k))
    maps = (4.0 * np.exp(-((yy - cy[..., None, None]) ** 2 + (xx - cx[..., None, None]) ** 2)
                         / rng.uniform(10, 80, (d, k, 1, 1)))
            + 0.3 * rng.randn(d, k, 56, 56)).astype(np.float32)
    rois = np.array([[0, 0, 20.3, 31.0], [5.5, 7.25, 130.0, 90.5], [1, 2, 57, 58],
                     [10, 10, 10.4, 400], [3, 3, 250.7, 12.2], [0, 0, 56, 56]], np.float32)
    got_xy, got_s = tkh.heatmaps_to_keypoints(maps, rois)
    ref_xy, ref_s = jkh.heatmaps_to_keypoints(maps, rois)
    np.testing.assert_array_equal(got_xy, ref_xy)
    np.testing.assert_allclose(got_s, ref_s, rtol=0, atol=1e-5 * np.abs(ref_s).max())
    assert got_xy.shape == (d, k, 3) and got_s.shape == (d, k)


# -------------------------------------------------------- attribute pieces
def _attribute_case(rng, n=40, a=21):
    att = np.zeros((n, 10), np.int32)
    for i in range(n):
        if rng.rand() < 0.3:
            m = rng.randint(1, 5)
            att[i, :m] = rng.randint(1, a, m)
    att[0, :3] = [4, 0, 7]  # an id after a 0 slot does not count
    valid = rng.rand(n) > 0.15
    return att, valid


def test_attribute_targets_match_jax():
    att, _ = _attribute_case(np.random.RandomState(9))
    got = tah.attribute_targets(_t(att), 21)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jah.attribute_targets(att, 21)))
    assert float(got[0, 7]) == 0.0 and float(got[0, 4]) == 1.0


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("bgfg_sample", [True, False])
def test_attribute_loss_matches_jax(binary, bgfg_sample):
    """Both the binary (``pos_weight``) and the soft cross-entropy branch,
    with the negative sampler on JAX's own uniforms and without it, the
    loss and its gradient to 1e-5; and with no positive the budget of one
    negative."""
    rng = np.random.RandomState(10)
    att, valid = _attribute_case(rng)
    logits = (rng.randn(40, 21) * 2).astype(np.float32)
    key = jax.random.PRNGKey(11)
    uniforms = _t(jax.random.uniform(key, (40,)))
    kw = dict(bgfg_sample=bgfg_sample, use_binary_loss=binary, bgfg_ratio=2,
              pos_weight=3.0, loss_weight=0.5)
    for a in (att, np.zeros_like(att)):
        def jloss(lg):
            out = jah.attribute_loss(key, lg, a, valid, **kw)
            return out.loss, out
        (_, ref), ref_g = jax.value_and_grad(jloss, has_aux=True)(logits)
        x = _t(logits).requires_grad_(True)
        got = tah.attribute_loss(x, _t(a), _t(valid), uniforms, **kw)
        got.loss.backward()
        np.testing.assert_allclose(float(got.loss.detach()), float(ref.loss), rtol=1e-5)
        assert int(got.num_pos) == int(ref.num_pos)
        _scaled(x.grad, ref_g, 1e-5, "d attribute logits")
        if bgfg_sample and not a.any():  # one negative row selected
            assert int((x.grad.abs().sum(1) > 0).sum()) == 1


# ------------------------------------------- the slice: a pretraining step
NUM_OBJ, MAX_BOXES, KEYPOINTS = 11, 6, 5
TINY = dict(num_obj_classes=NUM_OBJ, num_rel_classes=7, stage_blocks=(1, 1, 1, 1),
            groups=1, width_per_group=16, fpn_channels=32, rpn_pre_nms_top_n=64,
            rpn_post_nms_top_n=16, rpn_fpn_post_nms_top_n=16,
            detections_per_img=8, box_mlp_dim=64, veto_dim=48, veto_layers=2,
            veto_heads=6, veto_depth_proj_dim=32, veto_visual_proj_dim=16,
            mask_on=True, mask_conv_layers=(16, 16), keypoint_on=True,
            num_keypoints=KEYPOINTS, keypoint_conv_layers=(16, 16))
BUDGETS = DetectorBudgets(rpn_batch_size=64, rpn_positive_fraction=0.5,
                          rpn_fg_iou=0.7, rpn_bg_iou=0.3, box_batch_size=16,
                          box_positive_fraction=0.5, box_fg_iou=0.5,
                          box_bg_iou=0.3, rpn_pre_nms_top_n=64,
                          rpn_post_nms_top_n=16, rpn_fpn_post_nms_top_n=16,
                          rpn_nms_thresh=0.7, head_rois_per_image=6)
SOLVER = dict(optimizer="sgd", ims_per_batch=2, base_lr=5e-3, bias_lr_factor=2.0,
              weight_decay=0.1, weight_decay_bias=0.05, momentum=0.9,
              grad_clip_norm=5.0)
LR_SCALE = 0.5


def _flax_named(tree):
    return flax_to_state_dict({"params": tree})


@pytest.fixture(scope="module")
def heads_step():
    """The port model with both heads (seeded, folded BN), the same weights
    as a flax tree, 2 synthetic images with masks and keypoints, and one
    compiled ``make_detector_train_step(mask_on=True, keypoint_on=True)``
    on them."""
    ds = SyntheticSGGDataset(num_images=2, image_size=(64, 64), num_obj_classes=NUM_OBJ,
                             num_rel_classes=7, max_objects=MAX_BOXES - 2, min_objects=3,
                             max_relations=4, seed=3, with_masks=True,
                             with_keypoints=KEYPOINTS)
    batch = next(ds.batches(2, MAX_BOXES))[0]
    jb = JBatch(**{k: jnp.asarray(v) for k, v in batch.fields().items()})
    model = SGGModel(mode="sgdet", **TINY, fold_bn=True, dtype=torch.float32,
                     veto_encoder_impl="xla", train_detector=True)
    init_weights(model, 0)
    jm = JModel(mode="sgdet", **TINY, fold_bn=True, dtype=jnp.float32,
                veto_encoder_impl="xla", pooler_impl="separable", veto_remat=False)
    variables = flax_variables(
        jm, model, jax.random.PRNGKey(0), jb.images[:1], jb.depth[:1], jb.boxes[:1],
        jb.box_mask[:1], jb.labels[:1], jb.obj_logits[:1],
        jnp.zeros((1, 4, 2), jnp.int32), jnp.ones((1, 4), bool))
    tx = keep_grads(j_make_optimizer(JSolverConfig(**SOLVER), variables["params"],
                                     frozen_prefixes=()))
    rng = jax.random.PRNGKey(12)
    b = BUDGETS
    metrics, grads, new_params, props = run_jax_detector_step(
        jm, variables, tx, jb, rng, LR_SCALE, rpn_batch_size=b.rpn_batch_size,
        box_batch_size=b.box_batch_size, box_positive_fraction=b.box_positive_fraction,
        rpn_pre_nms_top_n=b.rpn_pre_nms_top_n, rpn_post_nms_top_n=b.rpn_post_nms_top_n,
        rpn_fpn_post_nms_top_n=b.rpn_fpn_post_nms_top_n, mask_on=True,
        keypoint_on=True, head_rois_per_image=b.head_rois_per_image)
    return dict(batch=batch, model=model, rng=rng, metrics=metrics, grads=grads,
                new_params=new_params, proposals=Proposals(*props))


def test_pretrain_step_with_mask_and_keypoint_heads_matches_jax(heads_step, monkeypatch):
    """One step with both heads against ``make_detector_train_step`` on its
    own draws and proposals: every loss (``loss_mask``, ``loss_kp``
    included, both positive) and the gradient norm at 1e-5, every
    gradient within 1e-4 of its tensor's largest |g| once clipped (the
    heads' own and the body's, into which the two 14 x 14 pools' backward
    flows), every updated parameter at 1e-5."""
    s = heads_step
    batch, model = s["batch"].to("cpu"), s["model"]
    jp = s["proposals"]
    monkeypatch.setattr(tpretrain, "rpn_select_proposals", lambda *a: jp)
    state = create_detector_state(model, SolverConfig(**SOLVER))
    anchors = sum(a.shape[0] for a in model.anchors(
        [(-(-64 // st),) * 2 for st in model.anchor_strides], "cpu"))
    draws = jax_draws(s["rng"], 2, anchors, jp.mask.shape[1])
    m = detector_forward_backward(state, batch, BUDGETS, draws)
    norm = state.optimizer.step(LR_SCALE)
    jm = s["metrics"]
    for k in ("loss", "loss_objectness", "loss_rpn_box_reg", "loss_classifier",
              "loss_box_reg", "loss_mask", "loss_kp"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        assert float(jm[k]) > 0, k
    np.testing.assert_allclose(float(norm), float(jm["grad_norm"]), rtol=1e-5)
    ref_g, ref_p = _flax_named(s["grads"]), _flax_named(s["new_params"])
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert ref_g.keys() == grads.keys()
    heads = [n for n in grads if n.startswith(("mask_", "keypoint_"))]
    assert len(heads) == 2 * (2 + 2 + 2 + 1)
    clip = min(1.0, SOLVER["grad_clip_norm"] / float(jm["grad_norm"]))
    # the spatial softmax does not see a constant added to a keypoint's
    # map, so kps_score_lowres.bias has a zero gradient: both packages'
    # are rounding noise, far below the step's gradients
    shift = "keypoint_predictor.kps_score_lowres.bias"
    top = max(float(g.abs().max()) for g in ref_g.values())
    assert max(float(grads[shift].abs().max()), float(ref_g[shift].abs().max())) < 1e-6 * top
    assert float(model.state_dict()[shift].abs().max()) < 1e-6 * top  # it started at 0
    for n, g in grads.items():  # .grad holds the clipped gradient
        if n != shift:
            _scaled(g, ref_g[n] * clip, 1e-4, f"grad {n}")
            _scaled(model.state_dict()[n], ref_p[n], 1e-5, f"updated {n}")


# --------------------------------------------- the slice: a relation step
NUM_REL, PAIRS, ATTS = 7, 16, 21
SMALL = dict(num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL, stage_blocks=(1, 1, 1, 1),
             groups=4, width_per_group=4, fpn_channels=32, veto_dim=96, veto_layers=2,
             veto_heads=6, veto_depth_proj_dim=32, veto_visual_proj_dim=16,
             embed_dim=200, fold_bn=True, box_mlp_dim=48, attribute_on=True,
             num_attributes=ATTS)
ATTRIBUTE_CFG = dict(loss_weight=0.1, bgfg_sample=True, bgfg_ratio=3,
                     use_binary_loss=True, pos_weight=5.0)
REL_SOLVER = dict(ims_per_batch=2, base_lr=1e-3, bias_lr_factor=2.0,
                  weight_decay=0.3, weight_decay_bias=0.05, grad_clip_norm=5.0)


@pytest.fixture(scope="module")
def attribute_step():
    """A PredCls model with the attribute head (seeded), 2 synthetic images
    whose boxes carry attribute lists, and one compiled ``make_train_step``
    with ``attribute_cfg`` (Adam, the detector frozen): its metrics, raw
    gradients, and its samples and attribute uniforms for the port."""
    ds = SyntheticSGGDataset(num_images=2, image_size=(64, 96), num_obj_classes=NUM_OBJ,
                             num_rel_classes=NUM_REL, max_objects=6, min_objects=4,
                             max_relations=6, seed=11)
    batch = next(ds.batches(2, 8))[0]
    att, _ = _attribute_case(np.random.RandomState(13), 16, ATTS)
    batch.attributes = att.reshape(2, 8, 10) * batch.box_mask[..., None]
    jb = JBatch(**{k: jnp.asarray(v) for k, v in batch.fields().items()})
    model = SGGModel(**SMALL, dtype=torch.float32, veto_encoder_impl="xla")
    init_weights(model, 1)
    jm = JModel(mode="predcls", **SMALL, dtype=jnp.float32, veto_encoder_impl="xla",
                pooler_impl="separable", veto_remat=False)
    init_args = (jax.random.PRNGKey(0), jb.images[:1], jb.depth[:1], jb.boxes[:1],
                 jb.box_mask[:1], jb.labels[:1], jb.obj_logits[:1],
                 jnp.zeros((1, 4, 2), jnp.int32), jnp.ones((1, 4), bool))
    variables = flax_variables(jm, model, *init_args, method=None)
    params = variables["params"]
    tx = keep_grads(j_make_optimizer(JSolverConfig(**REL_SOLVER), params, FROZEN_DETECTOR))
    key = jax.random.PRNGKey(5)
    state = JTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                        batch_stats=variables["batch_stats"],
                        opt_state=jax.jit(tx.init)(params), rng=key)
    step = j_make_train_step(jm, tx, None, batch_size_per_image=PAIRS,
                             positive_fraction=0.25, mode="predcls",
                             attribute_cfg=ATTRIBUTE_CFG)
    args = (state, jb, jnp.asarray(0.5, jnp.float32))
    from torch_port_det_steps import compiled
    new, metrics = compiled(step, *args)(*args)
    step_rng = jax.random.fold_in(key, 0)
    js = jax.vmap(lambda k, r, m: j_relsample(k, r, m, batch_size=PAIRS,
                                              positive_fraction=0.25))(
        jax.random.split(step_rng, 2), jb.rel_matrix, jb.box_mask)
    uniforms = jax.random.uniform(jax.random.fold_in(step_rng, 7), (16,))
    return dict(batch=batch, model=model, params=params, jm=jm, init_args=init_args,
                metrics=jax.tree.map(np.asarray, metrics),
                grads=jax.tree.map(np.asarray, new.opt_state[1]),
                samples=RelSample(*(_t(a) for a in (js.pair_idx, js.labels, js.mask))),
                uniforms=_t(uniforms))


def _frozen(name):
    return name.startswith(FROZEN_DETECTOR)


def test_attribute_relation_step_matches_jax(attribute_step):
    """One PredCls step with ``attribute_on`` against ``make_train_step``
    on its own samples and attribute uniforms: ``loss``, ``rel_loss`` and
    ``attribute_loss`` at 1e-5; the gradient of every trained tensor
    (``att_score``'s, the depth ResNet's, the relation head's) within 1e-4
    of its largest |g| once clipped, and the update against the JAX
    package's optimizer on the port's clipped gradients (1e-6, as
    ``test_optimizer_matches_optax`` holds Adam).  The norm and the clip
    are over the trained tensors: the frozen box head under ``att_score``
    takes no gradient in the port, while the JAX step's norm counts the
    one its attribute loss sends there (see the next test)."""
    s = attribute_step
    model = s["model"]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, SolverConfig(**REL_SOLVER),
                               attribute_cfg=ATTRIBUTE_CFG)
    m = train_on_pairs(state, s["batch"].to("cpu"), s["samples"], 0.5,
                       attribute_draws=s["uniforms"])
    jm = s["metrics"]
    for k in ("loss", "rel_loss", "attribute_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        assert float(jm[k]) > 0, k
    ref_g = _flax_named(s["grads"])
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert "attribute_predictor.att_score.weight" in trained
    assert not any(_frozen(n) for n in trained)
    norm = float(torch.stack([(ref_g[n].double() ** 2).sum() for n in trained]).sum().sqrt())
    np.testing.assert_allclose(float(m["grad_norm"]), norm, rtol=1e-5)
    clip = min(1.0, 5.0 / norm)
    for n, p in trained.items():
        _scaled(p.grad, ref_g[n] * clip, 1e-4, f"grad {n}")
    # the update: the JAX package's optimizer on the port's clipped
    # gradients (Adam's first step, g / (|g| + eps), would magnify the last
    # bits of a gradient near 0), the frozen tensors' zero
    holder = copy.deepcopy(model)
    for n, p in holder.named_parameters():
        p.data = (trained[n].grad if n in trained else torch.zeros_like(p)).clone()
    g = flax_variables(s["jm"], holder, *s["init_args"], method=None)["params"]
    tx = j_make_optimizer(JSolverConfig(**{**REL_SOLVER, "grad_clip_norm": 1e30}),
                          s["params"], FROZEN_DETECTOR)
    opt = tx.init(s["params"])
    opt.hyperparams["lr_scale"] = jnp.asarray(0.5, jnp.float32)
    upd, _ = jax.jit(tx.update)(g, opt, s["params"])
    want = _flax_named(jax.tree.map(np.asarray, optax.apply_updates(s["params"], upd)))
    for n, p in model.named_parameters():
        if n in want:  # f32 Adam in another operation order (test_torch_port_train)
            np.testing.assert_allclose(_np(p), want[n].numpy(), atol=1e-6, rtol=1e-6,
                                       err_msg=f"updated {n}")
        if _frozen(n):
            assert torch.equal(p, before[n]), n


def test_jax_attribute_step_clips_by_the_frozen_box_heads_gradient(attribute_step):
    """A fault of the JAX package (ROADMAP queue C): its attribute loss
    reaches ``att_score`` through the frozen box head's fc6 / fc7 and
    computes their gradients, which its optimizer never applies but counts
    in the global norm that it clips by (``clip_by_global_norm`` before the
    frozen set's ``set_to_zero``).  So the step's clip, and every trained
    tensor's update, depends on a frozen head's gradient.  Here (seeded
    ``att_score``, N(0, 0.01^2)) that gradient is small; the second half
    shows the dependence on a gradient of the frozen head made large."""
    s = attribute_step
    ref_g = _flax_named(s["grads"])
    frozen = [n for n in ref_g if n.startswith("box_extractor")]
    assert len(frozen) == 4 and all(float(ref_g[n].abs().max()) > 0 for n in frozen)
    tx = j_make_optimizer(JSolverConfig(**REL_SOLVER), s["params"], FROZEN_DETECTOR)
    opt = tx.init(s["params"])
    opt.hyperparams["lr_scale"] = jnp.asarray(0.5, jnp.float32)
    update = jax.jit(tx.update)

    def att_update(scale):
        g = jax.tree_util.tree_map_with_path(
            lambda path, v: v * scale if path[0].key == "box_extractor" else v,
            s["grads"])
        upd, _ = update(g, opt, s["params"])
        return np.asarray(upd["attribute_predictor"]["att_score"]["kernel"])

    base, big = att_update(1.0), att_update(1e4)
    assert not np.allclose(big, base, rtol=1e-3, atol=0)
    assert not np.abs(np.asarray(update(
        s["grads"], opt, s["params"])[0]["box_extractor"]["fc7"]["kernel"])).any()


def test_heads_refuse_a_batch_without_their_targets(heads_step):
    """The mask head trains on the batch's masks and the keypoint head on
    its keypoints: a batch that carries none (what the COCO, VOC and VG
    readers give) is refused with a ``ValueError``, not trained on
    zeros."""
    model = heads_step["model"]
    for masks, kps in ((False, KEYPOINTS), (True, 0)):
        ds = SyntheticSGGDataset(num_images=2, image_size=(64, 64), num_obj_classes=NUM_OBJ,
                                 max_objects=MAX_BOXES - 2, min_objects=3, seed=3,
                                 with_masks=masks, with_keypoints=kps)
        batch = next(ds.batches(2, MAX_BOXES))[0].to("cpu")
        state = create_detector_state(model, SolverConfig(**SOLVER))
        with pytest.raises(ValueError, match="masks" if kps else "keypoints"):
            detector_forward_backward(state, batch, BUDGETS)
