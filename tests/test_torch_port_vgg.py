"""Port parity for the VGG-16 body and its single-level detector
(``configs/vgg_vg_predcls.yaml``): the body alone, the single-level
anchors, RPN proposals and detections, the VGG PredCls eval step and its
train step, each against the JAX package on the same numpy inputs.

Both models are built by the tools' ``build_model`` from the same config
(the JAX tool's geometry: every anchor size on the stride-16 grid, pooler
scale 1/16), toy widths elsewhere (11 object / 7 predicate classes, VETO
96 x 2 layers on the plain encoder, box MLP 32), 64 x 96 images, f32.
The JAX weights are a seeded fill of ``init_all``'s tree
(``torch_port_legacy_case.fill``), carried by the weight bridge.
Tolerances: the body f32 within 2e-5 of max |y|, bf16 3e-2; anchors
bit-equal; RPN maps 1e-5; proposals and detections: the same keep sets
(exact order, labels and masks), boxes 1e-4 px; the eval step's
``pair_idx`` and labels exact, ``rel_scores`` 1e-5, R@K equal; the train
step's loss 1e-5, every gradient within 1e-4 of its tensor's largest |g|.
"""

import os
import sys
from collections import namedtuple
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from veto_tpu.config import load_config as j_load_config
from veto_tpu.engine.batch import SGGBatch as JBatch
from veto_tpu.engine.train import make_eval_step as j_make_eval_step
from veto_tpu.evaluation.sgg_eval import SGGEvaluator as JEvaluator
from veto_tpu.models.backbone.vgg import VGG16Body as JVGG
from veto_tpu.models.detector.anchors import fpn_anchors as j_fpn_anchors
from veto_tpu.models.detector.rpn import flatten_level as j_flatten
from veto_tpu.models.detector.rpn import rpn_select_proposals as j_select
from veto_tpu.models.relation.predictor_veto import weighted_ce_loss as j_wce

from torch_port_det_steps import compiled
from torch_port_legacy_case import fill, scaled, t_
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.config import load_config
from veto_tpu_torch.data.synthetic import SyntheticSGGDataset
from veto_tpu_torch.engine.evaluate import accumulate_eval, make_eval_step, to_numpy
from veto_tpu_torch.engine.train import create_train_state, forward_backward
from veto_tpu_torch.evaluation.sgg_eval import SGGEvaluator
from veto_tpu_torch.models.backbone.vgg import VGG16Body
from veto_tpu_torch.models.relation.sampling import RelSample, gtbox_relsample
from veto_tpu_torch.models.sgg import build_model
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))  # the JAX tool's build_model
NUM_OBJ, NUM_REL, PAIRS = 11, 7, 16
_JState = namedtuple("_JState", "params batch_stats")  # what the JAX eval step reads
OPTS = ["model.num_obj_classes=11", "relation.num_classes=7", "veto.t_input_dim=96",
        "veto.enc_layers=2", "veto.depth_proj_dim=32", "veto.visual_proj_dim=16",
        "veto.encoder_impl=xla", "model.box_mlp_head_dim=32", "data.max_boxes=6",
        "model.rpn_pre_nms_top_n_test=200", "model.rpn_post_nms_top_n_test=50",
        "model.box_detections_per_img=8", "relation.max_proposal_pairs=30",
        "dtype=float32"]


def _cfgs(*extra):
    path = os.path.join(REPO, "configs", "vgg_vg_predcls.yaml")
    return (load_config(path, OPTS + list(extra)),
            j_load_config(path, OPTS + list(extra)))


@pytest.fixture(scope="module")
def case():
    """The SGDet models of the config (the JAX one with every head, so its
    tree serves the PredCls model too), the filled JAX variables and a
    synthetic batch of 2 images of 64 x 96."""
    from relation_train_net import build_model as j_build_model

    cfg, jcfg = _cfgs("relation.use_gt_box=False", "relation.use_gt_object_label=False")
    jm = j_build_model(jcfg)
    ds = SyntheticSGGDataset(num_images=2, image_size=(64, 96), num_obj_classes=NUM_OBJ,
                             num_rel_classes=NUM_REL, max_objects=6, min_objects=4,
                             max_relations=6, seed=11)
    batch, recs = next(ds.batches(2, 6))
    jbatch = JBatch(**{k: jnp.asarray(v) for k, v in batch.fields().items()})
    args = (jbatch.images, jbatch.depth, jbatch.boxes, jbatch.box_mask, jbatch.labels,
            jbatch.obj_logits, jnp.zeros((2, PAIRS, 2), jnp.int32),
            jnp.ones((2, PAIRS), bool))
    shapes = jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a,
                                               method="init_all"), *args)
    variables = fill(shapes, seed=3)
    return SimpleNamespace(cfg=cfg, jm=jm, variables=variables, batch=batch.to("cpu"),
                           jbatch=jbatch, recs=recs)


def _port(cfg, variables):
    """``build_model(cfg)`` on the CPU with the JAX weights it has."""
    model = build_model(cfg, "cpu")
    sd = flax_to_state_dict(variables)
    own = model.state_dict()
    missing, unexpected = model.load_state_dict(
        {k: v for k, v in sd.items() if k in own}, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return model


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_vgg16_body_matches_jax(dtype, tol):
    """``VGG16Body`` on a 64 x 64 image: one (4, 4, 512) map, no ReLU on the
    last conv, within ``tol`` of the largest |y|."""
    rng = np.random.RandomState(0)
    x = (rng.randn(1, 64, 64, 3) * 50).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jb = JVGG(dtype=jdt)
    v = fill(jax.eval_shape(lambda a: jb.init(jax.random.PRNGKey(0), a),
                            jnp.asarray(x)), seed=4)
    ref = np.asarray(jax.jit(jb.apply)(v, jnp.asarray(x))[0].astype(jnp.float32))
    body = VGG16Body(tdt)
    body.load_state_dict(flax_to_state_dict(v))
    with torch.no_grad():
        got = body(t_(x))[0]
    assert got.dtype == tdt and got.shape == (1, 4, 4, 512)
    assert (ref < 0).any()  # conv5_3's pre-activation
    scaled(got, ref, tol, f"VGG16 {dtype}")


def test_build_model_takes_the_single_level_geometry(case):
    """``build_model`` of the VGG config: the VGG body, the anchor sizes as
    one level's at stride 16, 15 anchors a position, pooler scale 1/16,
    the box head's fc6 and the VETO trunk reading 512 channels, as the JAX
    tool builds the model."""
    model = build_model(case.cfg, "cpu")
    jm = case.jm
    assert isinstance(model.backbone, VGG16Body)
    assert model.anchor_sizes == jm.anchor_sizes == ((32, 64, 128, 256, 512),)
    assert model.anchor_strides == tuple(jm.anchor_strides) == (16,)
    assert model.pooler_scales == tuple(jm.pooler_scales) == (0.0625,)
    assert model.rpn.cls_logits.weight.shape == (15, 256, 1, 1)
    assert model.rpn.conv.weight.shape == (256, 512, 3, 3)
    assert model.box_extractor.fc6.weight.shape == (32, 7 * 7 * 512)
    # patch_size 2: each token a 2 x 2 patch of the 512-channel pool
    assert model.relation.trunk.proj_v_subj.weight.shape[1] == 2 * 2 * 512
    with pytest.raises(NotImplementedError, match="deformable"):
        build_model(_cfgs("model.stage_with_dcn=(False,True,False,False)")[0], "cpu")


def test_single_level_detect_matches_jax(case):
    """The anchors of the one stride-16 level bit-equal to ``fpn_anchors``;
    the RPN maps 1e-5; the proposals of each image (``propose`` on the JAX
    maps) with the same keep set and order, boxes 1e-4 px; ``detect``'s
    detections with the same keep set (``orig_idx``), labels and mask,
    boxes 1e-4 px."""
    jm, v = case.jm, case.variables
    images, sizes = case.jbatch.images, case.jbatch.sizes.astype(jnp.float32)

    def jax_side(v, images, sizes):
        def parts(m, images, sizes):
            feats = m.extract_features(images)
            obj, reg = m.rpn(feats)
            return feats, obj, reg, m.detect(images, sizes)
        return jm.apply(v, images, sizes, method=parts)

    feats, obj, reg, det = jax.tree.map(
        np.asarray, compiled(jax_side, v, images, sizes)(v, images, sizes))
    model = _port(case.cfg, v)
    h, w = images.shape[1:3]
    ref_anchors = j_fpn_anchors((h, w), jm.anchor_sizes, jm.anchor_strides,
                                jm.aspect_ratios)
    with torch.no_grad():
        tfeats = model.extract_features(case.batch.images)
        scaled(tfeats[0], feats[0], 2e-5, "VGG map")
        anchors = model.anchors([m.shape[1:3] for m in obj], "cpu")
        assert len(anchors) == 1
        np.testing.assert_array_equal(anchors[0].numpy(), ref_anchors[0][0])
        tobj, treg = model.rpn_maps(tfeats)
        scaled(tobj[0], obj[0], 1e-5, "objectness")
        scaled(treg[0], reg[0], 1e-5, "deltas")
        props = model.propose((t_(obj[0]),), (t_(reg[0]),), case.batch.sizes)
        got = model.detect(case.batch.images, case.batch.sizes)

    def jprops(o, r, size):
        f = j_flatten(o, r)
        return j_select([f[0]], [f[1]], (jnp.asarray(ref_anchors[0][0]),), size,
                        jm.rpn_pre_nms_top_n, jm.rpn_post_nms_top_n, jm.rpn_nms_thresh,
                        jm.rpn_fpn_post_nms_top_n, jm.rpn_min_size)

    jp = jax.tree.map(np.asarray, jax.jit(jax.vmap(jprops))(obj[0], reg[0], sizes))
    np.testing.assert_array_equal(props.mask.numpy(), jp.mask)
    assert props.mask.sum() > 20
    np.testing.assert_allclose(props.boxes.numpy(), jp.boxes, rtol=0, atol=1e-4)
    dets, jd = got.detections, det.detections
    assert dets.mask.sum() > 0
    np.testing.assert_array_equal(dets.mask.numpy(), jd.mask)
    np.testing.assert_array_equal(dets.orig_idx.numpy(), jd.orig_idx)
    np.testing.assert_array_equal(dets.labels.numpy(), jd.labels)
    np.testing.assert_allclose(dets.boxes.numpy(), jd.boxes, rtol=0, atol=1e-4)
    scaled(got.predict_logits, det.predict_logits, 1e-5, "detection logits")


def _predcls(case):
    cfg = case.cfg.override("relation.use_gt_box", True).override(
        "relation.use_gt_object_label", True)
    assert cfg.relation.mode == "predcls"
    return cfg, _port(cfg, case.variables)


def test_vgg_predcls_eval_step_matches_jax(case):
    """The VGG PredCls eval step (``make_eval_step``) against the JAX one:
    ``pair_idx``, the labels and the masks exact, ``rel_scores`` 1e-5, and
    R@K / mR@K equal through both evaluators."""
    from relation_train_net import build_model as j_build_model

    cfg, model = _predcls(case)
    jm = j_build_model(_cfgs()[1])
    state = _JState(case.variables["params"], case.variables["batch_stats"])
    step = j_make_eval_step(jm, max_pairs=cfg.relation.max_proposal_pairs)
    ref = jax.tree.map(np.asarray, compiled(step, state, case.jbatch)(state, case.jbatch))
    got = to_numpy(make_eval_step(model, cfg.relation.max_proposal_pairs)(case.batch))
    for f in ("pair_idx", "pair_mask", "rel_labels", "obj_labels"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), f)
    scaled(got.rel_scores, ref.rel_scores, 1e-5, "rel_scores")
    ev, jev = SGGEvaluator("predcls", NUM_REL), JEvaluator("predcls", NUM_REL)
    accumulate_eval(got, case.recs, ev)
    for i, rec in enumerate(case.recs):
        n, pm = len(rec["boxes"]), ref.pair_mask[i]
        jev.add_image(rec["boxes"], rec["labels"], rec["rel_tuples"], rec["boxes"],
                      ref.obj_labels[i][:n], ref.obj_scores[i][:n],
                      ref.pair_idx[i][pm], ref.rel_scores[i][pm])
    assert ev.aggregate()["R"] == jev.aggregate()["R"]
    assert ev.aggregate()["mR"] == jev.aggregate()["mR"]


def test_vgg_predcls_train_step_matches_jax(case):
    """One VGG PredCls step's gradients (``forward_backward``, f32) against
    ``jax.value_and_grad`` of the JAX step's loss on the same sampled pairs:
    ``SGGModel.__call__``'s PredCls path (``relate`` with the ±1000 label
    logits) from the JAX body's f32 map, run in float64 (``jax.enable_x64``;
    in f32 its depth ResNet's train-mode BatchNorm sums put its own
    early-layer gradients 1-8% of their largest |g| off its float64 run on
    this case, ROADMAP queue C): the loss 1e-5, every trained tensor (the
    depth ResNet, the VETO head) within 1e-4 of its largest |g|, the frozen
    VGG body untouched and out of autograd."""
    from relation_train_net import build_model as j_build_model

    cfg, model = _predcls(case)
    b = case.batch
    s = gtbox_relsample(b.rel_matrix, b.box_mask, torch.Generator().manual_seed(2), PAIRS)
    cw = np.linspace(0.5, 1.5, NUM_REL).astype(np.float32)
    jm32 = j_build_model(_cfgs()[1])
    feats = jax.jit(lambda v, x: jm32.apply(v, x, method="extract_features"))(
        case.variables, case.jbatch.images)  # the frozen body's map, f32
    with jax.enable_x64(True):
        jm = jm32.clone(dtype=jnp.float64)
        wide = lambda a: (np.asarray(a, np.float64)  # noqa: E731
                          if np.asarray(a).dtype == np.float32 else np.asarray(a))
        params, stats, jb, feats = (jax.tree.map(wide, t) for t in (
            case.variables["params"], case.variables["batch_stats"], case.jbatch, feats))
        pi, labels, mask = (jnp.asarray(t.numpy()) for t in (s.pair_idx, s.labels, s.mask))
        inject = jax.nn.one_hot(jb.labels, NUM_OBJ, dtype=jnp.float64) * 2000.0 - 1000.0

        def jloss(p):  # SGGModel.__call__'s PredCls path from the body's map
            out, _ = jm.apply({"params": p, "batch_stats": stats}, feats, jb.depth,
                              jb.boxes, jb.box_mask, jb.labels, inject, pi, mask,
                              train=True, mutable=["batch_stats"], method="relate")
            return j_wce(out.rel_logits, labels, mask, jnp.asarray(cw, jnp.float64))

        jl, jg = jax.tree.map(lambda a: np.asarray(a, np.float32),
                              jax.jit(jax.value_and_grad(jloss))(params))
    body = {k: v.clone() for k, v in model.backbone.state_dict().items()}
    state = create_train_state(model, cfg.solver, cw)
    got = forward_backward(state, b, RelSample(s.pair_idx, s.labels, s.mask))
    np.testing.assert_allclose(float(got["loss"]), float(jl), rtol=1e-5)
    ref = flax_to_state_dict({"params": jg})
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert {n.split(".")[0] for n in trained} == {"depth_backbone", "relation"}
    for n, p in trained.items():
        scaled(p.grad, ref[n].numpy(), 1e-4, n)
    assert all(p.grad is None for p in model.backbone.parameters())
    for k, v in model.backbone.state_dict().items():
        assert torch.equal(v, body[k]), k
