"""Port parity for SGDet: the pair sampler over detections, the test pairs
with ``require_overlap``, the SGDet post-processor, the eval step as a
stage ladder and the train step's gradients, against the JAX package.

The model is the tiny SGDet model of ``tests/test_sgdet.py`` (11 object /
7 predicate classes, 64x64 images, RPN budgets 64/16/24, 8 detections, a
64-wide box head, f32), with the small relation trunk of the SGCls parity
test and the plain (``xla``) encoder on both sides.  End-to-end greedy
selections in f32 are chaotic in the ulp noise of two implementations, so
the eval step is held as a ladder: each stage is computed from the JAX
package's own input to that stage, selections exactly, values to their
f32 tolerances.  ``detect_relsample`` cannot repeat ``jax.random``'s draws:
its deterministic parts are held to JAX's, its random ones to its rules,
one rule a case.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from veto_tpu.engine.batch import SGGBatch as JBatch
from veto_tpu.evaluation.coco_map import CocoMapEvaluator as JCoco
from veto_tpu.models.detector.anchors import fpn_anchors as j_fpn_anchors
from veto_tpu.evaluation.sgg_eval import SGGEvaluator as JEvaluator
from veto_tpu.models.detector.box_head import (
    assign_labels_to_proposals as j_assign, box_postprocess as j_box_postprocess,
)
from veto_tpu.models.detector.rpn import flatten_level as j_flatten
from veto_tpu.models.detector.rpn import rpn_select_proposals as j_select
from veto_tpu.models.relation.postprocess import (
    postprocess_relations_sgdet as j_post_sgdet,
)
from veto_tpu.models.relation.predictor_veto import weighted_ce_loss as j_wce
from veto_tpu.models.relation.sampling import (
    detect_relsample as j_detect_relsample, prepare_test_pairs as j_pairs,
)
from veto_tpu.models.sgg import SGGModel as JModel

from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.config import SolverConfig
from veto_tpu_torch.data.predicate_stats import predicate_counts
from veto_tpu_torch.data.synthetic import SyntheticSGGDataset
from veto_tpu_torch.engine.evaluate import accumulate_eval, make_eval_step, to_numpy
from veto_tpu_torch.engine.train import (
    DetSample, create_train_state, forward_backward, train_on_pairs,
)
from veto_tpu_torch.evaluation.coco_map import CocoMapEvaluator
from veto_tpu_torch.evaluation.sgg_eval import SGGEvaluator
from veto_tpu_torch.models.detector.box_head import Detections
from veto_tpu_torch.models.detector.rpn import Proposals
from veto_tpu_torch.models.relation.postprocess import (
    SGDetPrediction, postprocess_relations_sgdet,
)
from veto_tpu_torch.models.relation.predictor_veto import beta_class_weights
from veto_tpu_torch.models.relation.sampling import (
    DetRelSample, detect_relsample, prepare_test_pairs,
)
from veto_tpu_torch.models.sgg import DetectOutput, SGGModel
from veto_tpu_torch.solver.optim import FROZEN_DETECTOR
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_variables

NUM_OBJ, NUM_REL, MAX_BOXES, DETS, PAIRS = 11, 7, 6, 8, 24
DEPTH_SEED = 2  # the train step's depth draw (see its test)
TINY = dict(num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL,
            stage_blocks=(1, 1, 1, 1), groups=1, width_per_group=16,
            fpn_channels=32, rpn_pre_nms_top_n=64, rpn_post_nms_top_n=16,
            rpn_fpn_post_nms_top_n=24, detections_per_img=DETS, box_mlp_dim=64,
            veto_dim=48, veto_layers=2, veto_heads=6, veto_depth_proj_dim=32,
            veto_visual_proj_dim=16, fold_bn=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _scaled(got, ref, tol, what):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, atol=tol * max(float(np.abs(ref).max()), 1e-6),
                               rtol=0, err_msg=what)


# ------------------------------------------------------------ the sampler
def _sampler_inputs(seed, t=8, d=16, n_rel=5):
    """A GT image and detections: every valid GT box has one to three
    detections near it with its label (matches: IoU > 0.5), and a third of
    the detections carry another label (no match)."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 200, (t, 2))
    gt = np.concatenate([xy, xy + rng.uniform(30, 80, (t, 2))], 1).astype(np.float32)
    gl = rng.randint(1, NUM_OBJ, t).astype(np.int32)
    gm = np.ones(t, bool)
    gm[-1] = False
    rel = np.zeros((t, t), np.int32)
    for _ in range(n_rel):
        s, o = rng.choice(t - 1, 2, replace=False)
        rel[s, o] = rng.randint(1, NUM_REL)
    src = np.concatenate([np.arange(t - 1), rng.randint(0, t - 1, d - t + 1)])
    boxes = gt[src] + rng.uniform(-4, 4, (d, 4)).astype(np.float32)
    labels = gl[src].copy()
    other = rng.rand(d) < 1 / 3
    labels[other] = (labels[other] % (NUM_OBJ - 1)) + 1  # no match there
    scores = rng.rand(d).astype(np.float32)
    mask = np.ones(d, bool)
    mask[-1] = False
    return rel, gt, gl, gm, boxes, labels, scores, mask


def _both_samplers(inputs, gen, **kw):
    rel, gt, gl, gm, boxes, labels, scores, mask = inputs
    ref = j_detect_relsample(jax.random.PRNGKey(0), jnp.asarray(rel), jnp.asarray(rel),
                             *(jnp.asarray(a) for a in (gt, gl, gm, boxes, labels,
                                                        scores, mask)), **kw)
    got = detect_relsample(*(_t(a)[None] for a in (rel, rel, gt, gl, gm, boxes, labels,
                                                    scores, mask)), gen, **kw)
    return jax.tree.map(np.asarray, ref), DetRelSample(*(x[0].numpy() for x in got))


def _triples(s):
    m = s.mask
    return sorted(zip(s.pair_idx[m, 0].tolist(), s.pair_idx[m, 1].tolist(),
                      s.labels[m].tolist(), s.labels_all[m].tolist()))


@pytest.mark.parametrize("require_overlap", [False, True])
def test_detect_relsample_unforced_sets_match_jax(require_overlap):
    """With budgets that force no draw (every candidate of every GT relation
    kept, every background pair kept) the sample is a set JAX's equals:
    the same (head, tail, label) triples, fg first then bg, and the same
    ``binary_rel``; the padding is label -1 at (0, 0)."""
    for seed in range(3):
        inputs = _sampler_inputs(seed)
        gen = torch.Generator().manual_seed(seed)
        ref, got = _both_samplers(inputs, gen, batch_size=400, positive_fraction=0.5,
                                  num_sample_per_gt_rel=16,
                                  require_overlap=require_overlap)
        assert got.pair_idx.shape == ref.pair_idx.shape
        assert _triples(got) == _triples(ref)
        np.testing.assert_array_equal(got.binary_rel, ref.binary_rel)
        nfg = int((got.labels[got.mask] > 0).sum())
        assert nfg > 0 and (got.labels[:nfg] > 0).all()
        assert (got.labels[~got.mask] == -1).all() and (got.pair_idx[~got.mask] == 0).all()
        np.testing.assert_array_equal(got.mask, ref.mask)


RULES = ["match", "per-rel cap", "fg cap", "bg pool", "quality pool", "dummy",
         "labels_all"]


@pytest.mark.parametrize("rule", RULES)
def test_detect_relsample_rules(rule):
    """The sampler's rules under binding budgets, over several draws:

    match        -- a fg pair joins two distinct detections that match the
                    GT relation's head and tail (same label, IoU > 0.5);
    per-rel cap  -- at most ``num_sample_per_gt_rel`` pairs a GT relation;
    fg cap       -- at most ``batch_size * positive_fraction`` fg pairs;
    bg pool      -- a bg pair joins two distinct valid detections with
                    nonzero labels, is no GT relation's candidate, and with
                    ``require_overlap`` overlaps (0 < IoU < 1);
    quality pool -- the bg pairs come from the 2 num_neg best by score
                    product;
    dummy        -- nothing to sample: two (0, 0) pairs of label 0;
    labels_all   -- fg labels from the full matrix where it differs."""
    from veto_tpu_torch.ops.box_ops import box_iou

    for seed in range(4):
        rel, gt, gl, gm, boxes, labels, scores, mask = _sampler_inputs(seed, n_rel=6)
        gen = torch.Generator().manual_seed(seed)
        kw = dict(batch_size=24, positive_fraction=0.25, num_sample_per_gt_rel=2,
                  require_overlap=rule == "bg pool" and seed % 2 == 1)
        rel_all = rel.copy()
        if rule == "dummy":
            labels = np.zeros_like(labels)
        if rule == "labels_all":
            rel_all[rel > 0] = NUM_REL - 1
        s = detect_relsample(*(_t(a)[None] for a in (rel, rel_all, gt, gl, gm, boxes,
                                                      labels, scores, mask)), gen, **kw)
        pi, lab, lab_all, m = (x[0].numpy() for x in s[:4])
        iou = box_iou(_t(gt), _t(boxes)).numpy()
        match = (gl[:, None] == labels[None]) & (iou > 0.5) & mask[None] & gm[:, None]
        fg = m & (lab > 0)
        nfg = int(fg.sum())
        if rule == "dummy":
            assert m.sum() == 2 and (pi[:2] == 0).all() and (lab[:2] == 0).all()
            continue
        assert fg[:nfg].all() and not fg[nfg:].any()           # fg first
        heads, tails = pi[:nfg, 0], pi[:nfg, 1]
        if rule == "match":
            for h, t_, lb in zip(heads, tails, lab[:nfg]):
                assert h != t_ and any(
                    match[a, h] and match[b, t_] and rel[a, b] == lb
                    for a, b in zip(*np.nonzero(rel)))
        if rule == "per-rel cap":
            # a pair that only one GT relation can have produced counts for it
            rels = list(zip(*np.nonzero(rel)))
            own = {r: 0 for r in rels}
            for h, t_ in zip(heads, tails):
                of = [(a, b) for a, b in rels if match[a, h] and match[b, t_]]
                if len(of) == 1:
                    own[of[0]] += 1
            assert max(own.values()) <= 2
        if rule == "fg cap":
            assert nfg <= 6
        bg = m & (lab == 0)
        bh, bt = pi[bg, 0], pi[bg, 1]
        cand = {(h, t_) for a, b in zip(*np.nonzero(rel)) for h in np.nonzero(match[a])[0]
                for t_ in np.nonzero(match[b])[0] if h != t_}
        if rule == "bg pool":
            for h, t_ in zip(bh, bt):
                assert h != t_ and mask[h] and mask[t_] and labels[h] and labels[t_]
                assert (h, t_) not in cand
                if kw["require_overlap"]:
                    o = box_iou(_t(boxes[h:h + 1]), _t(boxes[t_:t_ + 1])).item()
                    assert 0 < o < 1
        if rule == "quality pool":
            ok = mask & (labels > 0)
            pool = [(scores[h] * scores[t_], h, t_) for h in range(len(ok))
                    for t_ in range(len(ok)) if ok[h] and ok[t_] and h != t_
                    and (h, t_) not in cand]
            num_neg = min(24 - nfg, len(pool))
            assert len(bh) == num_neg
            best = sorted(pool, key=lambda x: -x[0])[2 * num_neg - 1][0]
            assert all(scores[h] * scores[t_] >= best for h, t_ in zip(bh, bt))
        if rule == "labels_all":
            assert nfg and (lab_all[:nfg] == NUM_REL - 1).all()
            assert (lab[:nfg] != lab_all[:nfg]).any()


# ----------------------------------------------------- pairs, post-process
def test_prepare_test_pairs_require_overlap_matches_jax():
    """Test pairs by score product with and without ``require_overlap``:
    pairs and mask exactly JAX's (exact ties in row-major order)."""
    rng = np.random.RandomState(4)
    xy = rng.uniform(0, 100, (2, 10, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (2, 10, 2))], -1
                           ).astype(np.float32)
    mask = rng.rand(2, 10) > 0.2
    scores = np.round(rng.rand(2, 10), 1).astype(np.float32)
    for ro in (False, True):
        got = prepare_test_pairs(_t(mask), _t(scores), 40, boxes=_t(boxes),
                                 require_overlap=ro)
        for i in range(2):
            ref = j_pairs(jnp.asarray(mask[i]), jnp.asarray(scores[i]),
                          jnp.asarray(boxes[i]), max_pairs=40, require_overlap=ro)
            np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(ref[0]))
            np.testing.assert_array_equal(got[1][i].numpy(), np.asarray(ref[1]))
    assert got[1].sum() < prepare_test_pairs(_t(mask), _t(scores), 40)[1].sum()


def test_postprocess_relations_sgdet_matches_jax():
    """The late object NMS on the detector's logits, the class-specific box
    and the stable triple-score sort: labels, boxes and order exactly."""
    rng = np.random.RandomState(8)
    b, n, p = 2, 8, 30
    xy = rng.uniform(0, 60, (b, n, NUM_OBJ, 2))
    bpc = np.concatenate([xy, xy + rng.uniform(5, 30, (b, n, NUM_OBJ, 2))], -1
                         ).astype(np.float32)
    logits = (rng.randn(b, n, NUM_OBJ) * 2).astype(np.float32)
    rel = (rng.randn(b, p, NUM_REL) * 2).astype(np.float32)
    pi = rng.randint(0, n, (b, p, 2)).astype(np.int32)
    pm = rng.rand(b, p) > 0.2
    dm = rng.rand(b, n) > 0.2
    got = postprocess_relations_sgdet(_t(rel), _t(logits), _t(pi), _t(pm), _t(bpc),
                                      _t(dm), later_nms_thres=0.3)
    for i in range(b):
        ref = j_post_sgdet(*(jnp.asarray(a[i]) for a in (rel, logits, pi, pm, bpc, dm)),
                           later_nms_thres=0.3)
        for name in ("obj_labels", "det_mask", "pair_idx", "rel_labels", "pair_mask",
                     "boxes"):
            np.testing.assert_array_equal(getattr(got, name)[i].numpy(),
                                          np.asarray(getattr(ref, name)), name)
        for name in ("obj_scores", "rel_scores"):
            np.testing.assert_allclose(getattr(got, name)[i].numpy(),
                                       np.asarray(getattr(ref, name)), atol=1e-6,
                                       err_msg=name)


# ----------------------------------------------------- the model's ladder
def _cascade(m, images, sizes):
    """The JAX ``SGGModel.detect`` cascade (``veto_tpu/models/sgg.py:427-470``)
    with its stage outputs kept: features, RPN maps, proposals, box logits
    and deltas, detections and their logits."""
    feats = m.extract_features(images)
    anchors = tuple(jnp.asarray(a) for a, _ in j_fpn_anchors(
        images.shape[1:3], m.anchor_sizes, m.anchor_strides, m.aspect_ratios))
    obj, reg = m.rpn(feats)
    obj = tuple(o.astype(jnp.float32) for o in obj)
    reg = tuple(r.astype(jnp.float32) for r in reg)

    def propose_one(o, r, size):
        flat = [j_flatten(a, b) for a, b in zip(o, r)]
        return j_select([f[0] for f in flat], [f[1] for f in flat], anchors, size,
                        m.rpn_pre_nms_top_n, m.rpn_post_nms_top_n, m.rpn_nms_thresh,
                        m.rpn_fpn_post_nms_top_n, m.rpn_min_size)

    props = jax.vmap(propose_one)(obj, reg, sizes)
    logits, deltas = m._box_logits(feats, props.boxes)
    dets = jax.vmap(lambda lg, dl, bx, mk, sz: j_box_postprocess(
        lg, dl, bx, mk, sz, score_thresh=m.box_score_thresh,
        nms_thresh=m.box_nms_thresh, post_nms_per_cls_topn=m.box_post_nms_per_cls_topn,
        nms_filter_duplicates=m.nms_filter_duplicates,
        detections_per_img=m.detections_per_img))(
        logits, deltas, props.boxes, props.mask, sizes)
    det_logits = jnp.take_along_axis(logits, dets.orig_idx[..., None], axis=1)
    return feats, obj, reg, props, logits, deltas, dets, det_logits


@pytest.fixture(scope="module")
def sgdet_setup():
    """The tiny SGDet model's flax variables (``init_all``), the port model
    with the same weights, a synthetic batch of 2 images, and the JAX
    package's detection cascade on it, stage by stage."""
    ds = SyntheticSGGDataset(num_images=2, image_size=(64, 64),
                             num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL,
                             max_objects=MAX_BOXES - 2, min_objects=3,
                             max_relations=4, seed=3)
    batch, recs = next(ds.batches(2, MAX_BOXES))
    jb = JBatch(**{k: jnp.asarray(v) for k, v in batch.fields().items()})
    jm = JModel(mode="sgdet", **TINY, dtype=jnp.float32, veto_encoder_impl="xla",
                pooler_impl="separable", veto_remat=False)
    variables = jax.jit(jm.init, static_argnames="method")(
        jax.random.PRNGKey(0), jb.images[:1], jb.depth[:1], jb.boxes[:1],
        jb.box_mask[:1], jb.labels[:1], jb.obj_logits[:1],
        jnp.zeros((1, 4, 2), jnp.int32), jnp.ones((1, 4), bool), method="init_all")
    variables = jax.tree.map(np.asarray, variables)
    sizes = jb.sizes.astype(jnp.float32)
    stages = jax.jit(lambda v, im, sz: jm.apply(v, im, sz, method=_cascade))(
        variables, jb.images, sizes)
    names = ("feats", "obj", "reg", "props", "logits", "deltas", "dets", "det_logits")
    model = SGGModel(mode="sgdet", **TINY, dtype=torch.float32,
                     veto_encoder_impl="xla").eval()
    load_flax_variables(model, variables)
    return dict(jm=jm, variables=variables, batch=batch, jb=jb, recs=recs,
                model=model, sizes=sizes, **dict(zip(names, stages)))


def _port_dets(jd):
    return Detections(*(_t(getattr(jd, f)) for f in jd._fields))


def test_sgdet_eval_ladder_matches_jax(sgdet_setup):
    """Each stage from the JAX package's own input to it: the FPN (1e-4 of
    its scale), the RPN maps (1e-5), the proposals (selection exact), the
    box head (1e-5), the detections (selection exact, every field), the
    test pairs (exact), ``rel_logits`` (1e-4) and the SGDet post-processor
    (exact); then both evaluators, COCO mAP included, on the same
    predictions, and the port's whole eval step end to end (shapes)."""
    s = sgdet_setup
    jm, v, jb, model = s["jm"], s["variables"], s["jb"], s["model"]
    tb = s["batch"].to("cpu")
    jfeats = [_t(f) for f in s["feats"]]
    with torch.no_grad():
        feats = model.extract_features(tb.images)
    for g, r in zip(feats, s["feats"]):
        _scaled(g, r, 1e-4, "FPN")
    obj, reg = model.rpn_maps(jfeats)
    for g, r in zip(obj + reg, s["obj"] + s["reg"]):
        _scaled(g, r, 1e-5, "RPN maps")
    jp = s["props"]
    props = model.propose(tuple(_t(o) for o in s["obj"]),
                          tuple(_t(r) for r in s["reg"]), tb.sizes)
    np.testing.assert_array_equal(props.mask.numpy(), np.asarray(jp.mask))
    _scaled(props.boxes, jp.boxes, 1e-6, "proposals")
    assert props.mask.sum() > 10
    logits, deltas = model.box_head(jfeats, _t(jp.boxes))
    _scaled(logits, s["logits"], 1e-5, "box logits")
    _scaled(deltas, s["deltas"], 1e-5, "box deltas")
    jdet = s["dets"]
    dets = model.postprocess_boxes(_t(s["logits"]), _t(s["deltas"]),
                                   Proposals(_t(jp.boxes), _t(jp.objectness),
                                             _t(jp.mask)), tb.sizes)
    for name in ("labels", "mask", "orig_idx"):
        np.testing.assert_array_equal(getattr(dets, name).numpy(),
                                      np.asarray(getattr(jdet, name)), name)
    for name in ("boxes", "boxes_per_cls", "scores"):
        _scaled(getattr(dets, name), getattr(jdet, name), 1e-6, name)
    assert dets.mask.sum() >= 8

    # the relation head and the post-processor on JAX's detections
    jpi, jpm = jax.vmap(lambda m, sc, bx: j_pairs(m, sc, bx, max_pairs=DETS * DETS))(
        jdet.mask, jdet.scores, jdet.boxes)
    pi, pm = prepare_test_pairs(_t(jdet.mask), _t(jdet.scores), DETS * DETS)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(jpi))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jpm))

    def jrelate_post(v, feats, depth, d, det_logits, pi, pm):
        out = jm.apply(v, feats, depth, d.boxes, d.mask, d.labels, det_logits, pi,
                       pm, train=False, method="relate")
        return out.rel_logits, jax.vmap(j_post_sgdet)(
            out.rel_logits, det_logits, pi, pm, d.boxes_per_cls, d.mask)

    jrel, jpost = jax.jit(jrelate_post)(v, s["feats"], jb.depth, jdet,
                                        s["det_logits"], jpi, jpm)
    with torch.no_grad():
        out = model.relate(jfeats, tb.depth, _t(jdet.boxes), _t(jdet.mask),
                           _t(jdet.labels), pi, _t(s["det_logits"]))
    _scaled(out.rel_logits, jrel, 1e-4, "rel_logits")
    post = postprocess_relations_sgdet(_t(jrel), _t(s["det_logits"]), pi, pm,
                                       _t(jdet.boxes_per_cls), _t(jdet.mask))
    for name in ("obj_labels", "pair_idx", "rel_labels", "pair_mask", "boxes"):
        np.testing.assert_array_equal(getattr(post, name).numpy(),
                                      np.asarray(getattr(jpost, name)), name)

    # both evaluators on the same predictions (the tools' sgdet branch)
    preds = to_numpy(post)
    jev, jcoco = JEvaluator("sgdet", NUM_REL), JCoco(NUM_OBJ)
    for i, rec in enumerate(s["recs"]):
        dm, pmi = preds.det_mask[i], preds.pair_mask[i]
        remap = np.cumsum(dm) - 1
        jev.add_image(rec["boxes"], rec["labels"], rec["rel_tuples"], preds.boxes[i][dm],
                      preds.obj_labels[i][dm], preds.obj_scores[i][dm],
                      remap[preds.pair_idx[i][pmi]], preds.rel_scores[i][pmi])
        jcoco.add_image(rec["boxes"], rec["labels"], preds.boxes[i][dm],
                        preds.obj_labels[i][dm], preds.obj_scores[i][dm])
    tev, tcoco = SGGEvaluator("sgdet", NUM_REL), CocoMapEvaluator(NUM_OBJ)
    accumulate_eval(preds, s["recs"], tev, np.asarray(s["batch"].sizes), tcoco)
    assert tev.aggregate() == jev.aggregate()
    assert tcoco.aggregate() == jcoco.aggregate()

    got = make_eval_step(model, max_pairs=DETS * DETS, mode="sgdet")(tb)
    assert isinstance(got, SGDetPrediction)
    assert got.boxes.shape == (2, DETS, 4) and got.pair_idx.shape == (2, DETS * DETS, 2)
    assert got.det_mask.any(1).all()


def _solver():
    return SolverConfig(ims_per_batch=2, base_lr=1e-3, bias_lr_factor=2.0,
                        weight_decay=0.3, weight_decay_bias=0.05, grad_clip_norm=5.0)


def _train_case(s, depth):
    """The SGDet train step's inputs on ``sgdet_setup``'s batch with the
    depth map ``depth``: GT boxes and labels taken from the JAX
    package's detections (seeded weights detect nothing the synthetic GT
    holds), with seeded relations among them so that the sampler finds
    foreground, JAX's GT-assigned labels and samples, the Rwt weights, and
    ``jloss(params)`` → (loss, (rel_loss, obj_loss)) of
    ``make_sgdet_train_step``."""
    jm, v, jd = s["jm"], s["variables"], s["dets"]
    stats = v["batch_stats"]
    batch = copy.copy(s["batch"])
    batch.depth = depth
    jb = type(s["jb"])(**{**vars(s["jb"]), "depth": jnp.asarray(depth)})
    rng = np.random.RandomState(12)
    gt_boxes, gt_lab, gt_mask = (np.array(a)[:, :MAX_BOXES]
                                 for a in (jd.boxes, jd.labels, jd.mask))
    rel = rng.randint(1, NUM_REL, (2, MAX_BOXES, MAX_BOXES)) * (
        rng.rand(2, MAX_BOXES, MAX_BOXES) < 0.3) * (1 - np.eye(MAX_BOXES, dtype=int))
    rel = (rel * gt_mask[:, :, None] * gt_mask[:, None, :]).astype(np.int32)
    gt_labels, _ = jax.vmap(j_assign)(jd.boxes, jd.mask, gt_boxes, gt_lab, gt_mask)
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    js = jax.vmap(lambda k, r, gb, gl, gm, pb, pl, ps, pm: j_detect_relsample(
        k, r, r, gb, gl, gm, pb, pl, ps, pm, batch_size=PAIRS))(
        keys, jnp.asarray(rel), gt_boxes, gt_lab, gt_mask, jd.boxes, gt_labels,
        jd.scores, jd.mask)
    assert int((js.labels > 0).sum()) > 0  # foreground to learn from
    cw = beta_class_weights(predicate_counts("VG")[:NUM_REL])

    def jloss(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats}, s["feats"], jb.depth,
                          jd.boxes, jd.mask, jd.labels, s["det_logits"],
                          js.pair_idx, js.mask, train=True, mutable=["batch_stats"],
                          method="relate")
        rel = j_wce(out.rel_logits, js.labels, js.mask, jnp.asarray(cw))
        obj = j_wce(out.obj_dists, gt_labels, jd.mask, None)
        return rel + obj, (rel, obj)

    return dict(batch=batch, jb=jb, js=js, gt_labels=gt_labels, cw=cw, jloss=jloss)


def _port_step(s, case):
    """A port SGDet model with the setup's weights, its train state, and the
    step's ``DetSample``: the JAX package's detections, GT-assigned labels
    and samples of ``case``."""
    model = SGGModel(mode="sgdet", **TINY, dtype=torch.float32,
                     veto_encoder_impl="xla")
    load_flax_variables(model, s["variables"])
    state = create_train_state(model, _solver(), case["cw"], mode="sgdet")
    samples = DetSample(
        DetectOutput([_t(f) for f in s["feats"]], _port_dets(s["dets"]),
                     _t(s["det_logits"])),
        _t(case["gt_labels"]), DetRelSample(*(_t(a) for a in case["js"])))
    return model, state, samples


def test_sgdet_train_step_matches_jax(sgdet_setup):
    """One SGDet step fed the JAX package's own detections, GT-assigned
    labels and samples (``detect_relsample``): ``rel_loss`` and ``obj_loss``
    to 1e-5, every trainable gradient within 1e-4 of its tensor's largest
    |g| against ``jax.grad`` of ``make_sgdet_train_step``'s loss (f32); the
    detector, RPN and box head unchanged by the update.

    The depth map is a fresh uniform draw, held to a condition first: at
    64x64 the depth ResNet's last stage is 4x4, and a ReLU whose input lies
    within the two implementations' f32 forward difference (~1e-6) can take
    the other branch and move that stage's weight gradients by tens of %
    (the batch's own synthetic depth does: 1e-6 of noise on it moves the
    port's own gradients by 46%).  The comparison is well posed only where
    the gradient is continuous at that scale, so the test first requires
    1e-7 of noise on the depth to move no gradient by more than 1e-5."""
    s = sgdet_setup
    v = s["variables"]
    depth = np.random.RandomState(DEPTH_SEED).uniform(
        -1, 1, s["batch"].depth.shape).astype(np.float32)
    case = _train_case(s, depth)
    batch = case["batch"]
    (jl, (jrel, jobj)), jg = jax.jit(jax.value_and_grad(case["jloss"], has_aux=True))(
        v["params"])
    norm = float(np.sqrt(sum(float((np.asarray(g) ** 2).sum())
                             for g in jax.tree.leaves(jg))))
    clip = 1.0 if norm < 5.0 else 5.0 / norm
    ref = flax_to_state_dict({"params": jax.tree.map(lambda g: np.asarray(g) * clip, jg)})

    model, state, samples = _port_step(s, case)
    frozen = {k: t.clone() for k, t in model.state_dict().items()
              if k.startswith(FROZEN_DETECTOR)}
    assert any(k.startswith("rpn.") for k in frozen)
    tb = batch.to("cpu")

    def port_grads(depth):
        forward_backward(state, type(tb)(**{**vars(tb), "depth": depth}), samples)
        return {n: p.grad.clone() for n, p in model.named_parameters()
                if p.requires_grad}

    g0 = port_grads(tb.depth)
    noise = torch.from_numpy(np.random.RandomState(2).randn(*batch.depth.shape)
                             .astype(np.float32))
    g1 = port_grads(tb.depth + 1e-7 * noise)
    assert max(float((g1[n] - g0[n]).abs().max() / g0[n].abs().max())
               for n in g0) < 1e-5, "the gradient is not continuous at this depth"
    m = train_on_pairs(state, tb, samples, 0.5)
    np.testing.assert_allclose(float(m["rel_loss"]), float(jrel), rtol=1e-5)
    np.testing.assert_allclose(float(m["obj_loss"]), float(jobj), rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=1e-5)
    trained = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    assert {n.split(".")[0] for n, _ in trained} == {"depth_backbone", "relation"}
    for n, p in trained:
        _scaled(p.grad, ref[n].numpy(), 1e-4, n)
    np.testing.assert_allclose(float(m["grad_norm"]), norm, rtol=1e-4)
    for k, t in model.state_dict().items():
        if k in frozen:
            assert torch.equal(t, frozen[k]), k


def _last_stage_preactivations(model, deltas=None):
    """Forward hooks on the port's depth ResNet that record the inputs of
    the four ReLUs of its last stage (``layer3``: ``bn1``'s output, and
    ``bn2``'s output plus the shortcut, per block), NCHW; ``deltas`` maps
    a ReLU's name to a constant added to its input (through ``bn1`` or
    ``bn2``'s output, so the gradient is untouched).  Returns the record
    and the hooks' handles."""
    db = model.depth_backbone
    seen, handles = {}, []

    def hook(key, relu=None):
        def fn(mod, inp, out):
            if relu is not None and deltas and relu in deltas:
                out = out + deltas[relu]
            seen[key] = out.detach()
            return out
        return fn

    for name in ("layer3_block0", "layer3_block1"):
        blk = getattr(db, name)
        handles.append(blk.register_forward_pre_hook(
            lambda mod, inp, name=name: seen.__setitem__((name, "in"), inp[0].detach())))
        handles.append(blk.bn1.register_forward_hook(hook((name, "bn1"), f"{name}.relu1")))
        handles.append(blk.bn2.register_forward_hook(hook((name, "bn2"), f"{name}.relu2")))
        if blk.has_downsample:
            handles.append(blk.downsample_bn.register_forward_hook(hook((name, "ds"))))
    return seen, handles


def _port_relu_inputs(seen):
    out = {}
    for name in ("layer3_block0", "layer3_block1"):
        short = seen.get((name, "ds"), seen[(name, "in")])
        out[f"{name}.relu1"] = seen[(name, "bn1")].permute(0, 2, 3, 1).numpy()
        out[f"{name}.relu2"] = (seen[(name, "bn2")] + short).permute(0, 2, 3, 1).numpy()
    return out


def _jax_relu_inputs(s, jb):
    """The same four ReLU inputs from the JAX package's depth ResNet in
    train mode, read through ``capture_intermediates`` (each module's
    output; a block's input is the previous block's output), NHWC."""
    v = s["variables"]
    _, mut = s["jm"].apply(
        v, jb.depth, method=lambda m, d: m.depth_backbone(d, train=True),
        mutable=["batch_stats", "intermediates"], capture_intermediates=True)
    inter = mut["intermediates"]["depth_backbone"]
    out = {}
    for name, prev in (("layer3_block0", None), ("layer3_block1", "layer3_block0")):
        blk = inter[name]
        short = (blk["downsample_bn"]["__call__"][0] if prev is None
                 else inter[prev]["__call__"][0])
        out[f"{name}.relu1"] = np.asarray(blk["bn1"]["__call__"][0])
        out[f"{name}.relu2"] = np.asarray(blk["bn2"]["__call__"][0] + short)
    return out


def test_sgdet_train_step_gap_at_the_batch_depth_is_relu_flips(sgdet_setup):
    """Why ``test_sgdet_train_step_matches_jax`` draws its depth: on the
    batch's own depth the port's step gradients are more than 1e-4 of a
    tensor's largest |g| away from ``jax.grad``'s, and the whole gap is
    the ReLUs of the depth ResNet's 4x4 last stage whose input the two
    packages put on opposite sides of 0.  Every such input lies within
    the two f32 forwards' difference of 0; forcing exactly those inputs,
    in the port, to JAX's values (a constant added to ``bn1``'s or
    ``bn2``'s output, so no gradient path changes) brings every gradient
    within 1e-4 of JAX's.  Nothing else differs, so this is no port
    fault."""
    s = sgdet_setup
    case = _train_case(s, np.array(s["batch"].depth))
    jg = jax.jit(jax.grad(lambda p: case["jloss"](p)[0]))(s["variables"]["params"])
    ref = flax_to_state_dict({"params": jax.tree.map(np.asarray, jg)})
    model, state, samples = _port_step(s, case)
    tb = case["batch"].to("cpu")

    def gap(deltas=None):
        seen, handles = _last_stage_preactivations(model, deltas)
        try:
            forward_backward(state, tb, samples)
        finally:
            for h in handles:
                h.remove()
        worst = max(float((p.grad - ref[n]).abs().max() / ref[n].abs().max())
                    for n, p in model.named_parameters() if p.requires_grad)
        return worst, _port_relu_inputs(seen)

    before, port = gap()
    jax_in = _jax_relu_inputs(s, case["jb"])
    deltas, flipped = {}, 0
    for name, ref_in in jax_in.items():
        got = port[name]
        flip = (ref_in > 0) != (got > 0)
        noise = float(np.abs(ref_in - got).max())
        assert np.abs(ref_in[flip]).max(initial=0) <= noise, name
        flipped += int(flip.sum())
        if flip.any():
            d = np.where(flip, ref_in - got, 0).astype(np.float32)
            deltas[name] = torch.from_numpy(d).permute(0, 3, 1, 2).contiguous()
    after, _ = gap(deltas)
    print(f"batch depth: {flipped} last-stage ReLU inputs flipped; worst gradient "
          f"gap {before:.3e} of max |g|, {after:.3e} with them forced")
    assert before > 1e-4 and flipped > 0
    assert after < 1e-4
