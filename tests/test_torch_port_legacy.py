"""Port parity for the legacy relation head: the box geometry and the union
features, the frequency bias, the Motifs predictor through
``SGGModel.relate`` and its SGCls train step, the legacy eval through the
evaluator, and the predictor names.  The attention predictors, the MEET
heads with both relation tools, and VCTree have files of their own
(``test_torch_port_legacy_attention.py``, ``test_torch_port_legacy_meet.py``,
``test_torch_port_vctree.py``).

The case (``torch_port_legacy_case``): 2 images x 6 boxes, P2-P5 maps of 16
channels, hidden 32, pooling 64, 8 object classes; the JAX weights a seeded
fill of ``relate``'s tree, carried into the port by the weight bridge.
Tolerances: bit-equal for the geometry, the rectangles and the sort; f32
outputs within 1e-5 of each tensor's largest |value| (bf16 within 2e-2);
losses 1e-5; gradients within 1e-4 of each tensor's largest |g| of
``jax.grad``'s; BatchNorm running statistics 1e-6; R@K and mR@K equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from veto_tpu.evaluation.sgg_eval import SGGEvaluator as JEvaluator
from veto_tpu.models.relation.legacy.lstm import centerx_perm as j_centerx_perm
from veto_tpu.models.relation.postprocess import postprocess_relations as j_post
from veto_tpu.models.relation.union_features import (
    rect_masks as j_rect_masks, union_boxes as j_union_boxes,
)
from veto_tpu.ops import box_ops as jbox

from torch_port_legacy_case import (
    B, NUM_OBJ, NUM_REL, check_train_step, class_weights, compare_outputs, jax_eval,
    jax_model, jax_train, jax_variables, make_inputs, port_eval, port_model,
    relate_args, sgcls_variables, solver, t_, train_samples,
)
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.engine.evaluate import accumulate_eval, to_numpy
from veto_tpu_torch.engine.train import create_train_state
from veto_tpu_torch.evaluation.sgg_eval import SGGEvaluator
from veto_tpu_torch.models.relation.legacy import centerx_perm
from veto_tpu_torch.models.relation.postprocess import postprocess_relations
from veto_tpu_torch.models.relation.union_features import rect_masks, union_boxes
from veto_tpu_torch.models.sgg import resolve_predictor
from veto_tpu_torch.ops import box_ops


@pytest.fixture(scope="module")
def case():
    return make_inputs()


def test_box_geometry_union_boxes_and_rects_are_bit_equal(case):
    """``box_union``, ``encode_box_info``, ``resize_boxes``, ``union_boxes``
    and the rasterised rectangles (non-square images, edges on integers)
    equal the JAX package's bit for bit."""
    x = case
    boxes = x["boxes"].copy()
    boxes[0, 0] = [0.0, 0.0, 63.0, 63.0]       # the whole image
    boxes[0, 2] = [7.0, 12.0, 7.0, 12.0]        # a point on integers
    b1, b2 = boxes[:, :3], boxes[:, 3:]
    sizes, flipped = x["sizes"], x["sizes"][::-1].copy()

    def jax_side(boxes, pi, sizes, flipped):
        ub, head, tail = jax.vmap(j_union_boxes)(boxes, pi)
        rects = jax.vmap(lambda h, t, s: j_rect_masks(h, t, s, 27))(head, tail, sizes)
        return (jbox.box_union(boxes[:, :3], boxes[:, 3:]),
                jbox.encode_box_info(boxes, sizes),
                jbox.resize_boxes(boxes, sizes, flipped), ub, head, tail, rects)

    ref = jax.jit(jax_side)(*(jnp.asarray(a) for a in (boxes, x["pi"], sizes, flipped)))
    ub, head, tail = union_boxes(t_(boxes), t_(x["pi"]))
    got = (box_ops.box_union(t_(b1), t_(b2)), box_ops.encode_box_info(t_(boxes), t_(sizes)),
           box_ops.resize_boxes(t_(boxes), t_(sizes), t_(flipped)), ub, head, tail,
           rect_masks(head, tail, t_(sizes), 27))
    names = ("box_union", "encode_box_info", "resize_boxes", "union", "head", "tail",
             "rect_masks")
    for name, g, r in zip(names, got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), name)
    assert 0 < float(got[-1].mean()) < 1


def test_centerx_perm_ties_and_padding_are_bit_equal(case):
    """The centre-x sort: equal centres (duplicate boxes, and the case's
    pair sharing a centre) in index order, padding last, and its inverse."""
    boxes = case["boxes"].copy()
    mask = case["mask"].copy()
    boxes[0, 5] = boxes[0, 2]  # a duplicate box
    boxes[1, 1] = boxes[1, 0]
    perm, inv = centerx_perm(t_(boxes), t_(mask))
    jp, ji = jax.vmap(j_centerx_perm)(jnp.asarray(boxes), jnp.asarray(mask))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(ji))
    assert (mask[1][perm[1].numpy()] == [True] * 4 + [False] * 2).all()


def test_frequency_bias_matches_jax():
    """``FrequencyBias``: the hard lookup of (subject, object) class pairs
    exactly, and ``index_with_probability`` (the soft lookup over two class
    distributions) within 1e-6 of its largest |value|, on a seeded table."""
    from veto_tpu.models.relation.freq_bias import FrequencyBias as JFreq
    from veto_tpu_torch.models.relation.freq_bias import FrequencyBias

    rng = np.random.RandomState(2)
    table = rng.randn(NUM_OBJ * NUM_OBJ, NUM_REL).astype(np.float32)
    pairs = rng.randint(0, NUM_OBJ, (B, 5, 2)).astype(np.int32)
    prob = rng.dirichlet(np.ones(NUM_OBJ), (B, 5, 2)).transpose(0, 1, 3, 2)
    prob = prob.astype(np.float32)
    jf = JFreq(num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL)
    v = {"params": {"obj_baseline": jnp.asarray(table)}}
    hard, soft = jax.jit(lambda p, q: (
        jf.apply(v, p), jf.apply(v, q, method="index_with_probability")))(
        jnp.asarray(pairs), jnp.asarray(prob))
    fb = FrequencyBias(NUM_OBJ, NUM_REL)
    with torch.no_grad():
        fb.obj_baseline.copy_(t_(table))
        np.testing.assert_array_equal(fb(t_(pairs)).numpy(), np.asarray(hard))
        got = fb.index_with_probability(t_(prob)).numpy()
    np.testing.assert_allclose(got, np.asarray(soft), rtol=0,
                               atol=1e-6 * float(np.abs(np.asarray(soft)).max()))
    assert not FrequencyBias(NUM_OBJ, NUM_REL).obj_baseline.any()


@pytest.mark.parametrize("mode", ["sgcls", "sgdet"])
def test_motifs_eval_matches_jax(case, mode):
    """Motifs through ``relate`` in eval mode (its decoder's greedy labels; in
    SGDet the late NMS over ``boxes_per_cls`` and the true image sizes):
    ``obj_dists``, ``rel_dists`` 1e-5, ``obj_preds`` exact; in SGCls the
    eval's post-processing and both evaluators on the two packages' own
    logits give equal R@K and mR@K."""
    x = case
    jm = jax_model("MotifPredictor", mode)
    v = sgcls_variables("MotifPredictor")
    ref = jax_eval(jm, v, x, mode)
    model = port_model("MotifPredictor", mode, v)
    got = port_eval(model, x, mode)
    compare_outputs(got, ref, 1e-5, f"Motifs {mode}")
    if mode != "sgcls":
        return
    # the eval step's ranking and the evaluators on each package's logits
    recs = [dict(boxes=x["boxes"][i][x["mask"][i]], labels=x["labels"][i][x["mask"][i]],
                 rel_tuples=np.array([[s, o, x["rel"][i, s, o]]
                                      for s, o in zip(*np.nonzero(x["rel"][i]))]))
            for i in range(B)]
    obj = x["logits"] + 10 * np.eye(NUM_OBJ, dtype=np.float32)[x["labels"]]
    jpred = jax.tree.map(np.asarray, jax.jit(jax.vmap(j_post))(
        jnp.asarray(ref.rel_dists), jnp.asarray(obj), jnp.asarray(x["pi"]),
        jnp.asarray(x["pm"])))
    jev = JEvaluator("sgcls", NUM_REL)
    for i, rec in enumerate(recs):
        n, pm = len(rec["boxes"]), jpred.pair_mask[i]
        jev.add_image(rec["boxes"], rec["labels"], rec["rel_tuples"], rec["boxes"],
                      jpred.obj_labels[i][:n], jpred.obj_scores[i][:n],
                      jpred.pair_idx[i][pm], jpred.rel_scores[i][pm])
    ev = SGGEvaluator("sgcls", NUM_REL)
    accumulate_eval(to_numpy(postprocess_relations(got.rel_dists, t_(obj), t_(x["pi"]),
                                                   t_(x["pm"]))), recs, ev)
    jagg, agg = jev.aggregate(), ev.aggregate()
    assert agg["R"] == jagg["R"] and agg["mR"] == jagg["mR"]
    assert max(agg["R"].values()) > 0


def test_motifs_predcls_bf16_matches_jax(case):
    """Motifs in PredCls with the model in bf16 on both sides (the maps bf16,
    as the frozen body gives them): ``rel_dists`` within 2e-2 of its largest
    |value|, the labels exact."""
    x = case
    jm = jax_model("MotifPredictor", "predcls", dtype=jnp.bfloat16)
    v = jax_variables(jm, relate_args(x))
    xb = dict(x, feats=tuple(np.asarray(jnp.asarray(f, jnp.bfloat16).astype(jnp.float32))
                             for f in x["feats"]))
    ref = jax_eval(jm, v, xb, "predcls")
    got = port_eval(port_model("MotifPredictor", "predcls", v, dtype=torch.bfloat16),
                    xb, "predcls", dtype=torch.bfloat16)
    assert got.rel_dists.dtype == torch.float32
    compare_outputs(got, ref, 2e-2, "Motifs bf16")


def test_train_step_matches_jax(case):
    """One Motifs SGCls train step's forward and backward
    (``forward_backward``) on the case's sampled pairs, against
    ``jax.value_and_grad`` of the JAX step's loss in f32: the frozen box
    head gives the proposals' logits and the decoder's refined
    ``obj_dists`` train on ``obj_loss``.  The train-mode outputs
    ``OUT_TOL``, the losses 1e-5, every gradient within 1e-4 of its
    tensor's largest |g|, the BatchNorms' running statistics 1e-6, the
    union extractor's excepted (``UNION``: held to the JAX step's float64
    run in the attention predictors' and VCTree's steps)."""
    x = case
    jm = jax_model("MotifPredictor", "sgcls")
    s = train_samples(x)
    v = sgcls_variables("MotifPredictor")
    cw = class_weights()
    ref = jax_train(jm, v, x, s, "sgcls", cw, box_head=True)
    model = port_model("MotifPredictor", "sgcls", v)
    state = create_train_state(model, solver(), cw, mode="sgcls")
    got = check_train_step(model, state, x, s, ref, "Motifs SGCls")
    assert all(np.isfinite(float(v)) for v in got.values())


def test_resolve_predictor_names():
    """Every legacy predictor of the JAX model (the rest of the zoo too:
    causal analysis, KERN, AGRCNN, Naive, RelatednessTest), their ``_MEET``
    names and the JAX tool's ``TransLike_MEET`` alias resolve to their
    base; an unknown name raises ``ValueError``."""
    for name in ("MotifPredictor", "VCTreePredictor", "TransformerPredictor",
                 "TransLikePredictor", "VETOPredictor", "IMPPredictor",
                 "BGNNPredictor", "GPSNetPredictor", "MSDNPredictor",
                 "CausalAnalysisPredictor", "KERNPredictor", "AGRCNNPredictor",
                 "NaivePredictor", "RelatednessTestPredictor"):
        assert resolve_predictor(name) == name
        assert resolve_predictor(name + "_MEET") == name
    assert resolve_predictor("TransLike_MEET") == "TransLikePredictor"
    with pytest.raises(ValueError):
        resolve_predictor("NoSuchPredictor")
