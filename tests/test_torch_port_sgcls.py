"""Port parity for SGCls: the frozen box head, the trunk's soft class
embedding, the whole SGCls eval step and one SGCls train step, against the
JAX package on the same numpy inputs (small widths).

The JAX models run their fused encoder in the Pallas interpreter and the
separable pooler; the weights come from the JAX ``SGGModel(mode="sgcls")``'s
``init`` through ``__call__`` (which builds the box head and no RPN) and
reach the port through the weight bridge.  Tolerances: f32 at summation
order (1e-5 for the box head, 1e-4 of a tensor's largest value through the
body and the encoder), labels and rankings exact.
"""

import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import veto_tpu.ops.fused_encoder as jfe
from veto_tpu.config import SolverConfig as JSolverConfig
from veto_tpu.engine.batch import SGGBatch as JBatch
from veto_tpu.engine.train import TrainState as JTrainState
from veto_tpu.engine.train import make_eval_step as j_make_eval_step
from veto_tpu.engine.train import make_train_step as j_make_train_step
from veto_tpu.evaluation.sgg_eval import SGGEvaluator as JEvaluator
from veto_tpu.models.detector.box_head import BoxFeatureExtractor as JExtractor
from veto_tpu.models.detector.box_head import BoxPredictor as JBoxPredictor
from veto_tpu.models.relation.predictor_veto import VetoPredictor as JPredictor
from veto_tpu.models.relation.sampling import gtbox_relsample as j_relsample
from veto_tpu.models.sgg import SGGModel as JModel
from veto_tpu.solver.optim import make_optimizer as j_make_optimizer

from torch_port_det_steps import compiled, keep_grads
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.config import SolverConfig
from veto_tpu_torch.data.predicate_stats import predicate_counts
from veto_tpu_torch.data.synthetic import SyntheticSGGDataset
from veto_tpu_torch.engine.evaluate import accumulate_eval, make_eval_step, to_numpy
from veto_tpu_torch.engine.train import create_train_state, train_on_pairs
from veto_tpu_torch.evaluation.sgg_eval import SGGEvaluator
from veto_tpu_torch.models.detector.box_head import BoxFeatureExtractor, BoxPredictor
from veto_tpu_torch.models.relation.predictor_veto import (
    VetoPredictor, beta_class_weights,
)
from veto_tpu_torch.models.relation.sampling import RelSample
from veto_tpu_torch.models.sgg import SGGModel
from veto_tpu_torch.solver.optim import FROZEN_DETECTOR
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_variables

NUM_OBJ, NUM_REL = 11, 7
MAX_BOXES, PAIRS, MAX_PAIRS = 8, 16, 48
MLP = 64
SMALL = dict(num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL,
             stage_blocks=(1, 1, 1, 1), groups=4, width_per_group=4,
             fpn_channels=32, veto_dim=48, veto_layers=2, veto_heads=6,
             veto_depth_proj_dim=32, veto_visual_proj_dim=16, embed_dim=200,
             fold_bn=True, box_mlp_dim=MLP)


@pytest.fixture
def interpret():
    jfe.INTERPRET = True
    yield
    jfe.INTERPRET = False


def _assert_scaled(got, ref, tol, what):
    """|got - ref| <= tol * max|ref|."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = float(np.abs(ref).max())
    assert scale > 0, what
    np.testing.assert_allclose(got / scale, ref / scale, atol=tol, rtol=0,
                               err_msg=what)


def _perturb(tree, rng):
    """Random norm affines and statistics (init leaves 1, 0, 0, 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("bias", "mean"):
            out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


# ------------------------------------------------------------- box head
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_box_head_matches_jax(dtype):
    """fc6/fc7 in the model dtype over the NHWC flatten, ``cls_score`` and
    ``bbox_pred`` in f32 on the features cast to f32."""
    rng = np.random.RandomState(0)
    pooled = rng.randn(2, 5, 7, 7, 32).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jp = JExtractor(mlp_dim=MLP, dtype=jdt), JBoxPredictor(num_classes=NUM_OBJ,
                                                               dtype=jdt)
    xv = jx.init(jax.random.PRNGKey(0), jnp.asarray(pooled))
    feats = jx.apply(xv, jnp.asarray(pooled))
    pv = jp.init(jax.random.PRNGKey(1), feats)
    # non-zero biases, so that their cast and addition are held too
    params = {"box_extractor": _perturb(xv["params"], rng),
              "box_predictor": _perturb(pv["params"], rng)}
    feats = jx.apply({"params": params["box_extractor"]}, jnp.asarray(pooled))
    ref_logits, ref_deltas = jp.apply({"params": params["box_predictor"]}, feats)

    head = torch.nn.ModuleDict({
        "box_extractor": BoxFeatureExtractor(7 * 7 * 32, MLP, tdt),
        "box_predictor": BoxPredictor(MLP, NUM_OBJ)})
    head.load_state_dict(flax_to_state_dict({"params": params}), strict=True)
    with torch.no_grad():
        x = head["box_extractor"](torch.from_numpy(pooled))
        logits, deltas = head["box_predictor"](x)
    assert x.dtype == tdt and logits.dtype == deltas.dtype == torch.float32
    assert tuple(deltas.shape) == (2, 5, 4 * NUM_OBJ)
    # f32: summation order only; bf16: fc6/fc7 outputs rounded to bf16 on
    # both sides, after products summed in other orders
    tol = 1e-5 if dtype == "float32" else 2e-2
    _assert_scaled(x, np.asarray(feats, np.float32), tol, "features")
    _assert_scaled(logits, ref_logits, tol, "cls_score")
    _assert_scaled(deltas, ref_deltas, tol, "bbox_pred")


# ----------------------------------------------------------------- trunk
def test_sgcls_trunk_matches_jax(interpret):
    """The soft class embedding ``softmax(logits) @ obj_embed``: the
    predictor's logits and every trainable gradient, ``obj_embed``'s dense
    one included, against ``jax.grad``."""
    rng = np.random.RandomState(1)
    b, n, p, c = 2, 6, 10, 32
    x1y1 = rng.uniform(0, 40, (b, n, 2))
    boxes = np.concatenate([x1y1, x1y1 + rng.uniform(2, 30, (b, n, 2))],
                           -1).astype(np.float32)
    box_mask = np.array([[1] * 6, [1] * 4 + [0] * 2], bool)
    labels = (rng.randint(1, NUM_OBJ, (b, n)) * box_mask).astype(np.int32)
    logits = (rng.randn(b, n, NUM_OBJ) * 3).astype(np.float32)
    pair_idx = rng.randint(0, n, (b, p, 2)).astype(np.int32)
    pair_mask = np.ones((b, p), bool)
    roi = rng.randn(b, n, 8, 8, c).astype(np.float32)
    dep = rng.randn(b, n, 8, 8, 256).astype(np.float32)
    w = rng.randn(b, p, NUM_REL).astype(np.float32)
    kw = dict(embed_dim=200, dim=48, layers=2, heads=6, patch_size=2,
              depth_proj_dim=32, visual_proj_dim=16)

    jp = JPredictor(num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL, **kw,
                    mode="sgcls", dtype=jnp.float32, remat=False,
                    encoder_impl="fused")
    args = [jnp.asarray(a) for a in (boxes, box_mask, labels, logits, pair_idx,
                                     pair_mask, roi, dep)]
    init = functools.partial(jp.clone(encoder_impl="xla").init, jax.random.PRNGKey(0))
    variables = compiled(init, *args)(*args)
    stats = _perturb(variables["batch_stats"], rng)

    def jloss(params):
        out = jp.apply({"params": params, "batch_stats": stats}, *args)
        return (out.rel_logits * jnp.asarray(w)).sum(), out.rel_logits

    fn = jax.value_and_grad(jloss, has_aux=True)
    (_, ref), jg = compiled(fn, variables["params"])(variables["params"])
    ref_g = flax_to_state_dict({"params": jax.tree.map(np.asarray, jg)})

    tp = VetoPredictor(NUM_OBJ, NUM_REL, **kw, rgb_channels=c,
                       dtype=torch.float32, mode="sgcls").eval()
    tp.load_state_dict(flax_to_state_dict({"params": variables["params"],
                                           "batch_stats": stats}), strict=True)
    t = [torch.from_numpy(a) for a in (boxes, box_mask, labels, pair_idx, roi,
                                       dep, logits)]
    out = tp(*t)
    (out.rel_logits * torch.from_numpy(w)).sum().backward()
    _assert_scaled(out.rel_logits, ref, 1e-4, "rel_logits")
    np.testing.assert_array_equal(out.obj_dists.numpy(),
                                  np.eye(NUM_OBJ, dtype=np.float32)[labels])
    g = tp.trunk.obj_embed.weight.grad
    assert (g.abs().sum(1) > 0).all()  # dense: every class row moves
    for name, prm in tp.named_parameters():
        _assert_scaled(prm.grad, ref_g[name].numpy(), 1e-4, name)
    # the labels do not enter the SGCls embedding
    other = tp(*t[:2], torch.zeros_like(t[2]), *t[3:]).rel_logits
    assert torch.equal(other, out.rel_logits)


# ------------------------------------------------------- model, eval, train
@pytest.fixture(scope="module")
def sgcls_variables():
    """The small SGCls model's flax variables (init through ``__call__``,
    then perturbed norms) and a synthetic batch of 2 images."""
    ds = SyntheticSGGDataset(num_images=2, image_size=(64, 96),
                             num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL,
                             max_objects=6, min_objects=4, max_relations=6,
                             seed=11)
    batch, recs = next(ds.batches(2, MAX_BOXES))
    jbatch = JBatch(**{k: jnp.asarray(v) for k, v in batch.fields().items()})
    jm = JModel(mode="sgcls", **SMALL, dtype=jnp.float32,
                veto_encoder_impl="fused", pooler_impl="separable",
                veto_remat=False)
    init = functools.partial(jm.clone(veto_encoder_impl="xla").init, train=False)
    args = (jax.random.PRNGKey(0), jbatch.images, jbatch.depth, jbatch.boxes,
            jbatch.box_mask, jbatch.labels, jbatch.obj_logits,
            jnp.zeros((2, PAIRS, 2), jnp.int32), jnp.ones((2, PAIRS), bool))
    variables = compiled(init, *args)(*args)
    rng = np.random.RandomState(0)
    params = jax.tree.map(np.asarray, variables["params"])
    assert "rpn" not in params and {"box_extractor", "box_predictor"} <= set(params)
    # a box head whose logits are far from uniform, so that the NMS has
    # clear winners as well as ties
    params["box_predictor"]["cls_score"]["kernel"] = (
        rng.randn(*params["box_predictor"]["cls_score"]["kernel"].shape)
        * 0.5).astype(np.float32)
    variables = {"params": params, "batch_stats": _perturb(
        jax.tree.map(np.asarray, variables["batch_stats"]), rng)}
    return jm, variables, batch, jbatch, recs


def _port_model(variables):
    model = SGGModel(**SMALL, mode="sgcls", dtype=torch.float32).eval()
    load_flax_variables(model, variables)
    return model


def test_sgcls_forward_and_eval_step_match_jax(interpret, sgcls_variables):
    """The forward's ``rel_logits``, ``predict_logits`` and ``pred_labels``
    (exact), then ``make_eval_step``'s RelPrediction and both evaluators'
    ``sgcls`` aggregates."""
    jm, variables, batch, jbatch, recs = sgcls_variables
    rng = np.random.RandomState(3)
    pair_idx = rng.randint(0, MAX_BOXES, (2, PAIRS, 2)).astype(np.int32)
    pair_mask = np.ones((2, PAIRS), bool)
    args = (jbatch.images, jbatch.depth, jbatch.boxes, jbatch.box_mask, jbatch.labels,
            jbatch.obj_logits, jnp.asarray(pair_idx), jnp.asarray(pair_mask))
    fwd = functools.partial(jm.apply, train=False)
    ref = compiled(fwd, variables, *args)(variables, *args)
    model = _port_model(variables)
    tb = batch.to("cpu")
    with torch.no_grad():
        out = model(tb.images, tb.depth, tb.boxes, tb.box_mask, tb.labels,
                    tb.obj_logits, torch.from_numpy(pair_idx),
                    torch.from_numpy(pair_mask))
    np.testing.assert_array_equal(out.pred_labels.numpy(),
                                  np.asarray(ref.pred_labels))
    labels = out.pred_labels.numpy()[batch.box_mask]
    assert (labels > 0).all() and len(set(labels.tolist())) > 1
    _assert_scaled(out.predict_logits, ref.predict_logits, 1e-5, "predict_logits")
    _assert_scaled(out.rel_logits, ref.rel_logits, 1e-4, "rel_logits")
    np.testing.assert_array_equal(out.obj_dists.numpy(), np.asarray(ref.obj_dists))

    state = type("S", (), variables)
    step = j_make_eval_step(jm, max_pairs=MAX_PAIRS, mode="sgcls")
    jpred = jax.device_get(compiled(lambda v, b: step(type("S", (), v), b), variables,
                                    jbatch)(variables, jbatch))
    got = to_numpy(make_eval_step(model, max_pairs=MAX_PAIRS, mode="sgcls")(tb))
    for name in ("pair_idx", "pair_mask", "rel_labels", "obj_labels"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(jpred, name)), name)
    for name in ("rel_scores", "obj_scores"):
        np.testing.assert_allclose(getattr(got, name),
                                   np.asarray(getattr(jpred, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    jev = JEvaluator("sgcls", NUM_REL)
    tev = SGGEvaluator("sgcls", NUM_REL)
    for i, rec in enumerate(recs):
        n, pm = len(rec["boxes"]), np.asarray(jpred.pair_mask[i])
        jev.add_image(rec["boxes"], rec["labels"], rec["rel_tuples"],
                      rec["boxes"], np.asarray(jpred.obj_labels[i][:n]),
                      np.asarray(jpred.obj_scores[i][:n]),
                      np.asarray(jpred.pair_idx[i][pm]),
                      np.asarray(jpred.rel_scores[i][pm]))
    accumulate_eval(got, recs, tev)
    assert tev.aggregate() == jev.aggregate()


def _solver(cls):
    return cls(ims_per_batch=2, base_lr=1e-3, bias_lr_factor=2.0,
               weight_decay=0.3, weight_decay_bias=0.05, grad_clip_norm=5.0)


def test_sgcls_train_step_matches_jax(interpret, sgcls_variables):
    """One whole SGCls step: ``make_train_step(mode="sgcls")``'s losses
    against the port's on JAX's own samples (``rel_loss``, ``obj_loss``,
    ``loss``), the gradient norm and every trainable gradient against the
    raw gradients of the same step (its optimizer keeps them:
    ``torch_port_det_steps.keep_grads``, one compile); the frozen
    detector, box head included, unchanged by the Adam step."""
    jm, variables, batch, jbatch, _ = sgcls_variables
    params, stats = variables["params"], variables["batch_stats"]
    cw = beta_class_weights(predicate_counts("VG")[:NUM_REL])
    lr_scale, key = 0.5, jax.random.PRNGKey(5)
    tx = keep_grads(j_make_optimizer(_solver(JSolverConfig), params, FROZEN_DETECTOR))
    jstate = JTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                         batch_stats=stats, opt_state=jax.jit(tx.init)(params), rng=key)
    step = j_make_train_step(jm, tx, cw, batch_size_per_image=PAIRS,
                             positive_fraction=0.25, mode="sgcls")
    lr = jnp.asarray(lr_scale, jnp.float32)
    new, jmetrics = compiled(step, jstate, jbatch, lr)(jstate, jbatch, lr)
    jg = new.opt_state[1]

    def samples(key, rel, mask):
        keys = jax.random.split(jax.random.fold_in(key, 0), jbatch.batch_size)
        return jax.vmap(lambda k, r, m: j_relsample(
            k, r, m, batch_size=PAIRS, positive_fraction=0.25))(keys, rel, mask)

    js = jax.jit(samples)(key, jbatch.rel_matrix, jbatch.box_mask)
    norm = float(optax.global_norm(jg))
    np.testing.assert_allclose(norm, float(jmetrics["grad_norm"]), rtol=1e-6)
    clip = 1.0 if norm < 5.0 else 5.0 / norm
    ref = flax_to_state_dict({"params": jax.tree.map(lambda g: np.asarray(g * clip),
                                                     jg)})

    model = SGGModel(**SMALL, mode="sgcls", dtype=torch.float32)
    load_flax_variables(model, variables)
    frozen = {k: v.clone() for k, v in model.state_dict().items()
              if k.startswith(FROZEN_DETECTOR)}
    assert any(k.startswith("box_extractor.") for k in frozen)
    state = create_train_state(model, _solver(SolverConfig), cw, mode="sgcls")
    samples = RelSample(*(torch.from_numpy(np.array(a))
                          for a in (js.pair_idx, js.labels, js.mask)))
    m = train_on_pairs(state, batch.to("cpu"), samples, lr_scale)

    for k in ("loss", "rel_loss", "obj_loss"):
        np.testing.assert_allclose(float(m[k]), float(jmetrics[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(m["obj_loss"]) > 0
    np.testing.assert_allclose(float(m["grad_norm"]), norm, rtol=1e-4)
    trained = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    assert {n.split(".")[0] for n, _ in trained} == {"depth_backbone", "relation"}
    for n, p in trained:
        _assert_scaled(p.grad, ref[n].numpy(), 1e-4, n)
    for k, v in model.state_dict().items():
        if k in frozen:
            assert torch.equal(v, frozen[k]), k
    assert not any(p.requires_grad for n, p in model.named_parameters()
                   if n.startswith(FROZEN_DETECTOR))
    model.train()
    assert not model.box_extractor.training and not model.box_predictor.training
