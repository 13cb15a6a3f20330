"""Port parity for detector pretraining: the box encoder, the matcher, the
balanced sampler, the RPN and Fast R-CNN losses, SGD with momentum and the
multistep schedule against the JAX package on the same seeded numpy
inputs; one whole detector step against ``make_detector_train_step``; a
resume bit-equal to the run without a save; both detector tools end to
end.

The model is a tiny SGDet model (11 object classes, ResNet stage blocks
(1, 1, 1, 1), groups 1, width 16, FPN 32, box MLP 64, 64x64 images, f32,
RPN budgets 64 / 16); the JAX package's weights are the port's, converted
(``torch_port_flax_tree``), so that no jitted ``init`` is compiled, and
its step is jitted once for the file.  The samplers take the JAX
package's own ``jax.random`` draws (``draws=``).
"""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from veto_tpu.config import load_config as j_load_config
from veto_tpu.config.defaults import SolverConfig as JSolverConfig
from veto_tpu.engine.batch import SGGBatch as JBatch
from veto_tpu.models.detector import losses as jl
from veto_tpu.models.sgg import SGGModel as JModel
from veto_tpu.ops.box_ops import encode_boxes as j_encode
from veto_tpu.solver.optim import make_optimizer as j_make_optimizer
from veto_tpu.solver.optim import multistep_scale as j_multistep

from torch_port_det_steps import compiled as _compiled
from torch_port_det_steps import draws as _draws
from torch_port_det_steps import jax_draws as _jax_draws
from torch_port_det_steps import keep_grads as _keep_grads
from torch_port_det_steps import run_jax_detector_step
from torch_port_flax_tree import flax_variables
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401
from veto_tpu_torch.config import SolverConfig, load_config
from veto_tpu_torch.data.synthetic import SyntheticSGGDataset
from veto_tpu_torch.engine import pretrain as tpretrain
from veto_tpu_torch.engine.pretrain import (
    DetectorBudgets, create_detector_state,
    detector_forward_backward, detector_train_step,
)
from veto_tpu_torch.models.detector import losses as tl
from veto_tpu_torch.models.detector.rpn import Proposals, flatten_level
from veto_tpu_torch.models.detector.rpn import rpn_select_proposals
from veto_tpu_torch.models.sgg import SGGModel
from veto_tpu_torch.ops.box_ops import encode_boxes
from veto_tpu_torch.solver.optim import make_optimizer, multistep_scale
from veto_tpu_torch.utils.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_OBJ, MAX_BOXES = 11, 6
TINY = dict(num_obj_classes=NUM_OBJ, num_rel_classes=7, stage_blocks=(1, 1, 1, 1),
            groups=1, width_per_group=16, fpn_channels=32, rpn_pre_nms_top_n=64,
            rpn_post_nms_top_n=16, rpn_fpn_post_nms_top_n=16,
            detections_per_img=8, box_mlp_dim=64, veto_dim=48, veto_layers=2,
            veto_heads=6, veto_depth_proj_dim=32, veto_visual_proj_dim=16)
# the JAX step's defaults but for the batch sizes and the selection's budgets
BUDGETS = DetectorBudgets(rpn_batch_size=64, rpn_positive_fraction=0.5,
                          rpn_fg_iou=0.7, rpn_bg_iou=0.3, box_batch_size=8,
                          box_positive_fraction=0.25, box_fg_iou=0.5,
                          box_bg_iou=0.3, rpn_pre_nms_top_n=64,
                          rpn_post_nms_top_n=16, rpn_fpn_post_nms_top_n=16,
                          rpn_nms_thresh=0.7, head_rois_per_image=64)
SOLVER = dict(optimizer="sgd", ims_per_batch=2, base_lr=5e-3, bias_lr_factor=2.0,
              weight_decay=0.1, weight_decay_bias=0.05, momentum=0.9,
              grad_clip_norm=5.0)
LR_SCALE = 0.5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t)


def _scaled(got, ref, tol, what):
    got, ref = _np(got), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, atol=tol * max(float(np.abs(ref).max()), 1e-30),
                               rtol=0, err_msg=what)


# ------------------------------------------------------------- the pieces
def _boxes(rng, n, lo=0.0, hi=200.0):
    xy = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(4, 80, (n, 2))], 1).astype(np.float32)


def test_smooth_l1_and_encode_boxes_match_jax():
    """Both elementwise: ``smooth_l1`` on both sides of beta (and at it)
    bit-equal; ``encode_boxes`` at the box head's and the RPN's weights,
    its centre deltas bit-equal and its log-size deltas within two ulps:
    XLA's CPU ``log`` and PyTorch's round apart in the last bit for about
    one input in ten (numpy's differs from both), and the weight 5 can
    make that one ulp of the log two of the product."""
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(200) * 0.2, [1 / 9, -1 / 9, 0.0, 1.0]]).astype(np.float32)
    for beta in (1.0 / 9, 1.0):
        np.testing.assert_array_equal(_np(tl.smooth_l1(_t(x), beta)),
                                      np.asarray(jl.smooth_l1(jnp.asarray(x), beta)))
    ref, prop = _boxes(rng, 300), _boxes(rng, 300)
    for w in ((10.0, 10.0, 5.0, 5.0), (1.0, 1.0, 1.0, 1.0)):
        got = _np(encode_boxes(_t(ref), _t(prop), w))
        want = np.asarray(j_encode(jnp.asarray(ref), jnp.asarray(prop), w))
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
        np.testing.assert_array_max_ulp(got[:, 2:], want[:, 2:], maxulp=2)


def _match_case(rng):
    """Two images of 40 candidates and 5 GT boxes (the last padded): GT 0's
    box is candidate 3's and candidate 17's both (a tie for its best), and
    candidates near the GT give IoUs on both sides of the thresholds."""
    gt = _boxes(rng, 5)
    cand = np.concatenate([gt[rng.randint(0, 5, 30)] + rng.uniform(-12, 12, (30, 4)),
                           _boxes(rng, 10)]).astype(np.float32)
    cand[3] = cand[17] = gt[0]
    cm = rng.rand(40) > 0.1
    cm[3] = cm[17] = True
    gm = np.array([True] * 4 + [False])
    return cand, cm, gt, gm


@pytest.mark.parametrize("low_quality", [False, True])
def test_match_boxes_matches_jax(low_quality):
    """The matcher exactly, with and without the low-quality restore: both
    tied candidates of GT 0's best keep it, as JAX's ``any`` over ties
    does."""
    rng = np.random.RandomState(1)
    cases = [_match_case(rng) for _ in range(2)]
    inputs = [np.stack([c[i] for c in cases]) for i in range(4)]
    got = tl.match_boxes(*map(_t, inputs), 0.7, 0.3, low_quality)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda *a: jl.match_boxes(*a, 0.7, 0.3, low_quality)))(*inputs))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref[:, 3] == 0).all() and (ref[:, 17] == 0).all()
    assert {-2, -1}.issubset(set(got.flatten().tolist()))


@pytest.mark.parametrize("batch_size,fraction", [(16, 0.5), (64, 0.25)])
def test_balanced_sample_matches_jax(batch_size, fraction):
    """Given JAX's two uniforms, the positive and negative masks are
    JAX's exactly, with the budget binding (16) and not (64)."""
    rng = np.random.RandomState(2)
    labels = rng.choice([-1, 0, 1], (3, 120), p=[0.2, 0.6, 0.2]).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    got = tl.balanced_sample(_t(labels), *_draws(keys, 120), batch_size, fraction)
    ref = jax.jit(jax.vmap(lambda k, lab: jl.balanced_sample(
        k, lab, batch_size, fraction)))(keys, labels)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(got[0].sum()) > 0 and int(got[1].sum()) > 0


def test_rpn_losses_match_jax():
    """The RPN's objectness and box losses of two images at 1e-6, given
    JAX's draws."""
    rng = np.random.RandomState(4)
    b, a = 2, 300
    anchors = _boxes(rng, a, -20, 240)
    vis = rng.rand(a) > 0.15
    gt = np.stack([_boxes(rng, 5) for _ in range(b)])
    gm = np.array([[True] * 5, [True] * 3 + [False] * 2])
    obj = rng.randn(b, a).astype(np.float32)
    reg = (rng.randn(b, a, 4) * 0.3).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), b)
    got = tl.rpn_losses(_t(obj), _t(reg), _t(anchors), _t(vis), _t(gt), _t(gm),
                        *_draws(keys, a), batch_size=64)
    ref = jax.jit(jax.vmap(lambda k, o, r, g, m: jl.rpn_losses(
        k, o, r, anchors, vis, g, m, batch_size=64)))(keys, obj, reg, gt, gm)
    np.testing.assert_allclose(got.objectness.numpy(), np.asarray(ref.objectness),
                               rtol=1e-6)
    np.testing.assert_allclose(got.box.numpy(), np.asarray(ref.box), rtol=1e-6)
    assert (np.asarray(ref.box) > 0).all()


def test_fastrcnn_sample_and_losses_match_jax():
    """The box head's sample (indices, mask, labels exactly; targets at
    1e-6) and its two losses at 1e-6, given JAX's draws."""
    rng = np.random.RandomState(6)
    b, p, c, s = 2, 60, NUM_OBJ, 16
    gt = np.stack([_boxes(rng, 5) for _ in range(b)])
    gl = rng.randint(1, c, (b, 5)).astype(np.int32)
    gm = np.array([[True] * 5, [True] * 4 + [False]])
    props = np.stack([np.concatenate([gt[i][rng.randint(0, 5, 40)]
                                      + rng.uniform(-10, 10, (40, 4)), _boxes(rng, 20)])
                      for i in range(b)]).astype(np.float32)
    pm = rng.rand(b, p) > 0.1
    logits = rng.randn(b, s, c).astype(np.float32)
    deltas = (rng.randn(b, s, 4 * c) * 0.5).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), b)
    got = tl.fastrcnn_sample(_t(props), _t(pm), _t(gt), _t(gl), _t(gm),
                             *_draws(keys, p), batch_size=s)
    loss = tl.fastrcnn_losses(_t(logits), _t(deltas), got)

    def jax_side(k, pb, m, g, lab, gmask, lg, dl):
        smp = jl.fastrcnn_sample(k, pb, m, g, lab, gmask, batch_size=s)
        return smp, jl.fastrcnn_losses(lg, dl, smp)

    ref, rl = jax.jit(jax.vmap(jax_side))(keys, props, pm, gt, gl, gm, logits, deltas)
    for name in ("idx", "mask", "labels"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_allclose(got.targets.numpy(), np.asarray(ref.targets),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(loss.classifier.numpy(), np.asarray(rl.classifier),
                               rtol=1e-6)
    np.testing.assert_allclose(loss.box_reg.numpy(), np.asarray(rl.box_reg), rtol=1e-6)
    assert (np.asarray(ref.labels) > 0).sum(1).min() > 0
    assert (np.asarray(rl.box_reg) > 0).all()


# ----------------------------------------------------------- the solver
def _optax_state(solver, tree):
    """The JAX package's optimizer over ``tree`` (nothing frozen) and its
    initial state."""
    tx = j_make_optimizer(JSolverConfig(**solver), tree, frozen_prefixes=())
    return tx, jax.jit(tx.init)(tree)  # one compile, not one an op


def _tree(named):
    """A nested dict of numpy arrays from dotted names: the optimizer's
    labels depend on the last key only ('bias' or not), as on the flax
    tree."""
    out = {}
    for name, arr in named:
        *mod, leaf = name.split(".")
        d = out
        for k in mod:
            d = d.setdefault(k, {})
        d[leaf] = np.array(arr, np.float32)  # a copy: torch updates in place
    return out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_sgd_matches_optax_over_three_steps():
    """Clip, SGD with momentum and decay in both groups, over three steps
    whose ``lr_scale`` goes 0.1 → 1 → 0.5 (the first clipped), against the
    optax chain of ``make_optimizer``: 1e-6 relative."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Linear(5, 3))
    opt = make_optimizer(SolverConfig(**SOLVER), model, frozen_prefixes=())
    assert {g["label"] for g in opt.inner.param_groups} == {"weight", "bias"}
    params = _tree((n, p.detach().numpy()) for n, p in model.named_parameters())
    tx, st = _optax_state(SOLVER, params)
    update = jax.jit(tx.update)
    rng = np.random.RandomState(8)
    for k, scale in enumerate((0.1, 1.0, 0.5)):
        grads = {n: (rng.randn(*p.shape) * (8.0 if k == 0 else 0.3)).astype(np.float32)
                 for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        norm = opt.step(scale)
        st.hyperparams["lr_scale"] = jnp.asarray(scale, jnp.float32)
        upd, st = update(_tree(grads.items()), st, params)
        params = optax.apply_updates(params, upd)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(_tree(grads.items()))),
                                   rtol=1e-6)
        for n, p in model.named_parameters():
            ref = dict(_flat(params))[n]
            np.testing.assert_allclose(p.detach().numpy(), ref, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max(), err_msg=n)


def test_multistep_scale_matches_jax():
    """The warmup and milestone boundaries: equal."""
    cfg = dict(warmup_iters=10, warmup_factor=0.1, steps=(20, 30), gamma=0.1)
    got, ref = multistep_scale(SolverConfig(**cfg)), j_multistep(JSolverConfig(**cfg))
    for step in (0, 1, 9, 10, 11, 19, 20, 21, 29, 30, 31, 100):
        assert got(step) == ref(step), step
    assert got(0) == 0.1 and got(25) == pytest.approx(0.1) and got(30) == pytest.approx(0.01)


# ------------------------------------------------------- the whole step
def _batch():
    ds = SyntheticSGGDataset(num_images=2, image_size=(64, 64), num_obj_classes=NUM_OBJ,
                             num_rel_classes=7, max_objects=MAX_BOXES - 2,
                             min_objects=3, max_relations=4, seed=3)
    return next(ds.batches(2, MAX_BOXES))[0]


def _port_model(fold_bn=True, seed=0):
    from veto_tpu_torch.models.sgg import init_weights

    model = SGGModel(mode="sgdet", **TINY, fold_bn=fold_bn, dtype=torch.float32,
                     veto_encoder_impl="xla", train_detector=True)
    init_weights(model, seed)
    return model


@pytest.fixture(scope="module")
def step_setup():
    """The port model (folded BN) with seeded weights, the same weights as a
    flax tree, a synthetic batch of 2 images, and one jitted
    ``make_detector_train_step`` on them (SGD, nothing frozen, the budgets
    above, ``lr_scale`` 0.5): its losses, raw gradients, updated
    parameters, the proposals of its selection (recorded by a debug
    callback in the JAX package's ``rpn_select_proposals``) and its draws."""
    batch = _batch()
    jb = JBatch(**{k: jnp.asarray(v) for k, v in batch.fields().items()})
    model = _port_model()
    jm = JModel(mode="sgdet", **TINY, fold_bn=True, dtype=jnp.float32,
                veto_encoder_impl="xla", pooler_impl="separable", veto_remat=False)
    variables = flax_variables(
        jm, model, jax.random.PRNGKey(0), jb.images[:1], jb.depth[:1], jb.boxes[:1],
        jb.box_mask[:1], jb.labels[:1], jb.obj_logits[:1],
        jnp.zeros((1, 4, 2), jnp.int32), jnp.ones((1, 4), bool))
    tx = _keep_grads(j_make_optimizer(JSolverConfig(**SOLVER), variables["params"],
                                      frozen_prefixes=()))
    rng = jax.random.PRNGKey(11)
    metrics, grads, new_params, proposals = run_jax_detector_step(
        jm, variables, tx, jb, rng, LR_SCALE, rpn_batch_size=BUDGETS.rpn_batch_size,
        box_batch_size=BUDGETS.box_batch_size,
        rpn_pre_nms_top_n=BUDGETS.rpn_pre_nms_top_n,
        rpn_post_nms_top_n=BUDGETS.rpn_post_nms_top_n,
        rpn_fpn_post_nms_top_n=BUDGETS.rpn_fpn_post_nms_top_n)
    assert proposals[0].shape[0] == 2
    return dict(batch=batch, model=model, jm=jm, variables=variables, rng=rng,
                metrics=metrics, grads=grads, new_params=new_params,
                proposals=Proposals(*proposals))


def _flax_named(tree):
    """A flax tree's leaves by the port's parameter names."""
    from veto_tpu_torch.utils.jax_weights import flax_to_state_dict

    return flax_to_state_dict({"params": tree})


def _port_proposals(model, batch):
    """The port's own proposal selection on its maps, with the step's
    budgets, and the number of anchors."""
    with torch.no_grad():
        _, obj, reg = model.detector_forward(batch.images)
        flat = [flatten_level(o.float(), r.float()) for o, r in zip(obj, reg)]
        anchors = model.anchors([o.shape[1:3] for o in obj], "cpu")
        return rpn_select_proposals(
            [f[0] for f in flat], [f[1] for f in flat], anchors, batch.sizes.float(),
            BUDGETS.rpn_pre_nms_top_n, BUDGETS.rpn_post_nms_top_n,
            BUDGETS.rpn_nms_thresh, BUDGETS.rpn_fpn_post_nms_top_n
        ), sum(a.shape[0] for a in anchors)


def test_detector_step_matches_jax(step_setup, monkeypatch):
    """One whole step against ``make_detector_train_step`` (f32, folded BN,
    SGD with momentum and decay in both groups, nothing frozen) on JAX's
    own draws: each loss and the gradient norm at 1e-5, every parameter's
    gradient within 1e-4 of its tensor's largest |g| (the depth ResNet's
    and the relation head's are zero in both, and so is any level's FPN
    output that no sampled anchor or roi reads), every updated parameter
    at 1e-5 of its tensor's largest |value|, and the parameters that take
    no gradient decayed as JAX decays them (1e-6).

    The proposals are compared first.  Where the two selections differ (a
    near-tie in a top-k), the test prints the first differing index and the
    objectness gap there, and the port's selection is replaced by one that
    returns JAX's proposals, so that both box stages see the same rois."""
    s = step_setup
    batch, model = s["batch"].to("cpu"), s["model"]
    jp = s["proposals"]
    got, num_anchors = _port_proposals(model, batch)
    same = torch.equal(got.mask, jp.mask) and torch.allclose(got.boxes, jp.boxes,
                                                             rtol=0, atol=1e-5)
    if not same:
        diff = (got.boxes - jp.boxes).abs().amax(-1) > 1e-5
        i, j = [int(v[0]) for v in torch.nonzero(diff | (got.mask != jp.mask), as_tuple=True)]
        print(f"proposals differ first at image {i}, slot {j}: objectness "
              f"{float(got.objectness[i, j]):.9g} (port) vs "
              f"{float(jp.objectness[i, j]):.9g} (JAX), gap "
              f"{float(got.objectness[i, j] - jp.objectness[i, j]):.3g}; the port's "
              "box stage takes JAX's proposals")
        monkeypatch.setattr(tpretrain, "rpn_select_proposals", lambda *a: jp)
    assert int(jp.mask.sum()) > 8
    state = create_detector_state(model, SolverConfig(**SOLVER))
    draws = _jax_draws(s["rng"], 2, num_anchors, jp.mask.shape[1])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    m = detector_forward_backward(state, batch, BUDGETS, draws)
    norm = state.optimizer.step(LR_SCALE)  # zero gradients where none came
    grads = {n: p.grad for n, p in model.named_parameters()}
    jm = s["metrics"]
    for k in ("loss", "loss_objectness", "loss_rpn_box_reg", "loss_classifier",
              "loss_box_reg"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        assert float(jm[k]) > 0, k
    np.testing.assert_allclose(float(norm), float(jm["grad_norm"]), rtol=1e-5)
    ref_g, ref_p = _flax_named(s["grads"]), _flax_named(s["new_params"])
    assert ref_g.keys() == grads.keys()
    idle = [n for n in grads if float(ref_g[n].abs().max()) == 0]
    assert {n for n in grads if n.startswith(("depth_backbone", "relation"))} <= set(idle)
    assert not [n for n in idle if n.startswith(("backbone.body", "rpn", "box_"))]
    for n, g in grads.items():
        _scaled(g, ref_g[n], 1e-4, f"grad {n}")
        _scaled(model.state_dict()[n], ref_p[n], 1e-5, f"updated {n}")
    for n in idle:  # decayed only: the same f32 arithmetic, to an ulp or two
        p = model.state_dict()[n]
        assert not torch.equal(p, before[n]) or not before[n].any(), n
        np.testing.assert_allclose(p.numpy(), ref_p[n].numpy(), rtol=1e-6,
                                   atol=1e-6 * float(ref_p[n].abs().max()), err_msg=n)


def test_unfolded_frozen_bn_trains_in_its_groups():
    """With ``fold_bn`` false the body's ``FrozenBatchNorm`` scales and
    biases train (they are flax params): every one takes a gradient, the
    scales go to the weight group and the biases to the bias group, as
    ``_label_params`` puts them, and their SGD update equals the optax
    chain of ``make_optimizer`` on the same (clipped) gradients (1e-6)."""
    model = _port_model(fold_bn=False, seed=1)
    state = create_detector_state(model, SolverConfig(**SOLVER), seed=2)
    named = dict(model.named_parameters())
    bn = [n for n in named if n.startswith("backbone.body.") and "bn" in n.rsplit(".", 2)[1]]
    assert len(bn) == 2 * (1 + 4 * 4)  # the stem's and 4 a block, weight and bias
    before = _tree((n, named[n].detach().numpy()) for n in bn)
    detector_forward_backward(state, _batch().to("cpu"), BUDGETS)
    state.optimizer.step(LR_SCALE)  # clips the gradients in place
    assert all(float(named[n].grad.abs().max()) > 0 for n in bn)
    labels = {g["label"]: {id(p) for p in g["params"]}
              for g in state.optimizer.inner.param_groups}
    for n in bn:
        assert id(named[n]) in labels["bias" if n.endswith(".bias") else "weight"], n
    tx, st = _optax_state({**SOLVER, "grad_clip_norm": 1e30}, before)
    st.hyperparams["lr_scale"] = jnp.asarray(LR_SCALE, jnp.float32)
    upd, _ = jax.jit(tx.update)(_tree((n, named[n].grad.numpy()) for n in bn), st, before)
    ref = dict(_flat(optax.apply_updates(before, upd)))
    for n in bn:
        np.testing.assert_allclose(named[n].detach().numpy(), ref[n], rtol=1e-6,
                                   atol=1e-6 * np.abs(ref[n]).max(), err_msg=n)


def test_optimizer_checkpoints_refuse_another_optimizer(tmp_path):
    """A checkpoint holds whichever optimizer trained: SGD's momentum
    buffers restore bit-equal, and an Adam checkpoint does not load into
    SGD's state (``ValueError``), nor SGD's into Adam's."""
    from veto_tpu_torch.engine.train import TrainState

    def state(kind):
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
        st = TrainState(m, make_optimizer(SolverConfig(**{**SOLVER, "optimizer": kind}),
                                          m, frozen_prefixes=()))
        for p in m.parameters():
            p.grad = torch.ones_like(p)
        st.optimizer.step(1.0)
        st.step = 1
        return st

    for kind, other in (("sgd", "adam"), ("adam", "sgd")):
        ckpt = CheckpointManager(str(tmp_path / kind))
        ckpt.save(1, state(kind))
        fresh = state(kind)
        for p in fresh.model.parameters():
            p.data.zero_()
        ckpt.restore(fresh)
        saved = state(kind)
        for a, b in zip(fresh.model.parameters(), saved.model.parameters()):
            assert torch.equal(a, b)
        sa, sb = fresh.optimizer.inner.state_dict(), saved.optimizer.inner.state_dict()
        for i in sb["state"]:
            for k, v in sb["state"][i].items():
                assert torch.equal(sa["state"][i][k], v), (kind, i, k)
        with pytest.raises(ValueError, match="another optimizer"):
            ckpt.restore(state(other))


def test_resume_is_bit_equal_to_the_run_without_a_save(tmp_path):
    """k steps, a checkpoint, a fresh model and state restored from it and
    k more steps give the same bits as 2k steps in one run (f32, one CPU
    thread): the parameters, SGD's momentum buffers, the step and the
    samplers' generator, whose draws the second half takes."""
    ds = SyntheticSGGDataset(num_images=8, image_size=(64, 64), num_obj_classes=NUM_OBJ,
                             num_rel_classes=7, max_objects=MAX_BOXES - 2,
                             min_objects=3, max_relations=4, seed=5)
    batches = [b.to("cpu") for b, _ in ds.batches(2, MAX_BOXES)]
    solver = SolverConfig(**SOLVER, warmup_iters=3, steps=(2,))
    scale = multistep_scale(solver)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        def run(state, first, last):
            for it in range(first, last):
                detector_train_step(state, batches[it], scale(it), BUDGETS)
            return state

        whole = run(create_detector_state(_port_model(), solver), 0, 4)
        ckpt = CheckpointManager(str(tmp_path / "ckpt"))
        ckpt.save(2, run(create_detector_state(_port_model(), solver), 0, 2))
        resumed = create_detector_state(_port_model(seed=9), solver, seed=7)
        ckpt.restore(resumed)
        assert resumed.step == 2
        run(resumed, 2, 4)
    finally:
        torch.set_num_threads(threads)
    assert resumed.step == whole.step == 4
    sa, sb = resumed.model.state_dict(), whole.model.state_dict()
    for k in sb:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = resumed.optimizer.inner.state_dict(), whole.optimizer.inner.state_dict()
    assert len(ob["state"]) == len(list(whole.model.parameters()))
    for i in ob["state"]:
        assert torch.equal(oa["state"][i]["momentum_buffer"],
                           ob["state"][i]["momentum_buffer"]), i
    assert torch.equal(resumed.generator.get_state(), whole.generator.get_state())


# ------------------------------------------------------------ the tools
TOOL_OPTS = ["model.stage_blocks=(1,1,1,1)", "model.resnet_groups=1",
             "model.resnet_width_per_group=16", "model.fpn_channels=32",
             "model.box_mlp_head_dim=32", "model.num_obj_classes=11",
             "model.rpn_pre_nms_top_n_train=64", "model.rpn_post_nms_top_n_train=16",
             "model.rpn_pre_nms_top_n_test=64", "model.rpn_post_nms_top_n_test=16",
             "model.box_batch_size_per_image=16", "model.rpn_batch_size_per_image=32",
             "model.box_detections_per_img=8", "model.box_score_thresh=0.0",
             "data.min_size_train=64", "data.max_size_train=64",
             "data.min_size_test=64", "data.max_size_test=64", "data.max_boxes=6",
             "veto.t_input_dim=48", "veto.enc_layers=1", "solver.ims_per_batch=2",
             "test.ims_per_batch=8", "solver.max_iter=2", "solver.checkpoint_period=1",
             "solver.val_period=2", "solver.warmup_iters=1", "dtype=float32"]


def test_both_tools_end_to_end(tmp_path):
    """``detector_pretrain_net`` on the CPU (SGD and the multistep schedule
    by default) for 2 steps with a checkpoint after each and a validation
    at 2, then ``detector_pretest_net`` restoring step 2 (by
    ``--checkpoint``, step 1; with the TTA from the command line) and
    writing ``bbox_eval_val.json``; a second pretraining run resumes; without
    ``--device cpu`` both raise on a machine without a GPU."""
    import json

    from veto_tpu_torch.tools import detector_pretest_net, detector_pretrain_net

    out = tmp_path / "out"
    config = ["--config", os.path.join(REPO, "configs", "veto_vg_sgdet.yaml")]
    opts = [*TOOL_OPTS, f"output_dir={out}"]

    def cpu(tool, *extra):
        return tool.main(config + ["--device", "cpu"] + opts + list(extra))

    history = cpu(detector_pretrain_net)
    cfg = json.load(open(out / "config.json"))
    assert cfg["solver"]["optimizer"] == "sgd"
    assert cfg["solver"]["schedule"] == "WarmupMultiStepLR"
    assert len(history) == 2 and "val_mAP" in history[1]
    assert all(np.isfinite(r[k]) for r in history for k in ("loss", "grad_norm"))
    assert CheckpointManager(str(out / "ckpt")).steps() == [1, 2]
    agg = cpu(detector_pretest_net)
    assert json.load(open(out / "bbox_eval_val.json")) == agg
    assert agg["mAP"] == history[1]["val_mAP"]
    cpu(detector_pretest_net, "--checkpoint", "1")
    # the TTA from the command line: its scales are floats (the JAX
    # package's loader leaves them strings, and its TTA then fails)
    tta = ["test.bbox_aug_enabled=true", "test.bbox_aug_scales=(0.75,)"]
    assert load_config(None, tta).test.bbox_aug_scales == (0.75,)
    assert j_load_config(None, tta).test.bbox_aug_scales == ("0.75",)
    assert set(cpu(detector_pretest_net, *tta)) == {"mAP", "AP50", "AP75"}
    # a second run resumes from step 2 and takes one step more
    more = cpu(detector_pretrain_net, "solver.max_iter=3")
    assert len(more) == 1 and CheckpointManager(str(out / "ckpt")).steps() == [1, 2, 3]
    if not torch.cuda.is_available():
        for tool in (detector_pretrain_net, detector_pretest_net):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tool.main(config + opts)


# ---------------------------------------------------- test-time augmentation
def test_hflip_round_trip_matches_jax():
    """``hflip_boxes`` (``W - 1 - x``) bit-equal to JAX's, and
    ``hflip_images`` on images as wide as the batch too; each its own
    inverse, ``hflip_images`` also on images narrower than the batch."""
    from veto_tpu.engine.bbox_aug import hflip_boxes as j_hflip_boxes
    from veto_tpu.engine.bbox_aug import hflip_images as j_hflip_images
    from veto_tpu_torch.engine.bbox_aug import hflip_boxes, hflip_images

    rng = np.random.RandomState(9)
    boxes = _boxes(rng, 2 * 5 * 3).reshape(2, 5, 3, 4)
    widths = np.array([220.0, 150.0], np.float32)
    got = hflip_boxes(_t(boxes), _t(widths)[:, None, None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_hflip_boxes(
        jnp.asarray(boxes), jnp.asarray(widths)[:, None, None])))
    # back to the boxes, up to the rounding of W - 1 - x (an ulp of W)
    np.testing.assert_allclose(hflip_boxes(got, _t(widths)[:, None, None]).numpy(),
                               boxes, atol=3e-5, rtol=0)
    img = rng.rand(2, 4, 6, 3).astype(np.float32)
    full = torch.tensor([6.0, 6.0])
    np.testing.assert_array_equal(hflip_images(_t(img), full).numpy(),
                                  np.asarray(j_hflip_images(jnp.asarray(img))))
    for w in (full, torch.tensor([6.0, 4.0])):
        assert torch.equal(hflip_images(hflip_images(_t(img), w), w), _t(img))


def test_tta_flips_each_image_within_its_own_width():
    """A batch of two widths, 64 and 40, padded on the right to 64 as the
    loader pads.  The JAX package flips the padded batch whole: the
    narrower image's content lands at columns [24, 64), and an object's box
    mapped back by ``hflip_boxes`` with the image's width is off by
    W_pad - w = 24 pixels (its flip candidates, clipped to [0, 40), are
    detected mostly on padding).  The port mirrors each image within its
    width and leaves the padding in place: the object maps back onto
    itself, and the flip candidates are those of the image flipped before
    padding and detected alone (1e-5)."""
    from veto_tpu.engine.bbox_aug import hflip_images as j_hflip_images
    from veto_tpu_torch.engine.bbox_aug import hflip_boxes, hflip_images

    b = _batch().to("cpu")
    w, mark = 40, 7.5  # the narrower image's width; an object's value
    images = b.images.clone()
    images[1, :, w:] = 0.0
    images[1, 10:31, 5:13] = mark  # the object: columns 5-12, rows 10-30
    widths = torch.tensor([64.0, float(w)])
    sizes = torch.stack([widths, b.sizes[:, 1].float()], 1)
    obj = torch.tensor([5.0, 10.0, 12.0, 30.0])

    def object_box(img):
        """The object's box found in a flipped image, mapped back."""
        cols = torch.nonzero((img[10:31] == mark).all(-1).all(0))[:, 0].float()
        return hflip_boxes(torch.stack([cols.min(), obj[1], cols.max(), obj[3]]),
                           torch.tensor(float(w)))

    j_flipped = torch.from_numpy(np.array(j_hflip_images(jnp.asarray(images.numpy()))))
    assert torch.equal(object_box(j_flipped[1]), obj - torch.tensor([24.0, 0, 24.0, 0]))
    flipped = hflip_images(images, widths)
    assert torch.equal(object_box(flipped[1]), obj)
    alone = torch.zeros_like(images[1:])
    alone[0, :, :w] = torch.flip(images[1, :, :w], dims=[1])
    assert torch.equal(flipped[1:], alone) and torch.equal(flipped[0], j_flipped[0])
    model = _port_model().eval()
    _, prob, bpc, mask = model.detect_candidates(flipped, sizes)
    _, ref_prob, ref_bpc, ref_mask = model.detect_candidates(alone, sizes[1:])
    assert torch.equal(mask[1:], ref_mask) and int(ref_mask.sum()) > 0
    np.testing.assert_allclose(prob[1:].numpy(), ref_prob.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(bpc[1:].numpy(), ref_bpc.numpy(), atol=1e-5, rtol=0)
    assert float(ref_bpc[..., 2].max()) <= w - 1


@pytest.mark.parametrize("scale", [0.5, 1.5])
def test_resize_matches_jax_image_resize(scale):
    """The TTA's rescale of the padded batch against ``jax.image.resize``
    (``"linear"``, which antialiases when it shrinks) at 1e-5."""
    from veto_tpu_torch.engine.bbox_aug import resize_images

    img = np.random.RandomState(10).randn(2, 40, 56, 3).astype(np.float32)
    size = (int(round(40 * scale)), int(round(56 * scale)))
    ref = jax.image.resize(jnp.asarray(img), (2, *size, 3), "linear")
    np.testing.assert_allclose(resize_images(_t(img), size).numpy(), np.asarray(ref),
                               atol=1e-5, rtol=0)


def test_identity_only_tta_equals_detect():
    """No flip and no scale: the TTA's detections are ``detect``'s, bit for
    bit, and its logits ``detect``'s log-softmax (1e-6)."""
    from veto_tpu_torch.engine.bbox_aug import detect_tta

    model = _port_model().eval()
    b = _batch().to("cpu")
    want = model.detect(b.images, b.sizes)
    _, dets, logits = detect_tta(model, b.images, b.sizes, hflip=False, scales=())
    for f in dets._fields:
        assert torch.equal(getattr(dets, f), getattr(want.detections, f)), f
    # the TTA's logits are log-probabilities: detect's up to a row constant
    np.testing.assert_allclose(logits.numpy(), torch.log_softmax(
        want.predict_logits, -1).numpy(), atol=1e-6, rtol=0)
    assert int(dets.mask.sum()) > 0


def test_tta_matches_jax_detect_tta(step_setup):
    """Flip plus scales 0.5 and 1.5 against ``detect_tta`` (the step's
    weights before its update): boxes at 1e-4, labels and the mask
    exactly, scores at 1e-5, logits at 1e-5."""
    from veto_tpu.engine.bbox_aug import detect_tta as j_detect_tta
    from veto_tpu_torch.engine.bbox_aug import detect_tta

    s = step_setup
    model = _port_model().eval()  # the fixture's weights, before the step
    b = _batch().to("cpu")
    sizes = jnp.asarray(b.sizes.numpy(), jnp.float32)
    args = (s["variables"], jnp.asarray(b.images.numpy()), sizes)
    _, ref, ref_logits = _compiled(lambda v, im, sz: j_detect_tta(
        s["jm"], v, im, sz, hflip=True, scales=(0.5, 1.5)), *args)(*args)
    _, got, logits = detect_tta(model, b.images, b.sizes, hflip=True, scales=(0.5, 1.5))
    for name in ("labels", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    _scaled(got.boxes, ref.boxes, 1e-4, "boxes")
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-5)
    assert int(got.mask.sum()) > 0


def test_box_losses_take_no_nan_from_the_targets_of_negatives():
    """A sampled negative proposal of zero width (x2 = x1 - 1) has
    infinite regression targets.  The JAX package masks the smooth-L1
    after taking it, so ``jax.grad`` puts NaN in that slot's gradient;
    the port masks the residual first: the same losses, the same gradient
    everywhere JAX's is finite, and 0 in that slot (the reference gathers
    the positives and never sees it).  The RPN's loss takes the same
    masking."""
    c = 3
    proposal = np.array([[10.0, 10.0, 9.0, 50.0]], np.float32)  # width 0
    targets = np.array(j_encode(jnp.asarray([[0.0, 0.0, 20.0, 20.0]]), jnp.asarray(proposal)))
    assert np.isinf(targets).any()
    smp = dict(idx=np.arange(4), mask=np.array([True, True, False, False]),
               labels=np.array([1, 0, 0, 0]),
               targets=np.concatenate([np.full((1, 4), 0.1), targets, np.zeros((2, 4))]
                                      ).astype(np.float32))
    rng = np.random.RandomState(12)
    logits = rng.randn(4, c).astype(np.float32)
    deltas = rng.randn(4, 4 * c).astype(np.float32)
    ref_loss, ref_g = jax.jit(jax.value_and_grad(lambda d: jl.fastrcnn_losses(
        jnp.asarray(logits), d, jl.BoxSample(**smp)).box_reg))(jnp.asarray(deltas))
    ref_g = np.asarray(ref_g)
    assert np.isnan(ref_g[1]).any()
    d = _t(deltas)[None].requires_grad_(True)
    loss = tl.fastrcnn_losses(_t(logits)[None], d, tl.BoxSample(
        idx=_t(smp["idx"])[None], mask=_t(smp["mask"])[None],
        labels=_t(smp["labels"])[None].long(), targets=_t(smp["targets"])[None]))
    loss.box_reg.sum().backward()
    np.testing.assert_allclose(loss.box_reg.item(), float(ref_loss), rtol=1e-6)
    g = d.grad[0].numpy()
    ok = np.isfinite(ref_g)
    np.testing.assert_allclose(g[ok], ref_g[ok], rtol=1e-6)
    assert np.isfinite(g).all() and (g[~ok] == 0).all()
    # the RPN: a negative anchor whose (inf) target is masked out
    reg = torch.zeros(1, 2, 4, requires_grad=True)
    anchors = _t(np.array([[0, 0, 15, 15], [40, 40, 55, 55]], np.float32))
    gt = _t(np.array([[[0, 0, 15, 15], [30, 30, 29, 60]]], np.float32))  # the 2nd 0 wide
    out = tl.rpn_losses(torch.zeros(1, 2), reg, anchors, torch.ones(2, dtype=torch.bool),
                        gt, torch.ones(1, 2, dtype=torch.bool), torch.zeros(1, 2),
                        torch.zeros(1, 2), batch_size=2)
    (out.objectness + out.box).sum().backward()
    assert torch.isfinite(reg.grad).all()
