"""Port parity for PredCls training: BatchNorm in train mode, the Rwt loss,
the optimizer and its LR controller, the pair sampler, the depth path's
gradient through ``SGGModel`` and one whole train step, against the JAX
package on the same numpy inputs (f32, small shapes).

The JAX model runs its fused encoder in the Pallas interpreter (forward
with the stash, split backward) and the separable pooler; ``jax.grad``
differentiates it.  The port runs the plain versions of its kernels, on
the CPU, through the same ``torch.autograd.Function``s as on the card.
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
from veto_tpu.data.predicate_stats import predicate_counts as j_predicate_counts
from veto_tpu.engine.batch import SGGBatch as JBatch
from veto_tpu.engine.train import TrainState as JTrainState
from veto_tpu.engine.train import make_train_step as j_make_train_step
from veto_tpu.models.backbone.depth_resnet import DepthResNet18 as JDepth
from veto_tpu.models.relation.predictor_veto import MaskedBatchNorm as JMaskedBN
from veto_tpu.models.relation.predictor_veto import beta_class_weights as j_beta
from veto_tpu.models.relation.predictor_veto import weighted_ce_loss as j_wce
from veto_tpu.models.relation.sampling import gtbox_relsample as j_relsample
from veto_tpu.models.sgg import SGGModel as JModel
from veto_tpu.solver.optim import LRController as JLRController
from veto_tpu.solver.optim import _label_params
from veto_tpu.solver.optim import make_optimizer as j_make_optimizer

from veto_tpu_torch.config import SolverConfig
from veto_tpu_torch.data.predicate_stats import predicate_counts
from veto_tpu_torch.data.synthetic import SyntheticSGGDataset
from veto_tpu_torch.engine.train import (
    create_train_state, forward_backward, sample_pairs, train_on_pairs,
)
from veto_tpu_torch.models.backbone.depth_resnet import DepthResNet18
from veto_tpu_torch.models.relation.predictor_veto import (
    MaskedBatchNorm, beta_class_weights, weighted_ce_loss,
)
from veto_tpu_torch.models.relation.sampling import RelSample, gtbox_relsample
from veto_tpu_torch.models.sgg import SGGModel
from veto_tpu_torch.ops import roi_align_windowed as trw
from veto_tpu_torch.solver.optim import (
    FROZEN_DETECTOR, LRController, make_optimizer, param_label,
)
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_variables

NUM_OBJ, NUM_REL = 11, 7
MAX_BOXES, PAIRS = 8, 16
SMALL = dict(num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL,
             stage_blocks=(1, 1, 1, 1), groups=4, width_per_group=4,
             fpn_channels=32, veto_dim=96, veto_layers=2, veto_heads=6,
             veto_depth_proj_dim=32, veto_visual_proj_dim=16, embed_dim=200,
             fold_bn=True)


@pytest.fixture
def interpret():
    jfe.INTERPRET = True
    yield
    jfe.INTERPRET = False


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


def _assert_scaled(got, ref, tol, what):
    """|got - ref| <= tol * max|ref|."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = float(np.abs(ref).max())
    assert scale > 0, what
    np.testing.assert_allclose(got / scale, ref / scale, atol=tol, rtol=0,
                               err_msg=what)


def _state_dict_of(tree, stats=None):
    """A flax (params, batch_stats) pair in the port's names and layouts."""
    return flax_to_state_dict({"params": tree, "batch_stats": stats or {}})


# ---------------------------------------------------------------- BatchNorm
def test_depth_backbone_train_bn_matches_flax():
    """Train-mode BN: batch statistics, the new running statistics (biased
    variance, momentum 0.9) and the gradient w.r.t. the input."""
    rng = np.random.RandomState(0)
    depth = rng.randn(2, 64, 96, 1).astype(np.float32)
    w = rng.randn(2, 4, 6, 256).astype(np.float32)
    jd = JDepth(dtype=jnp.float32)
    dvars = _perturb(jax.jit(jd.init)(jax.random.PRNGKey(1), jnp.asarray(depth)),
                     rng)

    def jloss(x):
        out, mut = jd.apply(dvars, x, train=True, mutable=["batch_stats"])
        return (out * jnp.asarray(w)).sum(), (out, mut["batch_stats"])

    (_, (ref, ref_stats)), ref_dx = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jnp.asarray(depth))

    td = DepthResNet18(dtype=torch.float32).train()
    sd = _state_dict_of(dvars["params"], dvars["batch_stats"])
    missing, unexpected = td.load_state_dict(sd, strict=False)
    assert not unexpected and all("num_batches_tracked" in k for k in missing)
    x = torch.from_numpy(depth).requires_grad_()
    out = td(x)
    (out * torch.from_numpy(w)).sum().backward()

    # f32 convolutions and statistics in another summation order
    _assert_scaled(out, ref, 2e-5, "output")
    _assert_scaled(x.grad, ref_dx, 2e-5, "input grad")
    want = _state_dict_of({}, jax.tree.map(np.asarray, ref_stats))
    got = {k: v for k, v in td.state_dict().items() if k.startswith("running_")
           or ".running_" in k}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def test_masked_batchnorm_train_matches_flax():
    """Statistics over valid rows only (biased variance), momentum 0.001."""
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 8, 4) * 3 + 1).astype(np.float32)
    mask = rng.rand(3, 8) > 0.4
    mask[2] = False  # an image without boxes
    w = rng.randn(3, 8, 4).astype(np.float32)
    jm = JMaskedBN(4)
    jvars = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                             jnp.asarray(mask), False), rng)

    def jloss(xx):
        out, mut = jm.apply(jvars, xx, jnp.asarray(mask), True,
                            mutable=["batch_stats"])
        return (out * jnp.asarray(w)).sum(), (out, mut["batch_stats"])

    (_, (ref, stats)), ref_dx = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))

    bn = MaskedBatchNorm(4).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(jvars["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(jvars["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(jvars["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(jvars["batch_stats"]["var"]))
    tx = torch.from_numpy(x).requires_grad_()
    out = bn(tx, torch.from_numpy(mask))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_dx), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]),
                               atol=1e-6)


# --------------------------------------------------------------------- loss
def test_predicate_counts_and_beta_weights_match_jax():
    for ds in ("VG", "GQA"):
        np.testing.assert_array_equal(predicate_counts(ds), j_predicate_counts(ds))
        for beta in (0.999, 0.9999):
            np.testing.assert_array_equal(
                beta_class_weights(predicate_counts(ds), beta),
                j_beta(j_predicate_counts(ds), beta))


@pytest.mark.parametrize("weighted", [True, False])
def test_weighted_ce_loss_matches_jax(weighted):
    rng = np.random.RandomState(2)
    logits = (rng.randn(3, 20, 51) * 4).astype(np.float32)
    labels = rng.randint(0, 51, (3, 20)).astype(np.int32)
    mask = rng.rand(3, 20) > 0.3
    labels[~mask] = -1
    cw = beta_class_weights(predicate_counts("VG")) if weighted else None
    ref = j_wce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask),
                None if cw is None else jnp.asarray(cw))
    got = weighted_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                           torch.from_numpy(mask),
                           None if cw is None else torch.from_numpy(cw))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    # nothing valid: 0, not a division by zero
    none = torch.zeros_like(torch.from_numpy(mask))
    assert float(weighted_ce_loss(torch.from_numpy(logits),
                                  torch.from_numpy(labels), none)) == 0.0


# ---------------------------------------------------------- optimizer, LR
@pytest.fixture(scope="module")
def small_variables():
    """The small model's flax variables (init, then perturbed norms) and a
    synthetic batch of 2 images."""
    ds = SyntheticSGGDataset(num_images=2, image_size=(64, 96),
                             num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL,
                             max_objects=6, min_objects=4, max_relations=6,
                             seed=11)
    batch, _ = next(ds.batches(2, MAX_BOXES))
    jbatch = JBatch(**{k: jnp.asarray(v) for k, v in vars(batch).items()})
    jm = JModel(mode="predcls", **SMALL, dtype=jnp.float32,
                veto_encoder_impl="fused", pooler_impl="separable",
                veto_remat=False)
    init = jax.jit(functools.partial(jm.clone(veto_encoder_impl="xla").init,
                                     train=False))
    variables = init(
        jax.random.PRNGKey(0), jbatch.images, jbatch.depth, jbatch.boxes,
        jbatch.box_mask, jbatch.labels, jbatch.obj_logits,
        jnp.zeros((2, PAIRS, 2), jnp.int32), jnp.ones((2, PAIRS), bool))
    rng = np.random.RandomState(0)
    variables = {"params": jax.tree.map(np.asarray, variables["params"]),
                 "batch_stats": _perturb(
                     jax.tree.map(np.asarray, variables["batch_stats"]), rng)}
    return jm, variables, batch, jbatch


def _solver(cls, **kw):
    # large decays and a separate bias LR, so that a mislabelled leaf shows
    base = dict(ims_per_batch=2, base_lr=1e-3, bias_lr_factor=2.0,
                weight_decay=0.3, weight_decay_bias=0.05, grad_clip_norm=5.0)
    base.update(kw)
    return cls(**base)


def _grad_like(rng, p, gscale):
    """A gradient of p's sign (zero counts as +) and at least 0.5 gscale in
    size: with the L2 decay added it never nears zero, where Adam's first
    step ``g / (|g| + eps)`` would hang on the last bits of g."""
    sign = np.where(np.asarray(p) < 0, -1.0, 1.0)
    return (sign * (0.5 + np.abs(rng.randn(*np.shape(p)))) * gscale).astype(np.float32)


def test_optimizer_matches_optax(small_variables):
    """Group labels, clipping, L2 decay, Adam and the LR scale: three steps
    on the same f32 parameters and gradients."""
    _, variables, _, _ = small_variables
    params = variables["params"]
    model = SGGModel(**SMALL, dtype=torch.float32)
    load_flax_variables(model, variables)
    assert FROZEN_DETECTOR == ("backbone", "rpn", "box_extractor", "box_predictor")

    # the labels: each flax leaf's code carried to its torch name
    code = {"frozen": 0.0, "bias": 1.0, "weight": 2.0}
    labels = _label_params(params, FROZEN_DETECTOR)
    coded = _state_dict_of(jax.tree.map(
        lambda lab, p: np.full(np.shape(p), code[lab], np.float32), labels, params))
    names = dict(model.named_parameters())
    assert set(coded) == set(names)
    for n in names:
        assert code[param_label(n)] == float(coded[n].flatten()[0]), n
    assert {param_label(n) for n in names} == set(code)

    tx = j_make_optimizer(_solver(JSolverConfig), params, FROZEN_DETECTOR)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    opt = make_optimizer(_solver(SolverConfig), model)
    rng = np.random.RandomState(3)
    jp = params
    for step, (gscale, lr_scale) in enumerate(((1.0, 0.1), (1e-3, 1.0), (0.3, 0.5))):
        grads = jax.tree.map(
            lambda lab, p: (np.zeros(np.shape(p), np.float32) if lab == "frozen"
                            else _grad_like(rng, p, gscale)),
            labels, params)
        opt_state.hyperparams["lr_scale"] = jnp.asarray(lr_scale, jnp.float32)
        updates, opt_state = update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        tg = _state_dict_of(grads)
        for n, p in names.items():
            if p.requires_grad:
                p.grad = tg[n].clone()
        norm = opt.step(lr_scale)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                                   rtol=1e-5)
        want = _state_dict_of(jax.tree.map(np.asarray, jp))
        for n, p in names.items():
            # f32 Adam in another operation order; each update is ~lr
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       atol=1e-6, rtol=1e-6,
                                       err_msg=f"step {step}: {n}")


def test_lr_controller_trace_matches_jax():
    cfg = dict(warmup_iters=10, warmup_factor=0.1, plateau_patience=2,
               plateau_cooldown=1, plateau_factor=0.5, max_decay_step=3,
               plateau_threshold=1e-4)
    for method in ("linear", "constant"):
        got = LRController(SolverConfig(warmup_method=method, **cfg))
        ref = JLRController(JSolverConfig(warmup_method=method, **cfg))
        metrics = [0.1, 0.2, 0.2, 0.19, 0.18, 0.25, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1,
                   0.1, 0.1]
        for i, m in enumerate([None] + metrics):
            if m is not None:
                got.report_validation(m)
                ref.report_validation(m)
            for step in (0, 1, 5, 9, 10, 50):
                assert got.scale(step) == ref.scale(step), (method, i, step)
            assert (got.best, got.bad_epochs, got.cooldown_counter,
                    got.num_decays, got.should_stop) == (
                ref.best, ref.bad_epochs, ref.cooldown_counter,
                ref.num_decays, ref.should_stop), (method, i)
        assert got.should_stop


# ----------------------------------------------------------------- sampler
@pytest.mark.parametrize("batch_size", [16, 40, 200])
def test_gtbox_relsample_invariants(batch_size):
    rng = np.random.RandomState(4)
    b, n = 3, 8
    rel = np.zeros((b, n, n), np.int32)
    for i in range(b):
        for _ in range(12):
            s, o = rng.randint(0, n, 2)
            rel[i, s, o] = rng.choice([-1, 1, 2, 5])
    rel[:, np.arange(n), np.arange(n)] = 0
    box_mask = np.ones((b, n), bool)
    box_mask[1, 5:] = False
    box_mask[2, 2:] = False
    gen = torch.Generator().manual_seed(0)
    out = gtbox_relsample(torch.from_numpy(rel), torch.from_numpy(box_mask), gen,
                          batch_size, 0.25)
    again = gtbox_relsample(torch.from_numpy(rel), torch.from_numpy(box_mask),
                            torch.Generator().manual_seed(0), batch_size, 0.25)
    for a, c in zip(out, again):
        assert torch.equal(a, c)  # the draws come from the generator alone
    p = min(batch_size, n * n)
    assert out.pair_idx.shape == (b, p, 2) and out.pair_idx.dtype == torch.int32
    assert out.labels.shape == (b, p) and out.mask.shape == (b, p)
    num_pos = int(batch_size * 0.25)
    for i in range(b):
        pi, lab, m = (out.pair_idx[i].numpy(), out.labels[i].numpy(),
                      out.mask[i].numpy())
        valid = box_mask[i][:, None] & box_mask[i][None, :] & ~np.eye(n, dtype=bool)
        n_fg_all = int((valid & (rel[i] > 0)).sum())
        n_bg_all = int((valid & (rel[i] <= 0)).sum())
        fg = m & (lab > 0)
        n_fg = int(fg.sum())
        assert n_fg == min(num_pos, n_fg_all)
        assert int((m & (lab == 0)).sum()) == min(batch_size - n_fg, n_bg_all)
        k = int(m.sum())
        assert m[:k].all() and not m[k:].any()           # chosen, then padding
        assert (lab[:n_fg] > 0).all() and (lab[n_fg:k] == 0).all()  # fg, then bg
        assert (lab[k:] == -1).all() and (pi[k:] == 0).all()
        s, o = pi[:k, 0], pi[:k, 1]
        assert (s != o).all() and valid[s, o].all()
        assert len(set(zip(s.tolist(), o.tolist()))) == k  # no pair twice
        np.testing.assert_array_equal(lab[:n_fg], rel[i][s[:n_fg], o[:n_fg]])
        assert (rel[i][s[n_fg:], o[n_fg:]] <= 0).all()    # -1 counts as bg


# ---------------------------------------------------- gradients and a step
def test_cuda_roi_align_refuses_a_gradient_outside_the_function():
    """The CUDA launch records no graph: reached with a map that needs a
    gradient (outside the autograd Function), it raises instead of
    silently dropping the gradient."""
    feat = torch.zeros(1, 8, 8, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="records no gradient"):
        trw._launch([feat], torch.zeros(1, 2, 4), (0.25,), 2, 2)


def _jax_samples(jbatch, rng_key, step=0):
    """The samples ``make_train_step`` draws at ``step``."""
    keys = jax.random.split(jax.random.fold_in(rng_key, step), jbatch.batch_size)
    return jax.vmap(lambda k, r, m: j_relsample(
        k, r, m, batch_size=PAIRS, positive_fraction=0.25))(
        keys, jbatch.rel_matrix, jbatch.box_mask)


def _torch_samples(js):
    return RelSample(*(torch.from_numpy(np.array(a)) for a in
                       (js.pair_idx, js.labels, js.mask)))


def _grads_by_name(jgrads):
    return _state_dict_of(jax.tree.map(np.asarray, jgrads))


def test_depth_backbone_gradient_through_sgg_model(interpret, small_variables):
    """The depth path's gradient: the depth ResNet-18 is pooled by the
    ROIAlign Function and gets the gradient ``jax.grad`` gives it (eval-mode
    BN, so only the pooling and the backbone are in question)."""
    jm, variables, batch, jbatch = small_variables
    js = _jax_samples(jbatch, jax.random.PRNGKey(7))
    rng = np.random.RandomState(5)
    w = rng.randn(2, PAIRS, NUM_REL).astype(np.float32)

    def jloss(params):
        out = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                       jbatch.images, jbatch.depth, jbatch.boxes, jbatch.box_mask,
                       jbatch.labels, jbatch.obj_logits, js.pair_idx, js.mask,
                       train=False)
        return (out.rel_logits * jnp.asarray(w)).sum()

    ref = _grads_by_name(jax.jit(jax.grad(jloss))(variables["params"]))
    model = SGGModel(**SMALL, dtype=torch.float32).eval()
    load_flax_variables(model, variables)
    tb, ts = batch.to("cpu"), _torch_samples(js)
    out = model(tb.images, tb.depth, tb.boxes, tb.box_mask, tb.labels,
                tb.obj_logits, ts.pair_idx, ts.mask)
    (out.rel_logits * torch.from_numpy(w)).sum().backward()
    depth = [(n, p) for n, p in model.named_parameters()
             if n.startswith("depth_backbone.")]
    assert depth
    for n, p in depth:
        assert p.grad is not None and float(p.grad.abs().max()) > 0, n
        _assert_scaled(p.grad, ref[n].numpy(), 1e-4, n)


def test_train_step_matches_jax_f32(interpret, small_variables):
    """One whole PredCls step: JAX's ``make_train_step`` (its samples
    replicated and fed to the port's ``train_on_pairs``) against the port;
    loss, gradient norm, the depth backbone's and relation head's
    gradients, the new BN statistics; the detector stays as it was."""
    jm, variables, batch, jbatch = small_variables
    params, stats = variables["params"], variables["batch_stats"]
    cw = beta_class_weights(predicate_counts("VG")[:NUM_REL])
    lr_scale, key = 0.5, jax.random.PRNGKey(5)
    tx = j_make_optimizer(_solver(JSolverConfig), params, FROZEN_DETECTOR)
    jstate = JTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                         batch_stats=stats, opt_state=tx.init(params), rng=key)
    step = j_make_train_step(jm, tx, cw, batch_size_per_image=PAIRS,
                             positive_fraction=0.25, mode="predcls")
    new_jstate, jmetrics = jax.jit(step)(jstate, jbatch,
                                         jnp.asarray(lr_scale, jnp.float32))

    # the step's gradients, as its loss_fn takes them on the same samples
    js = _jax_samples(jbatch, key)

    def jloss(p):
        out, mut = jm.apply({"params": p, "batch_stats": stats}, jbatch.images,
                            jbatch.depth, jbatch.boxes, jbatch.box_mask,
                            jbatch.labels, jbatch.obj_logits, js.pair_idx,
                            js.mask, train=True, mutable=["batch_stats"])
        return j_wce(out.rel_logits, js.labels, js.mask, jnp.asarray(cw))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    np.testing.assert_allclose(float(jl), float(jmetrics["loss"]), rtol=1e-6)
    # after the step the port's .grad holds the clipped gradients
    norm = float(optax.global_norm(jg))
    clip = 1.0 if norm < 5.0 else 5.0 / norm
    ref = _grads_by_name(jax.tree.map(lambda g: g * clip, jg))

    model = SGGModel(**SMALL, dtype=torch.float32)
    load_flax_variables(model, variables)
    detector = {k: v.clone() for k, v in model.backbone.state_dict().items()}
    state = create_train_state(model, _solver(SolverConfig), cw)
    m = train_on_pairs(state, batch.to("cpu"), _torch_samples(js), lr_scale)

    np.testing.assert_allclose(float(m["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["rel_loss"]), float(jmetrics["rel_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=1e-4)
    trained = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    assert {n.split(".")[0] for n, _ in trained} == {"depth_backbone", "relation"}
    for n, p in trained:
        # f32 through the frozen body, the pooler, two encoder layers and
        # back: summation order only
        _assert_scaled(p.grad, ref[n].numpy(), 1e-4, n)
    want = _state_dict_of({}, jax.tree.map(np.asarray, new_jstate.batch_stats))
    assert set(m["batch_stats"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(m["batch_stats"][k].numpy(), v.numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    for k, v in model.backbone.state_dict().items():
        assert torch.equal(v, detector[k]), k
    assert all(not p.requires_grad for p in model.backbone.parameters())


def test_forward_backward_leaves_detector_out_of_autograd(small_variables):
    """Train mode keeps the frozen body in eval mode and out of the graph:
    its parameters get no gradient and its BN-free folded convs see no
    train-mode switch."""
    _, variables, batch, _ = small_variables
    model = SGGModel(**SMALL, dtype=torch.float32)
    load_flax_variables(model, variables)
    state = create_train_state(model, _solver(SolverConfig))
    model.train()
    assert not any(m.training for m in model.backbone.modules())
    assert model.depth_backbone.training and model.relation.training
    tb = batch.to("cpu")
    feats = model.extract_features(tb.images)
    assert all(f.grad_fn is None and not f.requires_grad for f in feats)
    gen = torch.Generator().manual_seed(0)
    loss = forward_backward(state, tb, sample_pairs(tb, gen, PAIRS, 0.25))
    assert torch.isfinite(loss)
    assert all(p.grad is None for p in model.backbone.parameters())
