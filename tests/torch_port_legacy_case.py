"""The small legacy-head case the port's parity tests share
(``test_torch_port_legacy*.py``, ``test_torch_port_vctree.py``).

Two 64x64 images (the second padded from 56 x 48) with 6 boxes each (4
valid in the second, two of the first's boxes sharing a centre), 8 object
and 7 predicate classes (51 for MEET), P2-P5 maps of 16 channels drawn
from a numpy seed, the legacy heads at hidden 32 / pooling 64 in f32 on
both sides (the JAX model's plain ``separable`` pooler).  The JAX weights
are a seeded fill of the tree ``jax.eval_shape`` gives for the model's
``relate`` (no compiled ``init``), carried into the port by the weight
bridge (``utils/jax_weights.py``); each JAX function is compiled once with
the CPU backend's LLVM optimisation off (``torch_port_det_steps.compiled``).
"""

import functools
from types import SimpleNamespace

import numpy as np
import torch

import jax
import jax.numpy as jnp

from veto_tpu.engine.train import _binary_loss as j_binary_loss
from veto_tpu.models.relation.predictor_veto import weighted_ce_loss as j_wce
from veto_tpu.models.sgg import SGGModel as JModel
from veto_tpu.ops.nms import obj_prediction_nms as j_obj_nms

from torch_port_det_steps import compiled

from veto_tpu_torch.config import SolverConfig
from veto_tpu_torch.engine.batch import SGGBatch
from veto_tpu_torch.models.relation.predictor_veto import beta_class_weights
from veto_tpu_torch.models.relation.sampling import (
    RelSample, binary_relatedness, gtbox_relsample,
)
from veto_tpu_torch.models.sgg import SGGModel
from veto_tpu_torch.solver.optim import FROZEN_DETECTOR
from veto_tpu_torch.data.predicate_stats import predicate_counts
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict

B, N, P_TRAIN = 2, 6, 16
# the relation tools on the CPU: toy sizes, one train step
TOOL_OPTS = ["model.stage_blocks=(1,1,1,1)", "data.min_size_train=64",
             "data.max_size_train=96", "data.min_size_test=64", "data.max_size_test=96",
             "data.max_boxes=6", "relation.batch_size_per_image=16",
             "relation.max_proposal_pairs=30", "solver.ims_per_batch=2",
             "test.ims_per_batch=8", "relation.context_hidden_dim=16",
             "relation.context_pooling_dim=32", "solver.max_iter=1",
             "solver.checkpoint_period=1",
             "dtype=float32"]

NUM_OBJ, NUM_REL, MEET_REL = 8, 7, 51
SIZES = np.array([[64, 64], [56, 48]], np.float32)  # (w, h) before padding
TINY = dict(num_obj_classes=NUM_OBJ, stage_blocks=(1, 1, 1, 1), groups=1,
            width_per_group=16, fpn_channels=16, box_mlp_dim=32,
            context_hidden_dim=32, context_pooling_dim=64, fold_bn=False)


def t_(a):
    return torch.from_numpy(np.array(a))


def scaled(got, ref, tol, what):
    """``got`` within ``tol`` of the largest |ref|, elementwise."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, err_msg=what,
                               atol=tol * max(float(np.abs(ref).max()), 1e-6))


def make_inputs(seed=0):
    """The case's numpy inputs (see the module docstring)."""
    rng = np.random.RandomState(seed)
    feats = tuple(rng.randn(B, 64 // s, 64 // s, 16).astype(np.float32)
                  for s in (4, 8, 16, 32, 64))
    xy = rng.uniform(0, 34, (B, N, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 26, (B, N, 2))], -1)
    boxes = np.minimum(boxes, SIZES[:, None, [0, 1, 0, 1]] - 1).astype(np.float32)
    boxes[0, 3] = boxes[0, 1] + np.float32([0, 2, 0, -2])  # the same centre x
    mask = np.ones((B, N), bool)
    mask[1, 4:] = False
    boxes[~mask] = 0.0
    labels = rng.randint(1, NUM_OBJ, (B, N)).astype(np.int32) * mask
    logits = (rng.randn(B, N, NUM_OBJ) * 2).astype(np.float32)
    bpc = (boxes[:, :, None, :] + rng.uniform(-2, 2, (B, N, NUM_OBJ, 4))).astype(np.float32)
    rel = (rng.randint(1, NUM_REL, (B, N, N)) * (rng.rand(B, N, N) < 0.3)
           * (1 - np.eye(N, dtype=int)) * mask[:, :, None] * mask[:, None, :])
    # every valid ordered pair, the eval pairs (prepare_test_pairs' order)
    pairs = [[(i, j) for i in range(N) for j in range(N)
              if i != j and mask[b, i] and mask[b, j]] for b in range(B)]
    pm = np.zeros((B, N * N), bool)
    pi = np.zeros((B, N * N, 2), np.int32)
    for b, ps in enumerate(pairs):
        pi[b, :len(ps)] = ps
        pm[b, :len(ps)] = True
    return dict(feats=feats, boxes=boxes, mask=mask, labels=labels, logits=logits,
                bpc=bpc, rel=rel.astype(np.int32), pi=pi, pm=pm,
                depth=np.zeros((B, 64, 64, 1), np.float32), sizes=SIZES.copy())


def jax_model(predictor, mode, num_rel=NUM_REL, meet=None, dtype=jnp.float32):
    kw = {} if meet is None else dict(meet_group_sizes=tuple(meet.group_sizes),
                                       meet_experts=meet.experts_per_group)
    return JModel(mode=mode, predictor=predictor, num_rel_classes=num_rel, **TINY,
                  **kw, dtype=dtype, pooler_impl="separable")


# the attention contexts cut to one object and one edge layer (the JAX
# predictors' class defaults are 4 and 2), to keep the JAX compiles short
SHALLOW = dict(obj_layers=1, edge_layers=1)


def shallow_attention(monkeypatch):
    """Make the JAX model build its Transformer and TransLike predictors with
    :data:`SHALLOW` contexts until the test ends."""
    from veto_tpu.models.relation import legacy as jlegacy

    for name in ("TransformerPredictor", "TransLikePredictor"):
        base = getattr(jlegacy, name)
        cls = type(name, (base,), {"__annotations__": {"obj_layers": int,
                                                       "edge_layers": int},
                                   **SHALLOW})
        monkeypatch.setattr(jlegacy, name, cls)


def port_model(predictor, mode, variables, num_rel=NUM_REL, meet=None,
               dtype=torch.float32, shallow=False):
    """The port model of the configuration with the JAX weights: every
    leaf of the tree loads (the detector body, absent from ``relate``'s
    tree, keeps its seeded weights); ``shallow``: the attention context
    cut as :func:`shallow_attention` cuts the JAX one."""
    kw = {} if meet is None else dict(meet_group_sizes=meet.group_sizes,
                                       meet_experts=meet.experts_per_group)
    model = SGGModel(mode=mode, predictor=predictor, num_rel_classes=num_rel, **TINY,
                     **kw, dtype=dtype).eval()
    if shallow:
        model.relation = type(model.relation)(
            num_obj_classes=NUM_OBJ, num_rel_classes=num_rel, hidden_dim=32,
            pooling_dim=64, in_channels=64, mode=mode, dtype=dtype, **SHALLOW, **kw)
    sd = flax_to_state_dict(variables)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected, unexpected
    assert all(k.startswith(("backbone.", "rpn.", "box_"))
               or k.endswith("num_batches_tracked") for k in missing), missing
    return model


def fill(shapes, seed=1):
    """A seeded fill of a flax variables tree of ``shapes``: kernels and the
    explicit ``*_w`` matrices LeCun-normal, biases and BN / LN offsets
    N(0, 0.1^2), scales 1 + N(0, 0.1^2), embeddings N(0, 1), the frequency
    bias N(0, 0.5^2) (nonzero, so that it shows), running means N(0, 0.1^2)
    and variances U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name in ("kernel", "bi_freq_prior") or name.endswith("_w"):
            fan_in = int(np.prod(shape[:-1]))
            a = rng.randn(*shape) / np.sqrt(fan_in)
        elif name in ("embedding", "obj_embed"):
            a = rng.randn(*shape)
        elif name == "scale":
            a = 1 + 0.1 * rng.randn(*shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "obj_baseline":
            a = 0.5 * rng.randn(*shape)
        else:  # bias, *_b, mean
            a = 0.1 * rng.randn(*shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def relate_args(x, pi=None, pm=None):
    return (tuple(jnp.asarray(f) for f in x["feats"]), jnp.asarray(x["depth"]),
            jnp.asarray(x["boxes"]), jnp.asarray(x["mask"]), jnp.asarray(x["labels"]),
            jnp.asarray(x["logits"]), jnp.asarray(x["pi"] if pi is None else pi),
            jnp.asarray(x["pm"] if pm is None else pm))


def init_method(mode):
    """``init``'s method for a train step: ``relate``, in SGCls with the box
    head (whose logits the step takes as the proposals')."""
    def method(m, feats, depth, boxes, mask, labels, logits, pi, pm):
        if mode == "sgcls":
            m._box_logits(feats, boxes)
        return m.relate(feats, depth, boxes, mask, labels, logits, pi, pm)
    return method


def jax_variables(jm, args, method="relate", seed=1):
    shapes = jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a, method=method),
                            *args)
    return fill(shapes, seed)


@functools.lru_cache(maxsize=None)
def sgcls_variables(predictor):
    """The filled variables of ``predictor``'s SGCls model with its box head
    (``init_method("sgcls")``), traced once a process: the SGCls and SGDet
    evals and the SGCls train step share them (the two modes' relation
    heads have one tree)."""
    x = make_inputs()
    return jax_variables(jax_model(predictor, "sgcls"), relate_args(x),
                         method=init_method("sgcls"))


def sgdet_kw(x, mode):
    """``relate``'s SGDet keywords (the true sizes and ``boxes_per_cls``)."""
    if mode != "sgdet":
        return {}
    return dict(image_sizes=jnp.asarray(x["sizes"]), boxes_per_cls=jnp.asarray(x["bpc"]))


def jax_eval(jm, variables, x, mode, sgdet_inputs=True):
    """The JAX ``relate`` in eval mode on the case's eval pairs; in SGDet
    with the true sizes and ``boxes_per_cls`` unless ``sgdet_inputs`` is
    False (the JAX MEET SGDet eval step's call, which passes neither)."""
    args = relate_args(x)
    kw = sgdet_kw(x, mode) if sgdet_inputs else {}

    def fn(v, *a):
        out = jm.apply(v, *a, train=False, method="relate", **kw)
        return out._replace(relness_logits=None, att_dists=None)

    return jax.tree.map(np.asarray, compiled(fn, variables, *args)(variables, *args))


def port_eval(model, x, mode, dtype=torch.float32, forest=None):
    feats = [t_(f).to(dtype) if dtype != torch.float32 else t_(f) for f in x["feats"]]
    kw = ({} if mode != "sgdet" else
          dict(image_sizes=t_(x["sizes"]), boxes_per_cls=t_(x["bpc"])))
    if forest is not None:
        kw["forest"] = forest
    with torch.no_grad():
        return model.relate(feats, t_(x["depth"]), t_(x["boxes"]), t_(x["mask"]),
                            t_(x["labels"]), t_(x["pi"]), t_(x["logits"]), **kw)


def compare_outputs(got, ref, tol, what):
    """obj_dists, rel_dists (or every group's logits), obj_preds (exact) and
    binary_preds of a ``LegacyOutput`` against the JAX one."""
    scaled(got.obj_dists, ref.obj_dists, tol, f"{what} obj_dists")
    np.testing.assert_array_equal(got.obj_preds.numpy(), np.asarray(ref.obj_preds),
                                  f"{what} obj_preds")
    if ref.rel_dists is not None:
        scaled(got.rel_dists, ref.rel_dists, tol, f"{what} rel_dists")
    else:
        for e, (ge, re) in enumerate(zip(got.group_logits, ref.group_logits)):
            for k, (g, r) in enumerate(zip(ge, re)):
                scaled(g, r, tol, f"{what} group logits e{e} g{k}")
    assert (got.binary_preds is None) == (ref.binary_preds is None)
    if ref.binary_preds is not None:
        scaled(got.binary_preds, ref.binary_preds, tol, f"{what} binary_preds")


def train_samples(x, seed=9):
    """Training pairs of the case's relations (P_TRAIN an image) as numpy
    arrays, in the fields of JAX's ``RelSample``: the port's
    ``gtbox_relsample`` draws them from a seeded generator (both packages'
    steps are given them, so which sampler draws them does not matter)."""
    rel, mask = t_(x["rel"]), t_(x["mask"])
    s = gtbox_relsample(rel, mask, torch.Generator().manual_seed(seed), P_TRAIN)
    s = SimpleNamespace(pair_idx=s.pair_idx.numpy(), labels=s.labels.numpy(),
                        mask=s.mask.numpy(),
                        binary_rel=binary_relatedness(rel, mask).numpy())
    assert (s.labels > 0).sum() > 0
    return s


def class_weights(num_rel=NUM_REL):
    return beta_class_weights(predicate_counts("VG")[:num_rel])


def solver():
    return SolverConfig(ims_per_batch=2, base_lr=1e-3, bias_lr_factor=2.0,
                        weight_decay=0.3, weight_decay_bias=0.05, grad_clip_norm=5.0)


def port_batch(x):
    """The case as a port ``SGGBatch`` (its images only shape the batch:
    the tests give the model the case's maps)."""
    return SGGBatch(images=torch.zeros((B, 64, 64, 3)), depth=t_(x["depth"]),
                    boxes=t_(x["boxes"]), box_mask=t_(x["mask"]), labels=t_(x["labels"]),
                    obj_logits=t_(x["logits"]), rel_matrix=t_(x["rel"]),
                    sizes=t_(x["sizes"]).int())


def port_rel_sample(s):
    return RelSample(t_(s.pair_idx), t_(s.labels), t_(s.mask))


def jax_train(jm, variables, x, s, mode, cw, rel_losses=None, box_head=False,
              gumbel_from=None):
    """``value_and_grad`` of the JAX train step's loss at the case's maps on
    the samples ``s``: (loss, (losses, outputs, new batch_stats)), grads.
    ``rel_losses(out)`` gives the relation losses (default: the weighted
    CE); with ``box_head`` the SGCls box head's logits are the proposals'
    logits, as ``SGGModel.__call__`` computes them."""
    args = relate_args(x, s.pair_idx, s.mask)
    if mode == "predcls":  # the ±1000 GT injection SGGModel.__call__ makes
        args = args[:5] + (jax.nn.one_hot(args[4], NUM_OBJ) * 2000.0 - 1000.0,) + args[6:]
    stats = variables["batch_stats"]

    def method(m, feats, depth, boxes, mask, labels, logits, pi, pm):
        pred_labels = None
        if box_head:  # SGGModel.__call__'s SGCls logits and NMS labels
            logits = m._box_logits(feats, boxes)[0]
            tiled = jnp.broadcast_to(boxes[:, :, None, :],
                                     boxes.shape[:2] + (logits.shape[-1], 4))
            pred_labels = jax.vmap(lambda b, lg, mk: j_obj_nms(
                b, lg, 0.5, valid_mask=mk))(tiled, logits, mask)
        return m.relate(feats, depth, boxes, mask, labels, logits, pi, pm, train=True,
                        pred_labels=pred_labels)

    def loss_fn(params):
        out, mut = jm.apply({"params": params, "batch_stats": stats}, *args,
                            mutable=["batch_stats"], method=method)
        if rel_losses is None:
            losses = {"rel_loss": j_wce(out.rel_dists, jnp.asarray(s.labels),
                                        jnp.asarray(s.mask), jnp.asarray(cw))}
        else:
            losses = rel_losses(out)
        if out.binary_preds is not None:
            losses["binary_loss"] = j_binary_loss(out.binary_preds,
                                                  jnp.asarray(s.binary_rel), args[3])
        if mode != "predcls":
            losses["obj_loss"] = j_wce(out.obj_dists, args[4], args[3], None)
        out = out._replace(relness_logits=None, att_dists=None)
        return sum(losses.values()), (losses, out, mut["batch_stats"])

    fn = jax.value_and_grad(loss_fn, has_aux=True)
    return jax.tree.map(np.asarray, compiled(fn, variables["params"])(variables["params"]))


# The f32 comparisons of a train step.  The union features' rect
# BatchNorms take their batch statistics over 6,272 values a channel, and
# flax's f32 sums on the CPU are up to 2e-5 of the normalized output off a
# float64 computation there (the port's 1e-7).  The gated pair features
# carry that into the logits (so train-mode outputs are held to OUT_TOL),
# and inside the union extractor it moves the gradients: through the rect
# BatchNorms' backward, whose f32 reductions cancel (up to 2.5e-2 of the
# largest |g| off the JAX step's own float64 run), and through the fc6 /
# fc7 ReLUs whose input it moves across 0.  The f32 comparisons therefore
# leave the union extractor's gradients and statistics out (UNION); the
# float64 comparisons (``jax_train64``: the JAX step run with
# ``jax.enable_x64``, possible where no flax LSTM cell is on the path) hold
# every tensor.
OUT_TOL = 1e-4
UNION = ("union_extractor.",)
# A gradient below this share of the step's largest is 0 analytically (the
# attention keys' bias: the softmax ignores a shift of the keys; a bias
# under a training BatchNorm), and both sides hold only their rounding.
ZERO_GRAD = 1e-6


def jax_train64(jm64, variables, x, s, mode, cw, **kw):
    """:func:`jax_train` with the JAX package in float64 (``jm64`` built with
    ``dtype=jnp.float64``; the weights and the case's floats widened), its
    results narrowed back to f32."""
    with jax.enable_x64(True):
        x64 = {k: (tuple(f.astype(np.float64) for f in a) if k == "feats"
                   else a.astype(np.float64) if a.dtype == np.float32 else a)
               for k, a in x.items()}
        ref = jax_train(jm64, jax.tree.map(lambda a: a.astype(np.float64), variables),
                        x64, s, mode, cw, **kw)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), ref)


def check_train_step(model, state, x, s, ref, what, gumbel=None, member=None,
                     out_tol=OUT_TOL, skip=UNION):
    """The port's ``forward_backward`` on the case (its maps in place of the
    detector body's) against ``jax_train``'s ``ref``: the outputs
    ``OUT_TOL``,
    every loss 1e-5, every trainable gradient within 1e-4 of its tensor's
    largest |g| (the same tensors train on both sides; the ``skip``
    prefixes left out), the running statistics after the forward 1e-6.
    Returns the port's losses."""
    from veto_tpu_torch.engine.train import forward_backward

    (jl, (jlosses, jout, jstats)), jgrads = ref
    feats = [t_(f) for f in x["feats"]]
    model.extract_features = lambda images: feats
    seen = {}
    hook = model.relation.register_forward_hook(
        lambda mod, inp, out: seen.__setitem__("out", out))
    try:
        got = forward_backward(state, port_batch(x), port_rel_sample(s), member=member,
                               gumbel=gumbel)
    finally:
        hook.remove()
    compare_outputs(seen["out"], jout, out_tol, what)
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(got["loss"]), float(jl), rtol=1e-5)
    assert set(got) == set(jlosses) | {"loss"}, (set(got), set(jlosses))
    ref_g = flax_to_state_dict({"params": jgrads})
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    # the frozen detector (the SGCls box head) trains on neither side
    frozen = set(ref_g) - set(trained)
    assert all(n.startswith(FROZEN_DETECTOR) and not ref_g[n].any() for n in frozen), frozen
    assert set(trained) <= set(ref_g), set(trained) - set(ref_g)
    floor = ZERO_GRAD * max(float(ref_g[n].abs().max()) for n in trained)
    for n, p in trained.items():
        if n.startswith(skip):
            continue
        ref_n = ref_g[n].numpy()
        if np.abs(ref_n).max() <= floor:  # a gradient that is 0 analytically
            assert p.grad is None or float(p.grad.abs().max()) <= floor, n
            continue
        scaled(p.grad, ref_n, 1e-4, n)
    ref_stats = flax_to_state_dict({"params": {}, "batch_stats": jstats})
    bufs = dict(model.named_buffers())
    for n, v in ref_stats.items():
        if n.startswith(skip):
            continue
        np.testing.assert_allclose(bufs[n].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                   err_msg=n)
    return got
