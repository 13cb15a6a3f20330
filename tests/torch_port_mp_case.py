"""The message-passing legacy predictors' parity case
(``test_torch_port_imp_gpsnet.py``, ``test_torch_port_bgnn.py``): IMP,
BGNN (with and without the relation-confidence pre-classifier), GPSNet
and MSDN on ``torch_port_legacy_case``'s case (2 images x 6 boxes, P2-P5
maps of 16 channels, hidden 32, pooling 64, 8 object and 7 predicate
classes, f32), with the pair mask of the case's eval pairs (the second
image's pairs padded) and, for IMP, ``pred_labels`` that differ from the
labels it embeds beside them.  The JAX weights are a seeded fill of the
tree ``jax.eval_shape`` gives, one a (predictor, pre-classifier) traced
once a process; the port takes them through the weight bridge.
"""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from veto_tpu.models.sgg import SGGModel as JModel

from torch_port_det_steps import compiled
from torch_port_legacy_case import (
    NUM_OBJ, NUM_REL, TINY, check_train_step, class_weights, compare_outputs,
    init_method, jax_train64, jax_variables, make_inputs, relate_args, scaled,
    sgdet_kw, solver, t_, train_samples,
)

from veto_tpu_torch.engine.train import create_train_state
from veto_tpu_torch.models.sgg import SGGModel
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict

MODES = ("predcls", "sgcls", "sgdet")


def mp_kw(rel_aware, mp_valid_pairs):
    return dict(bgnn_rel_aware=rel_aware, bgnn_mp_valid_pairs=mp_valid_pairs)


def jax_model(predictor, mode, rel_aware=False, mp_valid_pairs=200,
              dtype=jnp.float32):
    return JModel(mode=mode, predictor=predictor, num_rel_classes=NUM_REL, **TINY,
                  dtype=dtype, pooler_impl="separable", **mp_kw(rel_aware, mp_valid_pairs))


@functools.lru_cache(maxsize=None)
def variables(predictor, rel_aware=False, predcls=False):
    """The filled variables of ``predictor``'s PredCls model, or of its SGCls
    model with the box head (the SGDet relation head takes those too)."""
    mode = "predcls" if predcls else "sgcls"
    return jax_variables(jax_model(predictor, mode, rel_aware), relate_args(make_inputs()),
                         method=init_method(mode))


def port_model(predictor, mode, v, rel_aware=False, mp_valid_pairs=200,
               dtype=torch.float32):
    """The port model with the JAX weights: every leaf of its relation head
    loads (the detector body keeps its seeded weights)."""
    model = SGGModel(mode=mode, predictor=predictor, num_rel_classes=NUM_REL, **TINY,
                     dtype=dtype, **mp_kw(rel_aware, mp_valid_pairs)).eval()
    own = model.state_dict()
    sd = {k: t for k, t in flax_to_state_dict(v).items() if k in own}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all(k.startswith(("backbone.", "rpn.", "box_"))
               or k.endswith("num_batches_tracked") for k in missing), missing
    assert not any(k.startswith("relation.") for k in missing), missing
    return model


def pred_labels(x):
    """IMP's second labels: the case's, shifted by one class on the valid
    boxes (in SGCls the box head's NMS labels, in SGDet the detections')."""
    return (x["labels"] % (NUM_OBJ - 1) + 1) * x["mask"]


def jax_eval(jm, v, x, mode, with_pred_labels=True):
    """The JAX ``relate`` in eval mode on the case's eval pairs and mask (in
    SGDet with the true sizes and ``boxes_per_cls``), ``pred_labels``
    given; the output keeps ``relness_logits``."""
    args = relate_args(x)
    kw = sgdet_kw(x, mode)
    if with_pred_labels:
        kw["pred_labels"] = jnp.asarray(pred_labels(x))

    def fn(v, *a):
        return jm.apply(v, *a, train=False, method="relate", **kw)._replace(att_dists=None)

    return jax.tree.map(np.asarray, compiled(fn, v, *args)(v, *args))


def port_eval(model, x, mode):
    kw = ({} if mode != "sgdet" else
          dict(image_sizes=t_(x["sizes"]), boxes_per_cls=t_(x["bpc"])))
    with torch.no_grad():
        return model.relate([t_(f) for f in x["feats"]], t_(x["depth"]), t_(x["boxes"]),
                            t_(x["mask"]), t_(x["labels"]), t_(x["pi"]), t_(x["logits"]),
                            pair_mask=t_(x["pm"]), pred_labels=t_(pred_labels(x)), **kw)


def check_eval(x, predictor, mode, rel_aware=False, mp_valid_pairs=200):
    """``relate`` in eval mode against the JAX package: ``obj_dists``,
    ``rel_dists`` (and ``relness_logits``) within 1e-5 of each tensor's
    largest |value|, ``obj_preds`` exact.  Returns (port, JAX) outputs."""
    v = variables(predictor, rel_aware, mode == "predcls")
    ref = jax_eval(jax_model(predictor, mode, rel_aware, mp_valid_pairs), v, x, mode)
    got = port_eval(port_model(predictor, mode, v, rel_aware, mp_valid_pairs), x, mode)
    what = f"{predictor} {mode}" + (" rel_aware" if rel_aware else "")
    compare_outputs(got, ref, 1e-5, what)
    assert (got.relness_logits is None) == (ref.relness_logits is None), what
    if ref.relness_logits is not None:
        scaled(got.relness_logits, ref.relness_logits, 1e-5, f"{what} relness_logits")
    return got, ref


def check_train(x, predictor, mode, rel_aware=False):
    """A train step (``forward_backward``) against ``value_and_grad`` of the
    JAX step's losses in float64 (both pass through flax's train-mode
    BatchNorms: ``pos_bn`` and the union features' rect BNs): the outputs
    and losses 1e-5 (``pre_rel_classify_loss`` with ``rel_aware``), every
    gradient 1e-4 of its largest |g|, the running statistics 1e-6.  In
    SGCls the box head's logits and NMS labels feed the predictor, as in
    ``SGGModel.__call__``.  Returns the port's losses."""
    from veto_tpu.models.relation.predictor_veto import weighted_ce_loss as j_wce
    from veto_tpu.models.relation.rel_proposal import rel_aware_focal_loss as j_focal

    s = train_samples(x)
    v = variables(predictor, rel_aware, mode == "predcls")
    cw = class_weights()

    def rel_losses(out):
        losses = {"rel_loss": j_wce(out.rel_dists, jnp.asarray(s.labels),
                                    jnp.asarray(s.mask), jnp.asarray(cw))}
        if out.relness_logits is not None:
            losses["pre_rel_classify_loss"] = j_focal(
                out.relness_logits, jnp.asarray(s.labels), jnp.asarray(s.mask), NUM_REL)
        return losses

    jm64 = jax_model(predictor, mode, rel_aware, dtype=jnp.float64)
    ref = jax_train64(jm64, v, x, s, mode, cw, rel_losses=rel_losses,
                      box_head=mode == "sgcls")
    model = port_model(predictor, mode, v, rel_aware)
    state = create_train_state(model, solver(), cw, mode=mode)
    got = check_train_step(model, state, x, s, ref, f"{predictor} {mode} train",
                           out_tol=1e-5, skip=())
    assert all(np.isfinite(float(t)) for t in got.values())
    return got
