"""Port parity for BGNN (``relation.predictor=BGNNPredictor``) with the
relation-confidence pre-classifier (``relation.rel_aware``): ``relate`` in
PredCls, SGCls and SGDet, a train step with ``pre_rel_classify_loss``, the
message filter's threshold on tied scores, and the relness in the eval
step's predictions.  BGNN without the pre-classifier and MSDN have their
own file (``test_torch_port_msdn.py``), the weight bridge and the tools
too (``test_torch_port_zoo_tools.py``).

The case is ``torch_port_mp_case``'s.  With ``rel_aware`` the filter keeps
``MP = 5`` pairs an image of the case's 30 and 12, so it acts.
Tolerances: f32 outputs (the relness logits too) within 1e-5 of each
tensor's largest |value|, labels and pair orders exact; the train step
(the JAX side in float64) losses 1e-5, gradients 1e-4 of each tensor's
largest |g|, running statistics 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from veto_tpu.models.relation.postprocess import postprocess_relations as j_post

from torch_port_legacy_case import (
    B, NUM_OBJ, compare_outputs, make_inputs, port_batch, scaled, t_,
)
from torch_port_mp_case import (
    MODES, check_eval, check_train, jax_eval, jax_model, port_eval, port_model,
    variables,
)

from veto_tpu_torch.engine.evaluate import make_eval_step, to_numpy

MP = 5  # relation.mp_valid_pairs in the rel_aware cases


@pytest.fixture(scope="module")
def case():
    return make_inputs()


@pytest.mark.parametrize("mode", MODES)
def test_bgnn_rel_aware_relate_matches_jax(case, mode):
    """``relate`` in eval mode: ``obj_dists``, ``rel_dists`` and the (B, P,
    C) relness logits 1e-5, labels exact."""
    got, _ = check_eval(case, "BGNNPredictor", mode, True, MP)
    assert got.relness_logits.shape == case["pi"].shape[:2] + (7,)


def test_bgnn_rel_aware_train_step_matches_jax_float64(case):
    """A PredCls step with the pre-classifier: ``rel_loss`` and
    ``pre_rel_classify_loss`` 1e-5, every gradient 1e-4 (``relness_alpha``'s
    and the pre-classifier's included)."""
    got = check_train(case, "BGNNPredictor", "predcls", rel_aware=True)
    assert got["pre_rel_classify_loss"] > 0


def test_message_filter_keeps_every_tied_pair(case):
    """With the fused binary logit's weights at zero every pair scores the
    same relness: the threshold at the MP-th score keeps every valid pair
    (``>=``; an index top-k would keep MP), in both packages alike."""
    x = case
    v = variables("BGNNPredictor", True, True)
    tied = jax.tree.map(np.copy, v)
    layer = tied["params"]["relation"]["relation_conf_aware_models"]["fusion_layer"]
    layer["kernel"][:] = 0.0
    layer["bias"][:] = 0.25
    model = port_model("BGNNPredictor", "predcls", tied, True, MP)
    bgnn = model.relation
    seen = {}
    hook = bgnn.context_layer.register_forward_pre_hook(
        lambda m, args: seen.__setitem__("mp_mask", args[3]))
    got = port_eval(model, x, "predcls")
    hook.remove()
    scores = torch.sigmoid(got.relness_logits[..., -1])
    assert torch.equal(scores[t_(x["pm"])], torch.full_like(scores[t_(x["pm"])],
                                                            float(scores[0, 0])))
    np.testing.assert_array_equal(seen["mp_mask"].numpy(), x["pm"])
    assert (x["pm"].sum(-1) > MP).all()
    ref = jax_eval(jax_model("BGNNPredictor", "predcls", True, MP), tied, x, "predcls")
    compare_outputs(got, ref, 1e-5, "BGNN tied relness")
    # distinct scores: exactly MP an image pass
    untied = bgnn.message_pairs(torch.rand(x["pm"].shape, generator=torch.Generator()
                                           .manual_seed(0)), t_(x["pm"]))
    assert untied.sum(-1).tolist() == [MP] * B


def test_eval_step_carries_the_relness(case):
    """The PredCls eval step of a BGNN model with ``rel_aware`` (the case's
    maps in place of the body's): its predictions' ``relness`` is the
    sigmoid of the relness logits in the ranked pairs' order, as the JAX
    eval step's ``postprocess_relations(..., relness)`` gives it from the
    JAX ``relate`` on the same pairs (the ±1000 label logits)."""
    x = case
    v = variables("BGNNPredictor", True, True)
    model = port_model("BGNNPredictor", "predcls", v, True, MP)
    feats = [t_(f) for f in x["feats"]]
    model.extract_features = lambda images: feats
    batch = port_batch(x)
    got = to_numpy(make_eval_step(model, max_pairs=x["pi"].shape[1])(batch))
    jm = jax_model("BGNNPredictor", "predcls", True, MP)
    inject = jax.nn.one_hot(jnp.asarray(x["labels"]), NUM_OBJ) * 2000.0 - 1000.0

    def fn(v):
        out = jm.apply(v, tuple(jnp.asarray(f) for f in x["feats"]),
                       jnp.asarray(x["depth"]), jnp.asarray(x["boxes"]),
                       jnp.asarray(x["mask"]), jnp.asarray(x["labels"]), inject,
                       jnp.asarray(x["pi"]), jnp.asarray(x["pm"]), train=False,
                       method="relate")
        relness = jax.nn.sigmoid(out.relness_logits.astype(jnp.float32))
        return jax.vmap(j_post)(out.rel_dists, inject, jnp.asarray(x["pi"]),
                                jnp.asarray(x["pm"]), relness)

    ref = jax.tree.map(np.asarray, jax.jit(fn)(v))
    np.testing.assert_array_equal(got.pair_idx, ref.pair_idx)
    np.testing.assert_array_equal(got.pair_mask, ref.pair_mask)
    assert got.relness.shape == ref.relness.shape == x["pi"].shape[:2] + (7,)
    scaled(got.relness, ref.relness, 1e-5, "relness")
