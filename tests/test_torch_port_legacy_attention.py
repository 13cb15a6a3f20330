"""Port parity for the legacy attention predictors, Transformer and
TransLike: their eval ``relate`` at the JAX predictors' own depth (4 object
and 2 edge layers), and a PredCls train step against the JAX step run in
float64.

The case is ``torch_port_legacy_case``'s (2 images x 6 boxes, P2-P5 maps
of 16 channels, hidden 32, pooling 64, 8 object classes).  Tolerances: f32
outputs within 1e-5 of each tensor's largest |value|; the train step: the
outputs and losses 1e-5, every gradient within 1e-4 of its tensor's
largest |g|, every running statistic 1e-6.
"""

import pytest

import jax.numpy as jnp

from torch_port_legacy_case import (
    class_weights, check_train_step, compare_outputs, jax_eval, jax_model,
    jax_train64, jax_variables, make_inputs, port_eval, port_model, relate_args,
    shallow_attention, solver, train_samples,
)

from veto_tpu_torch.engine.train import create_train_state

ATTENTION = ["TransformerPredictor", "TransLikePredictor"]


@pytest.fixture(scope="module")
def case():
    return make_inputs()


@pytest.mark.parametrize("predictor", ATTENTION)
def test_attention_eval_matches_jax(case, predictor):
    """The attention predictors through ``relate`` in eval mode (the
    BatchNorms on their running statistics) at the JAX predictors' own
    context depth, in PredCls: ``obj_dists`` and ``rel_dists`` in f32
    within 1e-5 of each tensor's largest |value|, ``obj_preds`` exact."""
    x = case
    jm = jax_model(predictor, "predcls")
    v = jax_variables(jm, relate_args(x))
    ref = jax_eval(jm, v, x, "predcls")
    model = port_model(predictor, "predcls", v)
    ctx = model.relation.context_layer
    assert (ctx.context_obj.layers, ctx.context_edge.layers) == (4, 2)
    compare_outputs(port_eval(model, x, "predcls"), ref, 1e-5, predictor)


@pytest.mark.parametrize("predictor", ATTENTION)
def test_attention_train_step_matches_jax_float64(case, monkeypatch, predictor):
    """A PredCls train step of the attention predictors against the JAX step
    run in float64 (``jax.enable_x64``, the model's dtype float64, the same
    weights; the contexts cut to one object and one edge layer on both
    sides): the train-mode outputs and the losses 1e-5, every gradient
    within 1e-4 of its tensor's largest |g|, the union extractor's
    included, and every running statistic 1e-6."""
    x = case
    shallow_attention(monkeypatch)
    s = train_samples(x)
    jm = jax_model(predictor, "predcls")
    v = jax_variables(jm, relate_args(x, s.pair_idx, s.mask))
    cw = class_weights()
    ref = jax_train64(jax_model(predictor, "predcls", dtype=jnp.float64), v, x, s,
                      "predcls", cw)
    model = port_model(predictor, "predcls", v, shallow=True)
    state = create_train_state(model, solver(), cw, mode="predcls")
    check_train_step(model, state, x, s, ref, predictor, out_tol=1e-5, skip=())
