"""The causal-analysis predictor (``relation.predictor=CausalAnalysisPredictor``)
against the JAX package on the CPU, on ``torch_port_legacy_case``'s case
(2 images x 6 boxes, hidden 32, pooling 64, 8 object and 7 predicate
classes, f32).

- Eval (``relate``): the Motifs context in PredCls, SGCls and SGDet with
  the effects ``none``, ``TDE``, ``NIE`` and ``TE`` and both fusions, and
  the VTransE context (a module argument only: the JAX model never builds
  it, so the predictors are compared alone) in SGCls.
  ``obj_dists`` and ``rel_dists`` within 1e-5 of each tensor's largest
  |value|, ``obj_preds`` equal.  The JAX weights are a seeded fill, its
  untreated averages (``batch_stats``) nonzero, so the counterfactual
  differs from the factual forward.
- A train step with ``TDE`` (``test_torch_port_causal_train.py``).

Tolerances: f32 on both sides, summation order only.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from veto_tpu.models.relation.legacy.causal import CausalPredictor as JCausal

from torch_port_det_steps import compiled
from torch_port_legacy_case import (
    B, N, NUM_OBJ, NUM_REL, compare_outputs, fill, jax_eval, make_inputs, port_eval,
    scaled, t_,
)
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401
from torch_port_zoo_case import causal_jax_model, causal_port_model, causal_variables

from veto_tpu_torch.models.relation.legacy import CausalPredictor
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict

EVAL_TOL = 1e-5


@pytest.mark.parametrize("mode,effect,fusion", [
    ("predcls", "none", "sum"), ("sgcls", "TDE", "gate"), ("sgdet", "NIE", "sum"),
    ("predcls", "TE", "gate")])
def test_causal_eval_matches_jax(mode, effect, fusion):
    """``relate`` in eval mode: the factual forward and, with an effect, the
    counterfactual one on the untreated averages, their difference."""
    x = make_inputs()
    v = causal_variables(mode, effect, fusion)
    ref = jax_eval(causal_jax_model(mode, effect, fusion), v, x, mode)
    model = causal_port_model(mode, effect, fusion, v)
    got = port_eval(model, x, mode)
    compare_outputs(got, ref, EVAL_TOL, f"causal {mode} {effect} {fusion}")
    if effect != "none":
        bufs = dict(model.named_buffers())
        assert float(bufs["relation.untreated_spt"].abs().max()) > 0
        # the effect is a difference: the factual logits alone are not it
        model.relation.effect_type = "none"
        plain = port_eval(model, x, mode)
        assert not torch.allclose(plain.rel_dists, got.rel_dists, atol=1e-3)


def _module_inputs(x, seed=4):
    rng = np.random.RandomState(seed)
    p = x["pi"].shape[1]
    return dict(boxes=x["boxes"], box_mask=x["mask"], obj_labels=x["labels"],
                predict_logits=x["logits"], pair_idx=x["pi"], pair_mask=x["pm"],
                roi_features=rng.randn(B, N, 64).astype(np.float32),
                union_features=rng.randn(B, p, 64).astype(np.float32),
                image_sizes=x["sizes"])


@pytest.mark.parametrize("mode,effect,fusion", [("sgcls", "TDE", "gate")])
def test_vtranse_context_matches_jax(mode, effect, fusion):
    """The predictor alone with ``context_layer="vtranse"`` (its linear
    object classifier, the untreated object and edge features)."""
    x = make_inputs()
    a = _module_inputs(x)
    kw = dict(num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL, hidden_dim=32,
              pooling_dim=64, in_channels=64, mode=mode, context_layer="vtranse",
              fusion_type=fusion, effect_type=effect)
    jm = JCausal(**kw)
    args = tuple(jnp.asarray(a[k]) for k in a)
    shapes = jax.eval_shape(lambda *z: jm.init(jax.random.PRNGKey(0), *z), *args)
    v = fill(shapes, seed=5)

    def fn(v, *z):
        return jm.apply(v, *z, train=False)._replace(relness_logits=None,
                                                     att_dists=None)

    ref = jax.tree.map(np.asarray, compiled(fn, v, *args)(v, *args))
    port = CausalPredictor(**kw).eval()
    sd = flax_to_state_dict(v)
    missing, unexpected = port.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    assert "context_layer.untreated_edg_feat" in sd
    with torch.no_grad():
        got = port(t_(a["boxes"]), t_(a["box_mask"]), t_(a["obj_labels"]),
                   t_(a["predict_logits"]), t_(a["pair_idx"]), t_(a["roi_features"]),
                   t_(a["union_features"]), t_(a["image_sizes"]),
                   pair_mask=t_(a["pair_mask"]))
    compare_outputs(got, ref, EVAL_TOL, f"vtranse {mode} {effect} {fusion}")
    scaled(got.obj_dists, ref.obj_dists, EVAL_TOL, "vtranse obj_dists")


def test_causal_refuses_unknown_settings():
    for bad in (dict(effect_type="ATE"), dict(fusion_type="max"),
                dict(context_layer="vctree")):
        with pytest.raises(ValueError):
            CausalPredictor(num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL,
                            hidden_dim=8, pooling_dim=16, in_channels=16, **bad)


def test_bridge_passes_only_the_untreated_names_through():
    """The weight bridge maps a ``batch_stats`` ``mean`` / ``var`` onto
    ``running_mean`` / ``running_var``, keeps the causal predictor's
    untreated averages under their own names, and refuses any other leaf."""
    stats = {"relation": {"untreated_spt": np.ones(3, np.float32),
                          "pos_bn": {"mean": np.zeros(2, np.float32),
                                     "var": np.ones(2, np.float32)}}}
    sd = flax_to_state_dict({"params": {}, "batch_stats": stats})
    assert set(sd) == {"relation.untreated_spt", "relation.pos_bn.running_mean",
                       "relation.pos_bn.running_var"}
    stats["relation"]["pos_bn"]["averge"] = np.zeros(2, np.float32)
    with pytest.raises(KeyError, match="relation/pos_bn/averge"):
        flax_to_state_dict({"params": {}, "batch_stats": stats})
