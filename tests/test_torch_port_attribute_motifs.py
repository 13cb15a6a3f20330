"""Motifs with attributes (``MotifPredictor(attribute_on=True)``: the
``AttributeLSTMContext`` and the attribute decoder) against the JAX modules
on the CPU, the predictors alone (the JAX model's ``build_model`` never
builds them so: its ``model.attribute_on`` puts the attribute head beside a
plain Motifs), f32, on ``torch_port_legacy_case``'s boxes with 9 attribute
classes, GT attribute lists and the attribute head's logits drawn from a
numpy seed.

- Eval in PredCls (``obj_dists`` the ±1000 one-hot, ``att_dists`` the raw
  GT multi-hot) and SGCls (the decoder's object and attribute logits):
  ``obj_dists``, ``rel_dists`` and ``att_dists`` within 1e-5 of each
  tensor's largest |value|, ``obj_preds`` equal.
- Training in SGCls (the decoder teacher-forced): the gradient of a fixed
  weighting of ``rel_dists`` and ``att_dists`` against ``jax.grad``, every
  parameter within 1e-4 of its tensor's largest |g|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from veto_tpu.models.relation.legacy.predictors import MotifPredictor as JMotif

from torch_port_det_steps import compiled
from torch_port_legacy_case import (
    B, N, NUM_OBJ, NUM_REL, fill, make_inputs, scaled, t_,
)
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.models.relation.legacy import MotifPredictor
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict

NUM_ATT = 9
KW = dict(num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL, embed_dim=16,
          hidden_dim=32, pooling_dim=64, in_channels=64, attribute_on=True,
          num_att_classes=NUM_ATT)
ORDER = ("boxes", "box_mask", "obj_labels", "predict_logits", "pair_idx", "pair_mask",
         "roi_features", "union_features", "image_sizes")


def inputs(seed=8):
    x = make_inputs()
    rng = np.random.RandomState(seed)
    p = x["pi"].shape[1]
    attrs = np.zeros((B, N, 10), np.int32)
    for b in range(B):
        for i in range(N):
            k = rng.randint(0, 4)
            attrs[b, i, :k] = rng.choice(np.arange(1, NUM_ATT), k, replace=False)
    attrs[0, 2, 3] = 5  # an id after a 0 slot counts not
    return dict(boxes=x["boxes"], box_mask=x["mask"], obj_labels=x["labels"],
                predict_logits=x["logits"], pair_idx=x["pi"], pair_mask=x["pm"],
                roi_features=rng.randn(B, N, 64).astype(np.float32),
                union_features=rng.randn(B, p, 64).astype(np.float32),
                image_sizes=x["sizes"], attributes=attrs * x["mask"][..., None],
                attribute_logits=(rng.randn(B, N, NUM_ATT) * 2).astype(np.float32))


def setup(mode):
    a = inputs()
    jm = JMotif(mode=mode, **KW)
    args = tuple(jnp.asarray(a[k]) for k in ORDER)
    kw = dict(attributes=jnp.asarray(a["attributes"]),
              attribute_logits=jnp.asarray(a["attribute_logits"]))
    shapes = jax.eval_shape(lambda *z: jm.init(jax.random.PRNGKey(0), *z, **kw), *args)
    v = fill(shapes, seed=9)
    port = MotifPredictor(mode=mode, **KW)
    missing, unexpected = port.load_state_dict(flax_to_state_dict(v), strict=False)
    assert not missing and not unexpected, (missing, unexpected)
    return a, jm, args, kw, v, port


def port_call(port, a):
    return port(*(t_(a[k]) for k in ORDER[:6] if k != "pair_mask"),
                t_(a["roi_features"]), t_(a["union_features"]), t_(a["image_sizes"]),
                pair_mask=t_(a["pair_mask"]), attributes=t_(a["attributes"]),
                attribute_logits=t_(a["attribute_logits"]))


@pytest.mark.parametrize("mode", ("predcls", "sgcls"))
def test_attribute_motifs_eval_matches_jax(mode):
    a, jm, args, kw, v, port = setup(mode)

    def fn(v, *z):
        return jm.apply(v, *z, train=False, **kw)._replace(relness_logits=None)

    ref = jax.tree.map(np.asarray, compiled(fn, v, *args)(v, *args))
    with torch.no_grad():
        got = port_call(port.eval(), a)
    for name in ("obj_dists", "rel_dists", "att_dists"):
        scaled(getattr(got, name), getattr(ref, name), 1e-5, f"{mode} {name}")
    np.testing.assert_array_equal(got.obj_preds.numpy(), np.asarray(ref.obj_preds))
    if mode == "predcls":  # the raw GT multi-hot, the id after a 0 left out
        assert got.att_dists[0, 2, 5] == 0 and set(np.unique(got.att_dists)) <= {0, 1}
        assert float(got.obj_dists.max()) == 1000.0


def test_attribute_motifs_sgcls_gradient_matches_jax():
    a, jm, args, kw, v, port = setup("sgcls")
    rng = np.random.RandomState(10)
    w_rel = rng.randn(*args[4].shape[:2], NUM_REL).astype(np.float32)
    w_att = rng.randn(B, N, NUM_ATT).astype(np.float32)

    def loss(params, *z):
        out = jm.apply({"params": params}, *z, train=True, **kw)
        return ((out.rel_dists * w_rel).sum() + (out.att_dists * w_att).sum()
                + (out.obj_dists * a["box_mask"][..., None]).sum())

    fn = jax.value_and_grad(loss)
    jl, jg = jax.tree.map(np.asarray, compiled(fn, v["params"], *args)(v["params"], *args))
    port.train()
    out = port_call(port, a)
    got = ((out.rel_dists * t_(w_rel)).sum() + (out.att_dists * t_(w_att)).sum()
           + (out.obj_dists * t_(a["box_mask"])[..., None]).sum())
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(jl), rtol=1e-5)
    ref = flax_to_state_dict({"params": jg})
    for name, p in port.named_parameters():
        if float(np.abs(ref[name].numpy()).max()) == 0:
            assert p.grad is None or not p.grad.any(), name
            continue
        scaled(p.grad, ref[name].numpy(), 1e-4, name)
