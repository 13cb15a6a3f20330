"""AGRCNN's train step and its reclassified objects against the JAX
package on the CPU (the case of ``test_torch_port_agcn.py``: hidden 32,
pooling 64, 8 object and 7 predicate classes, f32, the graph cut to 32 on
both sides by ``torch_port_zoo_case.narrow_agrcnn``).

- A train step in SGCls against the JAX step's ``value_and_grad`` in
  float64: losses 1e-5, gradients 1e-4 of each tensor's largest |g| (the
  unused units and classifier: 0 on both sides), the BatchNorms'
  statistics 1e-6.
- With ``use_obj_recls_logits`` (a module argument, off in the JAX model)
  the predictor alone in SGCls: its outputs within 1e-5 of each tensor's
  largest |value|, its labels from ``obj_prediction_nms`` equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from veto_tpu.models.relation.legacy.agcn import AGRCNNPredictor as JAGRCNN

from torch_port_det_steps import compiled
from torch_port_legacy_case import (
    B, N, NUM_OBJ, NUM_REL, compare_outputs, fill, make_inputs, t_,
)
from torch_port_mp_case import check_train
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401
from torch_port_zoo_case import GRAPH, narrow_agrcnn

from veto_tpu_torch.models.relation.legacy import AGRCNNPredictor
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict


@pytest.fixture(autouse=True)
def narrow_graph(monkeypatch):
    narrow_agrcnn(monkeypatch)


def test_agrcnn_train_step_matches_jax():
    losses = check_train(make_inputs(), "AGRCNNPredictor", "sgcls")
    assert set(losses) == {"loss", "rel_loss", "obj_loss"}


def test_agrcnn_reclassified_objects_match_jax():
    """``use_obj_recls_logits`` with the ``add`` manner in SGCls: the refined
    object logits plus the proposals', relabelled by ``obj_prediction_nms``
    at IoU 0.5 over ``boxes_per_cls``."""
    x = make_inputs()
    rng = np.random.RandomState(6)
    p = x["pi"].shape[1]
    a = dict(boxes=x["boxes"], box_mask=x["mask"], obj_labels=x["labels"],
             predict_logits=x["logits"], pair_idx=x["pi"], pair_mask=x["pm"],
             roi_features=rng.randn(B, N, 64).astype(np.float32),
             union_features=rng.randn(B, p, 64).astype(np.float32),
             image_sizes=x["sizes"], boxes_per_cls=x["bpc"])
    kw = dict(num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL, pooling_dim=64,
              in_channels=64, graph_hidden_dim=GRAPH, mode="sgcls",
              use_obj_recls_logits=True, obj_recls_manner="add")
    jm = JAGRCNN(**kw)
    args = tuple(jnp.asarray(v) for v in a.values())
    v = fill(jax.eval_shape(lambda *z: jm.init(jax.random.PRNGKey(0), *z), *args), seed=7)

    def fn(v, *z):
        return jm.apply(v, *z, train=False)._replace(att_dists=None)

    ref = jax.tree.map(np.asarray, compiled(fn, v, *args)(v, *args))
    port = AGRCNNPredictor(**kw).eval()
    missing, unexpected = port.load_state_dict(flax_to_state_dict(v), strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    with torch.no_grad():
        got = port(t_(a["boxes"]), t_(a["box_mask"]), t_(a["obj_labels"]),
                   t_(a["predict_logits"]), t_(a["pair_idx"]), t_(a["roi_features"]),
                   t_(a["union_features"]), t_(a["image_sizes"]), t_(a["boxes_per_cls"]),
                   pair_mask=t_(a["pair_mask"]))
    compare_outputs(got, ref, 1e-5, "agrcnn recls")
    assert (got.obj_preds.numpy() != x["labels"]).any()
