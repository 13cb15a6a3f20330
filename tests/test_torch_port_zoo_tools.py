"""The weight bridge and the tools for this slice of the zoo: the VGG-16
body and the message-passing predictors (IMP, BGNN, GPSNet, MSDN).

- Every leaf of the JAX trees (the VGG SGDet model's; each predictor's
  SGCls relation head, BGNN and MSDN with the pre-classifier) carries into
  the port's ``state_dict`` under its name, with its shape, and nothing of
  the port's is left over.
- A reference-format VGG-16 checkpoint (``backbone.conv_body.<i>`` or
  ``features.<i>`` names) imports into the port's body exactly as the JAX
  importer imports it.
- Both relation tools run IMP (SGCls) and BGNN with ``relation.rel_aware``
  and ``relation.mp_valid_pairs`` (PredCls) on the CPU at toy widths: the
  train step logs ``pre_rel_classify_loss`` for BGNN, the evaluation ends
  with R@K and ``evaluation_res.txt``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import veto_tpu.utils.torch_import as jti
from veto_tpu.models.backbone.vgg import VGG16Body as JVGG

from torch_port_legacy_case import TOOL_OPTS, make_inputs, relate_args
from torch_port_mp_case import port_model, variables
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.config import load_config
from veto_tpu_torch.models.backbone.vgg import VGG16_CONVS, VGG16Body
from veto_tpu_torch.tools.relation_test_net import evaluate
from veto_tpu_torch.tools.relation_train_net import train
from veto_tpu_torch.utils import torch_import as tti
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MP_PREDICTORS = ("IMPPredictor", "BGNNPredictor", "GPSNetPredictor", "MSDNPredictor")


@pytest.mark.parametrize("predictor", MP_PREDICTORS)
def test_weight_bridge_carries_every_leaf_of_the_new_heads(predictor):
    """The SGCls relation head's JAX tree (with the pre-classifier for BGNN
    and MSDN: ``relness_alpha``, its LayerNorms; the GRU cells, the
    BatchNorm's statistics) → the port's names and shapes, one to one."""
    rel_aware = predictor in ("BGNNPredictor", "MSDNPredictor")
    v = variables(predictor, rel_aware)
    sd = {k: t for k, t in flax_to_state_dict(v).items()
          if k.startswith(("relation.", "rel_box_extractor.", "union_extractor."))}
    model = port_model(predictor, "sgcls", v, rel_aware)
    own = {k: t for k, t in model.state_dict().items()
           if k.startswith(("relation.", "rel_box_extractor.", "union_extractor."))
           and not k.endswith("num_batches_tracked")}
    assert set(sd) == set(own)
    for k, t in own.items():
        assert tuple(sd[k].shape) == tuple(t.shape), k
        assert torch.equal(sd[k], t.float()), k
    if rel_aware:
        assert own["relation.relness_alpha"].shape == (1,)
    if predictor == "IMPPredictor":
        assert own["relation.node_gru.bias_hn"].shape == (32,)
        assert "relation.pairwise_feature_extractor.pos_bn.running_var" in own


def test_weight_bridge_carries_the_vgg_sgdet_model():
    """The VGG SGDet model's whole JAX tree (body, RPN, box head, depth, VETO
    head) → the port model the tool builds from ``configs/vgg_vg_predcls.yaml``:
    the same names and shapes, one to one."""
    import sys

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from relation_train_net import build_model as j_build_model

    from veto_tpu.config import load_config as j_load_config
    from veto_tpu_torch.models.sgg import build_model

    opts = ["model.num_obj_classes=8", "relation.num_classes=7", "veto.t_input_dim=96",
            "veto.enc_layers=2", "model.box_mlp_head_dim=32",
            "relation.use_gt_box=False", "relation.use_gt_object_label=False"]
    path = os.path.join(REPO, "configs", "vgg_vg_predcls.yaml")
    jm = j_build_model(j_load_config(path, opts))
    x = make_inputs()
    images = jnp.zeros((2, 64, 64, 3))
    args = (images,) + relate_args(x)[1:]
    shapes = jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a,
                                               method="init_all"), *args)
    sd = flax_to_state_dict(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                         dict(shapes)))
    model = build_model(load_config(path, opts), "cpu")
    own = {k: t for k, t in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert set(sd) == set(own)
    for k, t in own.items():
        assert tuple(sd[k].shape) == tuple(t.shape), k
    assert {k.split(".")[1] for k in own if k.startswith("backbone.")} == {
        f"conv{i}" for i, _ in VGG16_CONVS}


@pytest.mark.parametrize("prefix", ("backbone.conv_body", "features"))
def test_vgg_reference_checkpoint_imports_like_jax(tmp_path, prefix):
    """A reference VGG-16 checkpoint: all 26 tensors of the 13 convs load
    into the port's body, each equal to the JAX importer's tree under the
    weight bridge (OIHW kept, names ``conv<i>``)."""
    rng = np.random.RandomState(0)
    body = VGG16Body(torch.float32)
    sd = {f"{prefix}.{i}.{leaf}": rng.randn(*getattr(body, f"conv{i}").__getattr__(
        leaf).shape).astype(np.float32) for i, _ in VGG16_CONVS for leaf in ("weight", "bias")}
    path = str(tmp_path / "vgg_final.pth")
    torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}}, path)
    jb = JVGG(dtype=jnp.float32)
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jax.eval_shape(
        lambda a: jb.init(jax.random.PRNGKey(0), a), jnp.zeros((1, 32, 32, 3)))["params"])
    new, j_loaded, _ = jti.import_detector_weights({"backbone": params}, path)
    ref = flax_to_state_dict({"params": new})
    model = torch.nn.ModuleDict({"backbone": body})
    loaded, skipped = tti.import_detector_weights(model, path)
    assert len(loaded) == len(j_loaded) == 26 and not skipped
    for name, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), ref[name].numpy(), err_msg=name)


@pytest.mark.parametrize("predictor,config,extra", [
    ("BGNNPredictor", "veto_vg_predcls.yaml",
     ["relation.rel_aware=True", "relation.mp_valid_pairs=5"]),
    ("IMPPredictor", "veto_vg_sgcls.yaml", ["model.box_mlp_head_dim=32"]),
])
def test_both_tools_run_the_message_passing_predictors(tmp_path, predictor, config,
                                                       extra):
    """One CPU train step through ``relation_train_net.train`` and one eval
    batch through ``relation_test_net.evaluate``: the keys reach the model
    (BGNN's filter keeps 5 pairs, its pre-classifier's loss is logged), the
    losses are finite, the evaluation writes its summary."""
    cfg = load_config(os.path.join(REPO, "configs", config),
                      TOOL_OPTS + [f"relation.predictor={predictor}",
                                   f"output_dir={tmp_path}"] + extra)
    state, history = train(cfg, "cpu", log=lambda s: None)
    head = state.model.relation
    rel_aware = predictor == "BGNNPredictor"
    assert getattr(head, "rel_aware", False) == rel_aware
    if rel_aware:
        assert head.mp_valid_pairs == 5 and history[0]["pre_rel_classify_loss"] > 0
    assert all(np.isfinite(v) for k, v in history[0].items() if k.endswith("loss"))
    agg, seconds = evaluate(cfg, "cpu", max_batches=1, log=lambda s: None,
                            model=state.model)
    assert len(seconds) == 1 and all(np.isfinite(v) for v in agg["R"].values())
    assert os.path.exists(tmp_path / "evaluation_res.txt")
