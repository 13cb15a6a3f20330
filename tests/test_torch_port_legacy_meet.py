"""Port parity for the legacy predictors' MEET heads, and both relation
tools running the legacy predictors on the CPU: ``MotifPredictor_MEET``'s
PredCls train step on one routing draw, its SGDet eval step against the
JAX ``relate`` (and the JAX MEET SGDet step's call without the true sizes
and ``boxes_per_cls``, ROADMAP queue C), and the tools' ``main``.

The case is ``torch_port_legacy_case``'s (2 images x 6 boxes, P2-P5 maps
of 16 channels, hidden 32, pooling 64, 8 object classes, the 51 VG
predicates for MEET).  Tolerances: the group logits f32 within 1e-5 of
each tensor's largest |value|; the train step: losses 1e-5, every gradient
within 1e-4 of its tensor's largest |g|, running statistics 1e-6 (the union
extractor's excepted: see ``torch_port_legacy_case.UNION``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from veto_tpu.models.relation.predictor_meet import (
    meet_losses as j_meet_losses, meet_route as j_meet_route,
)

from torch_port_legacy_case import (
    MEET_REL, N, TOOL_OPTS, check_train_step, class_weights, compare_outputs,
    jax_eval, jax_model, jax_train, jax_variables, make_inputs, port_batch,
    port_model, relate_args, solver, t_, train_samples,
)
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.engine.evaluate import make_meet_eval_step
from veto_tpu_torch.engine.train import create_train_state
from veto_tpu_torch.models.detector.box_head import Detections
from veto_tpu_torch.models.relation.predictor_meet import make_meet_config
from veto_tpu_torch.models.relation.sampling import prepare_test_pairs
from veto_tpu_torch.models.sgg import DetectOutput


@pytest.fixture(scope="module")
def case():
    return make_inputs()


def test_train_step_matches_jax(case):
    """One ``MotifPredictor_MEET`` PredCls train step (``forward_backward``)
    on the case's sampled pairs, against ``jax.value_and_grad`` of the JAX
    step's loss in f32: MEET's per-group losses on one routing draw of
    JAX's, its ``member`` fed to the port.  The train-mode outputs
    ``OUT_TOL``, the losses 1e-5, every gradient within 1e-4 of its
    tensor's largest |g|, the BatchNorms' running statistics 1e-6, the
    union extractor's excepted (``UNION``)."""
    x = case
    meet = make_meet_config("VG")
    jm = jax_model("MotifPredictor", "predcls", MEET_REL, meet)
    s = train_samples(x)
    v = jax_variables(jm, relate_args(x, s.pair_idx, s.mask))
    route = jax.random.fold_in(jax.random.PRNGKey(5), 1)
    incre, rate = jnp.asarray(meet.incre_idx), jnp.asarray(meet.sample_rate)
    member = t_(j_meet_route(route, jnp.asarray(s.labels), jnp.asarray(s.mask),
                             incre, rate))
    assert member.any(0).any(0).all()

    def rel_losses(out):
        return j_meet_losses(route, out.group_logits, jnp.asarray(s.labels),
                             jnp.asarray(s.mask), incre, rate, meet.group_sizes)

    ref = jax_train(jm, v, x, s, "predcls", class_weights(MEET_REL), rel_losses)
    model = port_model("MotifPredictor", "predcls", v, MEET_REL, meet)
    state = create_train_state(model, solver(), None, mode="predcls", meet=meet)
    got = check_train_step(model, state, x, s, ref, "MotifPredictor_MEET",
                           member=member)
    assert all(np.isfinite(float(v)) for v in got.values())


def test_meet_sgdet_eval_step_matches_jax(case):
    """``MotifPredictor_MEET`` through the port's SGDet MEET eval step (its
    detector replaced by the case's detections): the step gives ``relate``
    the true image sizes and ``boxes_per_cls``, and the relation head's
    outputs (the group logits, ``obj_dists``, ``obj_preds`` after the late
    NMS over the per-class boxes) are within 1e-5 of the JAX ``relate``
    given them too.  The JAX MEET SGDet eval step passes neither (ROADMAP
    queue C): that call's group logits differ."""
    x = case
    meet = make_meet_config("VG")
    jm = jax_model("MotifPredictor", "sgdet", MEET_REL, meet)
    v = jax_variables(jm, relate_args(x))
    model = port_model("MotifPredictor", "sgdet", v, MEET_REL, meet)
    feats = [t_(f) for f in x["feats"]]
    scores = t_(x["logits"]).softmax(-1).amax(-1)
    dets = Detections(t_(x["boxes"]), scores, t_(x["labels"]), t_(x["mask"]),
                      torch.zeros_like(t_(x["labels"])), t_(x["bpc"]))
    model.detect = lambda images, sizes: DetectOutput(feats, dets, t_(x["logits"]))
    seen = {}
    hook = model.relation.register_forward_hook(
        lambda mod, args, out: seen.update(args=args, out=out))
    try:
        step = make_meet_eval_step(model, meet, max_pairs=N * N, mode="sgdet")
        res = step(port_batch(x))
    finally:
        hook.remove()
    assert res.prediction.pair_mask.any()
    args = seen["args"]
    assert torch.equal(args[7], t_(x["sizes"])) and args[8] is dets.boxes_per_cls
    pi, pm = prepare_test_pairs(dets.mask, dets.scores, max_pairs=N * N,
                                boxes=dets.boxes)
    assert torch.equal(args[4], pi)
    xs = dict(x, pi=pi.numpy(), pm=pm.numpy())
    ref = jax_eval(jm, v, xs, "sgdet")
    compare_outputs(seen["out"], ref, 1e-5, "MotifPredictor_MEET SGDet")
    # the JAX MEET step's call: the padded input's size, the boxes tiled
    # over the classes
    jax_step = jax_eval(jm, v, xs, "sgdet", sgdet_inputs=False)
    diff = max(float(np.abs(np.asarray(g) - np.asarray(r)).max() / np.abs(r).max())
               for ge, re in zip(jax_step.group_logits, ref.group_logits)
               for g, r in zip(ge, re))
    assert diff > 1e-3, diff


@pytest.mark.parametrize("predictor", ["MotifPredictor", "TransformerPredictor",
                                       "TransLikePredictor", "MotifPredictor_MEET"])
def test_tools_run_the_legacy_predictors(tmp_path, predictor):
    """Both relation tools' ``main`` in PredCls on the CPU: one train step,
    then the test tool restoring that checkpoint;
    finite losses, R@K in [0, 1]; ``MotifPredictor_MEET`` with
    ``ensemble.enabled``."""
    from veto_tpu_torch.tools import relation_test_net, relation_train_net

    opts = TOOL_OPTS + [f"output_dir={tmp_path}", f"relation.predictor={predictor}"]
    if predictor.endswith("_MEET"):
        opts.append("ensemble.enabled=true")
    history = relation_train_net.main(["--config", "configs/veto_vg_predcls.yaml",
                                       "--device", "cpu", *opts])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert ("group_01_CE_loss" if predictor.endswith("_MEET") else "rel_loss") in history[0]
    agg = relation_test_net.main(["--config", "configs/veto_vg_predcls.yaml",
                                  "--device", "cpu", "--max-batches", "1", *opts])
    assert all(0.0 <= r <= 1.0 for r in agg["R"].values())
