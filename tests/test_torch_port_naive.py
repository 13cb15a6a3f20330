"""The Naive and RelatednessTest baselines against the JAX package on the
CPU (``torch_port_mp_case``'s case: hidden 32, pooling 64, 8 object and 7
predicate classes, f32, the pair mask of the eval pairs, ``pred_labels``
that differ from the labels embedded beside them).

- Eval (``relate``): ``obj_dists``, ``rel_dists`` and RelatednessTest's
  ``relness_logits`` within 1e-5 of each tensor's largest |value|,
  ``obj_preds`` equal, in PredCls and SGCls (SGDet runs through both tools
  in ``test_torch_port_zoo_rest_tools.py``).
- A train step in SGCls (PredCls for RelatednessTest, whose relness adds
  ``pre_rel_classify_loss`` there) against the JAX step's
  ``value_and_grad`` in float64: losses 1e-5, gradients 1e-4 of each
  tensor's largest |g|, the BatchNorms' statistics 1e-6.
"""

import pytest

from torch_port_legacy_case import make_inputs
from torch_port_mp_case import check_eval, check_train
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

NAIVE = ("NaivePredictor", "RelatednessTestPredictor")


@pytest.mark.parametrize("mode", ("predcls", "sgcls"))
@pytest.mark.parametrize("predictor", NAIVE)
def test_naive_eval_matches_jax(predictor, mode):
    got, _ = check_eval(make_inputs(), predictor, mode)
    assert (got.relness_logits is not None) == (predictor == "RelatednessTestPredictor")


@pytest.mark.parametrize("predictor,mode", [("NaivePredictor", "sgcls"),
                                            ("RelatednessTestPredictor", "predcls")])
def test_naive_train_step_matches_jax(predictor, mode):
    losses = check_train(make_inputs(), predictor, mode)
    assert ("pre_rel_classify_loss" in losses) == (predictor == "RelatednessTestPredictor")
