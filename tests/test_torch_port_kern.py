"""KERN against the JAX package on the CPU (``torch_port_mp_case``'s case:
hidden 32, pooling 64, 8 object and 7 predicate classes, f32).

- Eval (``relate``): ``obj_dists`` and ``rel_dists`` within 1e-5 of each
  tensor's largest |value|, ``obj_preds`` equal, in PredCls and SGCls.
- A train step in SGCls against the JAX step's ``value_and_grad`` in
  float64: losses 1e-5, gradients 1e-4 of each tensor's largest |g|, the
  BatchNorms' statistics 1e-6.
"""

import pytest

from torch_port_legacy_case import make_inputs
from torch_port_mp_case import check_eval, check_train
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401


@pytest.mark.parametrize("mode", ("predcls", "sgcls"))
def test_kern_eval_matches_jax(mode):
    check_eval(make_inputs(), "KERNPredictor", mode)


def test_kern_train_step_matches_jax():
    losses = check_train(make_inputs(), "KERNPredictor", "sgcls")
    assert set(losses) == {"loss", "rel_loss", "obj_loss"}
