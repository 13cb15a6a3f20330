"""Port parity for IMP and GPSNet (``relation.predictor=IMPPredictor`` /
``GPSNetPredictor``): ``relate`` in PredCls, SGCls and SGDet, GPSNet's
PredCls train step (IMP's train step and the GRU cell's bias mapping:
``test_torch_port_mp_train.py``).

The case is ``torch_port_mp_case``'s (2 images x 6 boxes, hidden 32,
pooling 64, 8 object classes, the second image's pairs padded; IMP given
``pred_labels`` other than its labels).  Tolerances: f32 outputs within
1e-5 of each tensor's largest |value|, labels exact; the train step (the
JAX side in float64) losses 1e-5, gradients 1e-4 of each tensor's largest
|g|, running statistics 1e-6.
"""

import pytest

from torch_port_legacy_case import make_inputs
from torch_port_mp_case import MODES, check_eval, check_train


@pytest.fixture(scope="module")
def case():
    return make_inputs()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("predictor", ["IMPPredictor", "GPSNetPredictor"])
def test_relate_matches_jax(case, predictor, mode):
    """``relate`` in eval mode (the pair mask, IMP's ``pred_labels``; in SGDet
    the true sizes and ``boxes_per_cls``): ``obj_dists`` and ``rel_dists``
    1e-5, ``obj_preds`` exact."""
    got, _ = check_eval(case, predictor, mode)
    if mode != "predcls":  # the object classifier labels the boxes
        assert got.obj_dists.abs().max() < 1e3


def test_gpsnet_train_step_matches_jax_float64(case):
    """A GPSNet PredCls step against the JAX step in float64 (IMP's SGCls
    step is in ``test_torch_port_mp_train.py``)."""
    got = check_train(case, "GPSNetPredictor", "predcls")
    assert "obj_loss" not in got
