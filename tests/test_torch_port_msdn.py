"""Port parity for BGNN without the relation-confidence pre-classifier and
for MSDN (``relation.predictor=MSDNPredictor``: BGNN's gated bipartite
message passing under its own name, as in the JAX package): ``relate`` in
PredCls, SGCls and SGDet (MSDN's train step: ``test_torch_port_mp_train.py``).

The case is ``torch_port_mp_case``'s; tolerances as in
``test_torch_port_bgnn.py``.
"""

import pytest

from torch_port_legacy_case import make_inputs
from torch_port_mp_case import MODES, check_eval
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401


@pytest.fixture(scope="module")
def case():
    return make_inputs()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("predictor", ["BGNNPredictor", "MSDNPredictor"])
def test_relate_matches_jax(case, predictor, mode):
    """``relate`` in eval mode: ``obj_dists`` and ``rel_dists`` 1e-5, labels
    exact, no relness."""
    got, _ = check_eval(case, predictor, mode)
    assert got.relness_logits is None
