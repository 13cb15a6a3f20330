"""AGRCNN against the JAX package on the CPU
(``torch_port_mp_case``'s case: hidden 32, pooling 64, 8 object and 7
predicate classes, f32).  AGRCNN's graph, 1024 wide in every model the
JAX package builds (``graph_hidden_dim``, no config key), is cut to 32 on
both sides (``torch_port_zoo_case.narrow_agrcnn``), as the attention contexts' depth is
cut in ``torch_port_legacy_case.shallow_attention``: the same code at a
width that keeps the JAX compiles short.

Eval (``relate``): ``obj_dists`` and ``rel_dists`` within 1e-5 of each
tensor's largest |value|, ``obj_preds`` equal, in PredCls, SGCls and
SGDet.  The train step and ``use_obj_recls_logits``:
``test_torch_port_agcn_train.py``.
"""

import pytest

from torch_port_legacy_case import make_inputs
from torch_port_mp_case import check_eval
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401
from torch_port_zoo_case import narrow_agrcnn


@pytest.fixture(autouse=True)
def narrow_graph(monkeypatch):
    narrow_agrcnn(monkeypatch)


@pytest.mark.parametrize("mode", ("predcls", "sgcls", "sgdet"))
def test_agrcnn_eval_matches_jax(mode):
    check_eval(make_inputs(), "AGRCNNPredictor", mode)
