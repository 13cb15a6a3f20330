"""Port parity for the SGCls train steps of IMP and MSDN (the box head's
logits feed the predictor, its NMS labels are IMP's ``pred_labels``, and
the refined object logits train on ``obj_loss``) against the JAX step run
in float64 (both pass through flax's train-mode BatchNorms), and for IMP's
GRU cells alone: flax's biases in ``torch.nn.GRUCell``'s parameters.

The case is ``torch_port_mp_case``'s.  Tolerances: the outputs and losses
1e-5, every gradient 1e-4 of its tensor's largest |g|, the running
statistics 1e-6; the GRU cell 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from torch_port_legacy_case import make_inputs, t_
from torch_port_mp_case import check_train
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.models.relation.legacy import GRUCell
from veto_tpu_torch.utils.jax_weights import gru_cell_params


@pytest.fixture(scope="module")
def case():
    return make_inputs()


@pytest.mark.parametrize("predictor", ["IMPPredictor", "MSDNPredictor"])
def test_sgcls_train_step_matches_jax_float64(case, predictor):
    """One SGCls step: ``rel_loss`` and ``obj_loss`` 1e-5, every gradient
    1e-4, the BatchNorms' statistics 1e-6; no pre-classifier loss."""
    got = check_train(case, predictor, "sgcls")
    assert "obj_loss" in got and "pre_rel_classify_loss" not in got


def test_gru_cell_bias_mapping_matches_flax():
    """A flax ``GRUCell``'s parameters through the weight bridge: the port's
    ``GRUCell`` and ``torch.nn.GRUCell`` (``bias_hh`` = (0, 0, ``b_hn``))
    give flax's new carry within 1e-6, from a zero carry and a random one."""
    rng = np.random.RandomState(5)
    x = rng.randn(7, 12).astype(np.float32)
    h = rng.randn(7, 9).astype(np.float32)
    cell = nn.GRUCell(9)
    v = cell.init(jax.random.PRNGKey(3), jnp.zeros((7, 9)), jnp.asarray(x))
    p = jax.tree.map(np.asarray, v["params"])
    p = {k: {n: a + 0.1 * rng.randn(*a.shape).astype(np.float32) for n, a in d.items()}
         for k, d in p.items()}  # biases off zero
    assert set(p) == {"ir", "iz", "in", "hr", "hz", "hn"}
    assert "bias" not in p["hr"] and "bias" not in p["hz"] and "bias" in p["hn"]
    conv = gru_cell_params(p)
    ours = GRUCell(12, 9)
    ours.load_state_dict({k: torch.from_numpy(a) for k, a in conv.items()})
    ref = nn.GRUCell(9).bind({"params": p})
    torch_cell = torch.nn.GRUCell(12, 9)
    with torch.no_grad():
        torch_cell.weight_ih.copy_(ours.weight_ih)
        torch_cell.weight_hh.copy_(ours.weight_hh)
        torch_cell.bias_ih.copy_(ours.bias_ih)
        torch_cell.bias_hh.copy_(torch.cat([torch.zeros(18), ours.bias_hn]))  # b_hr = b_hz = 0
        for carry in (np.zeros_like(h), h):
            want = np.asarray(ref(jnp.asarray(carry), jnp.asarray(x))[0])
            np.testing.assert_allclose(ours(t_(carry), t_(x)).numpy(), want,
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(torch_cell(t_(x), t_(carry)).numpy(), want,
                                       rtol=0, atol=1e-6)
