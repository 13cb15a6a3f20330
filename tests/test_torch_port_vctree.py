"""Port parity for VCTree: the greedy tree build, the predictor through
``SGGModel.relate`` in PredCls, SGCls and SGDet, its SGCls train step with
the JAX package's Gumbel draw fed in, the JAX package's fixed Gumbel key
(ROADMAP queue C), and both relation tools on the CPU.

The case is ``torch_port_legacy_case``'s (2 images x 6 boxes, P2-P5 maps
of 16 channels, hidden 32, pooling 64, 8 object classes).  Tolerances:
the forest bit-equal; f32 outputs within 1e-5 of each tensor's largest
|value|; the train step: losses 1e-5, every gradient within 1e-4 of its
tensor's largest |g|, running statistics 1e-6 (the union extractor's
excepted: see ``torch_port_legacy_case.UNION``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from veto_tpu.models.relation.legacy.vctree import build_vctree as j_build_vctree

from torch_port_legacy_case import (
    B, N, NUM_OBJ, OUT_TOL, check_train_step, class_weights, compare_outputs,
    jax_eval, jax_model, jax_train, jax_variables, make_inputs, port_eval,
    port_model, relate_args, sgcls_variables, solver, t_, train_samples,
)
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.engine.train import create_train_state, draw_gumbel
from veto_tpu_torch.models.relation.legacy import build_vctree


@pytest.fixture(scope="module")
def case():
    return make_inputs()


def _score_cases():
    """(scores (B, n, n), mask (B, n)) batches: random scores with padding;
    scores on a coarse grid (ties in the mean and in the edges); all
    scores equal; one valid node; no valid node."""
    rng = np.random.RandomState(3)
    n = 7
    out = []
    s = rng.rand(3, n, n).astype(np.float32)
    m = np.ones((3, n), bool)
    m[1, 5:] = False
    m[2, ::2] = False
    out.append((s, m))
    out.append((np.round(rng.rand(3, n, n) * 4).astype(np.float32) / 4, m))
    out.append((np.full((3, n, n), 0.5, np.float32), m))
    one = np.zeros((3, n), bool)
    one[:, 3] = True
    one[2] = False
    out.append((s, one))
    return out


def test_build_vctree_is_bit_equal():
    """The forest (left child, right sibling, parent, root, membership) of
    every image equals the JAX package's, ties and padding included."""
    jbuild = jax.jit(jax.vmap(j_build_vctree))
    for scores, mask in _score_cases():
        ref = jbuild(jnp.asarray(scores), jnp.asarray(mask))
        got = build_vctree(t_(scores), t_(mask))
        for name in ("left", "right", "parent", "root", "in_tree"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)), name)
        # every valid node is in the tree, and a valid tree has one root
        np.testing.assert_array_equal(got.in_tree.numpy(), mask)
        assert ((got.parent < 0) & got.in_tree).sum(1).tolist() == \
            [min(1, int(m.sum())) for m in mask]


@pytest.mark.parametrize("mode", ["predcls", "sgcls", "sgdet"])
def test_vctree_eval_matches_jax(case, mode):
    """VCTree through ``relate`` in eval mode (in SGCls and SGDet the tree
    decoder's greedy labels): ``obj_dists``, ``rel_dists`` and
    ``binary_preds`` 1e-5, ``obj_preds`` exact; the output's forest given
    back to ``relate`` (``forest=``, as ``chip_smoke.py`` compares two runs
    on one forest) gives the same outputs."""
    x = case
    jm = jax_model("VCTreePredictor", mode)
    v = (jax_variables(jm, relate_args(x)) if mode == "predcls"
         else sgcls_variables("VCTreePredictor"))
    ref = jax_eval(jm, v, x, mode)
    model = port_model("VCTreePredictor", mode, v)
    got = port_eval(model, x, mode)
    compare_outputs(got, ref, 1e-5, f"VCTree {mode}")
    again = port_eval(model, x, mode, forest=got.forest)
    assert torch.equal(again.rel_dists, got.rel_dists)


def _jax_gumbel(key=0):
    """The noise JAX's VCTree decoder draws when no key is passed: per image
    a key split off ``PRNGKey(key)``, (N, C - 1) standard Gumbel."""
    keys = jax.random.split(jax.random.PRNGKey(key), B)
    return np.stack([np.asarray(jax.random.gumbel(k, (N, NUM_OBJ - 1))) for k in keys])


@pytest.fixture(scope="module")
def sgcls_step(case):
    """The SGCls train step's case: the sampled pairs, the weights, and
    ``value_and_grad`` of the JAX step's loss, in f32 (its decoder takes the
    noise of keys split off ``PRNGKey(0)``, as in every JAX step)."""
    x = case
    s = train_samples(x)
    jm = jax_model("VCTreePredictor", "sgcls")
    v = sgcls_variables("VCTreePredictor")
    ref = jax_train(jm, v, x, s, "sgcls", class_weights(), box_head=True)
    return x, s, v, ref


def _port_step(sgcls_step, gumbel):
    """The port's SGCls step on the case fed ``gumbel``: its model, state,
    and the relation head's train-mode output."""
    from veto_tpu_torch.engine.train import forward_backward
    from torch_port_legacy_case import port_batch, port_rel_sample

    x, s, v, _ = sgcls_step
    model = port_model("VCTreePredictor", "sgcls", v)
    state = create_train_state(model, solver(), class_weights(), mode="sgcls")
    feats = [t_(f) for f in x["feats"]]
    model.extract_features = lambda images: feats
    seen = {}
    hook = model.relation.register_forward_hook(
        lambda mod, inp, out: seen.__setitem__("out", out))
    forward_backward(state, port_batch(x), port_rel_sample(s), gumbel=gumbel)
    hook.remove()
    return model, state, seen["out"]


def test_vctree_sgcls_train_step_matches_jax(sgcls_step):
    """One SGCls train step of VCTree (``forward_backward``) on the case's
    sampled pairs, fed the Gumbel draw JAX's decoder takes: ``rel_loss``,
    ``obj_loss`` and ``binary_loss`` 1e-5, the train-mode outputs
    ``OUT_TOL``, every gradient within 1e-4 of its tensor's largest |g|,
    every running statistic 1e-6, the union extractor's excepted
    (``UNION``; VCTree's decoder keeps f32 state, so the JAX step cannot run
    in float64 here: the attention predictors' float64 steps hold the
    union extractor)."""
    x, s, v, ref = sgcls_step
    assert set(ref[0][1][0]) == {"rel_loss", "obj_loss", "binary_loss"}
    model = port_model("VCTreePredictor", "sgcls", v)
    state = create_train_state(model, solver(), class_weights(), mode="sgcls")
    check_train_step(model, state, x, s, ref, "VCTree sgcls", gumbel=t_(_jax_gumbel()))


def test_jax_vctree_draws_the_same_gumbel_noise_every_step(sgcls_step):
    """ROADMAP queue C: the JAX package's ``SGGModel.relate`` passes VCTree no
    key, so its training decoder draws its Gumbel noise from keys split off
    ``PRNGKey(0)`` at every step, whatever the step's key.  The JAX step's
    decoder output equals the port's fed that draw (1e-5), and is more
    than 1e-3 away from the port's fed either of two draws from the step
    generator, which differ from each other: the port draws afresh each
    step."""
    x, s, v, ref = sgcls_step
    jout = ref[0][1][1]
    _, _, fixed = _port_step(sgcls_step, t_(_jax_gumbel()))
    compare_outputs(fixed, jout, OUT_TOL, "the fixed-key draw")
    gen = torch.Generator().manual_seed(0)
    model = port_model("VCTreePredictor", "sgcls", v).train()
    draws = [draw_gumbel(model, N, B, gen) for _ in range(2)]
    assert draws[0].shape == (B, N, NUM_OBJ - 1) and not torch.equal(*draws)
    for d in draws:
        _, _, out = _port_step(sgcls_step, d)
        assert float((out.obj_dists.detach() - t_(jout.obj_dists)).abs().max()) > 1e-3


def test_tools_run_vctree(tmp_path):
    """Both relation tools' ``main`` with ``VCTreePredictor`` in PredCls on
    the CPU: one train step (``binary_loss`` among its losses), then the
    test tool restoring that checkpoint."""
    from torch_port_legacy_case import TOOL_OPTS
    from veto_tpu_torch.tools import relation_test_net, relation_train_net

    opts = TOOL_OPTS + [f"output_dir={tmp_path}", "relation.predictor=VCTreePredictor"]
    history = relation_train_net.main(["--config", "configs/veto_vg_predcls.yaml",
                                       "--device", "cpu", *opts])
    assert np.isfinite(history[0]["loss"]) and history[0]["binary_loss"] > 0
    agg = relation_test_net.main(["--config", "configs/veto_vg_predcls.yaml",
                                  "--device", "cpu", "--max-batches", "1", *opts])
    assert all(0.0 <= r <= 1.0 for r in agg["R"].values())
