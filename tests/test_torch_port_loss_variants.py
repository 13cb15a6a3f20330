"""The relation loss variants (``relation.loss_variant``: label smoothing,
LDAM, the balanced norm) against the JAX package on the CPU.

- The functions of ``ops/losses.py`` against ``veto_tpu/ops/losses.py`` on
  seeded logits, labels, masks and class weights: values and gradients
  with respect to the logits 1e-6 (relative; f32, summation order only),
  the balanced norm's new running probability 1e-7 (absolute).
- One whole step of each against ``make_train_step(loss_variant=...)``:
  ``test_torch_port_loss_steps.py``.
- Both tools train the main path (VETO PredCls, toy widths) with each
  variant and evaluate from the checkpoint; the balanced norm's running
  probability is in the checkpoint, LDAM's margins in the state.
- A resumed balanced-norm run is bit-equal to the run without a save, its
  running probability included.
- The W > 1 scope refuses every variant but the weighted cross-entropy.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import veto_tpu.ops.losses as jl

from torch_port_legacy_case import NUM_REL, TINY, TOOL_OPTS, class_weights, scaled
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401
from torch_port_zoo_case import REPO, resume_matches_one_run

from veto_tpu_torch.config import SolverConfig, load_config
from veto_tpu_torch.data.predicate_stats import predicate_counts
from veto_tpu_torch.engine import distributed
from veto_tpu_torch.engine.train import LOSS_VARIANTS, create_train_state
from veto_tpu_torch.models.sgg import SGGModel
from veto_tpu_torch.ops import losses as tl
from veto_tpu_torch.tools.relation_test_net import evaluate
from veto_tpu_torch.tools.relation_train_net import train
from veto_tpu_torch.utils.checkpoint import CheckpointManager

VARIANTS = ("label_smoothing", "ldam", "balanced_norm")


def _case(seed=0, c=NUM_REL):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(3, 20, c) * 3).astype(np.float32)
    labels = rng.randint(0, c, (3, 20)).astype(np.int32)
    mask = rng.rand(3, 20) < 0.8
    running = rng.uniform(0.01, 0.5, c).astype(np.float32)
    running[0] = 1.0
    return logits, labels, mask, running, class_weights(c)


def _both(jfn, tfn, logits):
    """``jfn`` / ``tfn`` of the logits and their gradients (of the sum)."""
    jv, jg = jax.value_and_grad(lambda z: jnp.sum(jfn(z)))(jnp.asarray(logits))
    z = torch.tensor(logits, requires_grad=True)
    tv = tfn(z).sum()
    tv.backward()
    return (float(tv.detach()), z.grad.numpy()), (float(jv), np.asarray(jg))


@pytest.mark.parametrize("weighted", (False, True))
def test_loss_functions_match_jax(weighted):
    logits, labels, mask, running, cw = _case()
    cw = cw if weighted else None
    t_cw = None if cw is None else torch.from_numpy(cw)
    m = jl.ldam_margins(predicate_counts("VG")[:NUM_REL], 0.5)
    np.testing.assert_array_equal(tl.ldam_margins(predicate_counts("VG")[:NUM_REL], 0.5), m)
    tl_, tm, tr = torch.from_numpy(labels), torch.from_numpy(mask), torch.from_numpy(running)
    cases = {
        "label_smoothing": (
            lambda z: jl.label_smoothing_ce(z, jnp.where(mask, labels, 0), mask=mask),
            lambda z: tl.label_smoothing_ce(z, torch.where(tm, tl_, 0), mask=tm)),
        "ldam": (lambda z: jl.ldam_loss(z, labels, mask, jnp.asarray(m), class_weights=cw),
                 lambda z: tl.ldam_loss(z, tl_, tm, torch.from_numpy(m), class_weights=t_cw)),
        "balanced_norm": (
            lambda z: jl.balanced_norm_nll(jl.balanced_norm_probs(
                z, labels, mask, running, train=True)[0], labels, mask, cw),
            lambda z: tl.balanced_norm_nll(tl.balanced_norm_probs(
                z, tl_, tm, tr, train=True)[0], tl_, tm, t_cw)),
    }
    for name, (jfn, tfn) in cases.items():
        (tv, tg), (jv, jg) = _both(jfn, tfn, logits)
        np.testing.assert_allclose(tv, jv, rtol=1e-6, err_msg=name)
        scaled(tg, jg, 1e-6, f"{name} gradient")
    for train in (False, True):
        for normalized in (False, True):
            jp, jn = jl.balanced_norm_probs(jnp.asarray(logits), labels, mask, running,
                                            train=train, normalized_probs=normalized)
            tp, tn = tl.balanced_norm_probs(torch.from_numpy(logits), tl_, tm, tr,
                                            train=train, normalized_probs=normalized)
            scaled(tp, np.asarray(jp), 1e-6, f"balanced probs {train} {normalized}")
            np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0, atol=1e-7)
    # LearnableBalancedNorm at a theta the test draws
    theta = np.random.RandomState(1).randn(NUM_REL - 1).astype(np.float32)
    for normalized in (False, True):
        ref = jl.LearnableBalancedNorm(NUM_REL - 1, normalized_probs=normalized).apply(
            {"params": {"labeling_prob_theta": jnp.asarray(theta)}}, jnp.asarray(logits))
        mod = tl.LearnableBalancedNorm(NUM_REL - 1, normalized_probs=normalized)
        mod.load_state_dict({"labeling_prob_theta": torch.from_numpy(theta)})
        scaled(mod(torch.from_numpy(logits)).detach(), np.asarray(ref), 1e-6,
               f"learnable balanced norm {normalized}")


def _solver(cls):
    return cls(ims_per_batch=2, base_lr=1e-3, bias_lr_factor=2.0, weight_decay=0.3,
               weight_decay_bias=0.05, grad_clip_norm=5.0)


def test_balanced_norm_resume_is_bit_equal(tmp_path):
    opts = TOOL_OPTS + ["relation.predictor=NaivePredictor", "solver.val_period=100",
                        "relation.loss_variant=balanced_norm"]
    resumed, payload = resume_matches_one_run(
        tmp_path, os.path.join(REPO, "configs", "veto_vg_predcls.yaml"), opts)
    assert resumed.loss_variant == "balanced_norm"
    assert torch.equal(payload["loss_state"], resumed.loss_state)
    assert float(resumed.loss_state[1:].sub(0.03).abs().max()) > 0


def test_create_train_state_checks_the_variant():
    model = SGGModel(mode="predcls", predictor="NaivePredictor", num_rel_classes=NUM_REL,
                     **TINY, dtype=torch.float32)
    with pytest.raises(ValueError, match="loss variant"):
        create_train_state(model, _solver(SolverConfig), loss_variant="focal")
    with pytest.raises(ValueError, match="ldam_margins"):
        create_train_state(model, _solver(SolverConfig), loss_variant="ldam")
    assert set(LOSS_VARIANTS) == {"weighted_ce", *VARIANTS}


@pytest.mark.parametrize("opt", [f"relation.loss_variant={v}" for v in VARIANTS]
                         + ["relation.label_smoothing=True"])
def test_scope_refuses_the_loss_variants_on_several_ranks(opt):
    """Their denominators and the balanced norm's running state have no
    two-rank test: two ranks refuse them (naming A12b), one runs them."""
    cfg = load_config(os.path.join(REPO, "configs", "veto_vg_predcls.yaml"), [opt])
    distributed.check_scope(cfg, 1)
    with pytest.raises(NotImplementedError, match="A12b"):
        distributed.check_scope(cfg, 2)


@pytest.mark.parametrize("variant", VARIANTS)
def test_both_tools_train_each_loss_variant(tmp_path, variant):
    """The train tool's two steps of the main path (VETO PredCls, toy widths)
    with the variant, then the test tool on its checkpoint."""
    cfg = load_config(os.path.join(REPO, "configs", "veto_vg_predcls.yaml"),
                      TOOL_OPTS + ["veto.t_input_dim=96", "veto.enc_layers=2",
                                   f"relation.loss_variant={variant}",
                                   f"output_dir={tmp_path}", "solver.max_iter=2",
                                   "solver.val_period=100"])
    state, history = train(cfg, "cpu", log=lambda s: None)
    assert state.loss_variant == variant and len(history) == 2
    assert all(np.isfinite(r["rel_loss"]) for r in history)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.latest_step() == 2
    if variant == "balanced_norm":
        saved = ckpt.load()["loss_state"]
        assert torch.equal(saved, state.loss_state) and float(saved[0]) == 1.0
    if variant == "ldam":
        assert state.ldam_margins.shape == (51,) and float(state.ldam_margins.max()) == 0.5
    agg, seconds = evaluate(cfg, "cpu", max_batches=1, log=lambda s: None)
    assert len(seconds) == 1 and all(np.isfinite(v) for v in agg["R"].values())
    assert os.path.exists(tmp_path / "evaluation_res.txt")
