"""The causal-analysis predictor in training, against the JAX package on the
CPU (``torch_port_legacy_case``'s case, f32), and its checkpoint.

- A ``TDE`` train step in SGCls (the decoder runs, so every untreated
  average moves): the losses 1e-5, every trainable gradient within 1e-4 of
  its tensor's largest |g|, the untreated averages and the BatchNorms'
  statistics after the step 1e-6 against the JAX step's ``batch_stats``.
  The Motifs context's LSTMs keep the JAX side in f32, so, as for Motifs,
  the union extractor's gradients and statistics are left out (flax's f32
  BatchNorm sums, ``torch_port_legacy_case.UNION``) and the train-mode
  outputs are held to ``OUT_TOL``.
- Resume: k steps, a checkpoint, a restored state and k more steps are
  bit-equal to 2k steps in one run, the untreated averages included (they
  are buffers of the model's ``state_dict``).
"""

import os

import numpy as np
import torch

from torch_port_legacy_case import (
    TOOL_OPTS, check_train_step, class_weights, init_method, jax_train, jax_variables,
    make_inputs, relate_args, solver, train_samples,
)
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401
from torch_port_zoo_case import (
    REPO, causal_jax_model, causal_port_model, resume_matches_one_run,
)

from veto_tpu_torch.engine.train import create_train_state


def test_causal_tde_train_step_matches_jax():
    x = make_inputs()
    s = train_samples(x)
    cw = class_weights()
    jm = causal_jax_model("sgcls", "TDE", "gate")
    v = jax_variables(jm, relate_args(x), method=init_method("sgcls"), seed=3)
    ref = jax_train(jm, v, x, s, "sgcls", cw, box_head=True)
    model = causal_port_model("sgcls", "TDE", "gate", v)
    before = {n: b.clone() for n, b in model.named_buffers() if "untreated" in n}
    state = create_train_state(model, solver(), cw, mode="sgcls")
    got = check_train_step(model, state, x, s, ref, "causal TDE sgcls train")
    assert all(np.isfinite(float(t)) for t in got.values())
    after = dict(model.named_buffers())
    assert {n.rsplit(".", 1)[-1] for n in before} == {
        "untreated_dcd_feat", "untreated_spt", "untreated_feat"}
    for n, b in before.items():
        assert not torch.equal(after[n], b), n  # every average moved


CAUSAL_OPTS = TOOL_OPTS + ["relation.predictor=CausalAnalysisPredictor",
                           "relation.causal_effect_type=TDE",
                           "relation.causal_fusion_type=gate", "solver.val_period=100"]


def test_causal_tde_resume_is_bit_equal(tmp_path):
    resumed, payload = resume_matches_one_run(
        tmp_path, os.path.join(REPO, "configs", "veto_vg_sgcls.yaml"), CAUSAL_OPTS)
    buf = "relation.context_layer.untreated_dcd_feat"
    assert buf in payload["model"]
    assert float(resumed.model.state_dict()[buf].abs().max()) > 0
