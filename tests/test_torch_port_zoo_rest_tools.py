"""Both relation tools on the rest of the zoo, on the CPU at toy widths
(``torch_port_legacy_case.TOOL_OPTS``; SGDet with 11 object classes so that
the seeded detector finds boxes; AGRCNN's graph 32 wide,
``torch_port_zoo_case.narrow_agrcnn``): each of the causal predictor (``TDE``,
``gate``), KERN, AGRCNN, Naive and RelatednessTest in PredCls, SGCls and
SGDet (the loss variants' runs: ``test_torch_port_loss_variants.py``).  The
train tool takes its steps and saves, the test tool restores the
checkpoint (no model handed over) and writes ``evaluation_res.txt``; the
losses and the recalls are finite.  With two ranks the scope still refuses the new
predictors, naming ROADMAP queue A12b.
"""

import os

import numpy as np
import pytest

from torch_port_legacy_case import TOOL_OPTS
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401
from torch_port_zoo_case import GRAPH, REPO, narrow_agrcnn

from veto_tpu_torch.config import load_config
from veto_tpu_torch.engine import distributed
from veto_tpu_torch.tools.relation_test_net import evaluate
from veto_tpu_torch.tools.relation_train_net import train
from veto_tpu_torch.utils.checkpoint import CheckpointManager

NEW = ("CausalAnalysisPredictor", "KERNPredictor", "AGRCNNPredictor", "NaivePredictor",
       "RelatednessTestPredictor")
SGDET = ["model.num_obj_classes=11", "model.box_mlp_head_dim=32",
         "model.rpn_pre_nms_top_n_test=200", "model.rpn_post_nms_top_n_test=50",
         "model.box_detections_per_img=6"]
CAUSAL = ["relation.causal_effect_type=TDE", "relation.causal_fusion_type=gate"]


@pytest.fixture(autouse=True)
def narrow_graph(monkeypatch):
    narrow_agrcnn(monkeypatch, jax_too=False)


def config(mode):
    return os.path.join(REPO, "configs", f"veto_vg_{mode}.yaml")


def _quiet(line):
    pass


def train_then_evaluate(cfg, out):
    """The train tool's steps (a checkpoint at each), then the test tool on
    its latest checkpoint: the train history and the recalls."""
    state, history = train(cfg, "cpu", log=_quiet)
    assert history and all(np.isfinite(v) for r in history for k, v in r.items()
                           if k.endswith("loss"))
    assert CheckpointManager(str(out / "ckpt")).latest_step() == state.step
    agg, seconds = evaluate(cfg, "cpu", max_batches=1, log=_quiet)
    assert len(seconds) == 1 and all(np.isfinite(v) for v in agg["R"].values())
    assert os.path.exists(out / "evaluation_res.txt")
    return state, history


@pytest.mark.parametrize("predictor", NEW)
def test_both_tools_run_the_predictor_in_every_mode(tmp_path, predictor):
    for mode in ("predcls", "sgcls", "sgdet"):
        out = tmp_path / mode
        opts = TOOL_OPTS + SGDET + [f"relation.predictor={predictor}",
                                    f"output_dir={out}", "solver.val_period=100"]
        if predictor == "CausalAnalysisPredictor":
            opts += CAUSAL
        state, history = train_then_evaluate(load_config(config(mode), opts), out)
        head = state.model.relation
        assert type(head).__name__ == predictor.replace("Analysis", "")
        if predictor == "AGRCNNPredictor":
            assert head.context_layer.obj_embedding_fc1.out_features == GRAPH
        rec = history[-1]
        assert ("obj_loss" in rec) == (mode != "predcls")
        assert ("pre_rel_classify_loss" in rec) == (
            predictor == "RelatednessTestPredictor" and mode != "sgdet")
        if predictor == "CausalAnalysisPredictor":
            assert head.effect_type == "TDE" and head.fusion_type == "gate"
            saved = CheckpointManager(str(out / "ckpt")).load()["model"]
            assert float(saved["relation.untreated_spt"].abs().max()) > 0


@pytest.mark.parametrize("predictor", NEW)
def test_two_ranks_refuse_the_new_predictors(predictor):
    cfg = load_config(config("predcls"), [f"relation.predictor={predictor}"])
    distributed.check_scope(cfg, 1)
    with pytest.raises(NotImplementedError, match="A12b"):
        distributed.check_scope(cfg, 2)
