"""The relation tools' output keys that the port does not serve yet, the
one it serves since data-parallel training came, and the test tool's
``evaluation_res.txt``.

- ``test.save_plots`` and ``test.save_visual_info``: each makes both tools
  (``relation_train_net.train`` and ``relation_test_net.evaluate``) raise
  ``NotImplementedError`` naming the slice that serves it, before any
  model is built.
- ``global_buffer_on`` is served by both: the train tool pickles each
  step's relness diagnostics of a ``rel_aware`` BGNN to
  ``inter_data_buffer.pkl``; the test tool's eval step returns none (as
  the JAX tool's), so it writes no buffer.
- ``relation_test_net.evaluate`` writes the evaluator's summary to
  ``output_dir/evaluation_res.txt``, as ``tools/relation_test_net.py``
  does: the text equals the JAX evaluator's ``summary_string()`` and a
  newline, the JAX evaluator fed every image the port's was fed.
"""

import os

import pytest

from veto_tpu.evaluation.sgg_eval import SGGEvaluator as JEvaluator

from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.config import load_config
from veto_tpu_torch.tools import relation_test_net
from veto_tpu_torch.tools.relation_train_net import UNSERVED_OUTPUTS, train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_EVAL = ["model.stage_blocks=(1,1,1,1)", "veto.t_input_dim=96",
              "veto.enc_layers=2", "data.max_boxes=8", "data.min_size_test=64",
              "data.max_size_test=96", "relation.max_proposal_pairs=48",
              "test.ims_per_batch=2"]
SLICES = {"test.save_plots": "A14 item 9", "test.save_visual_info": "A14 item 9"}


def _cfg(opts):
    return load_config(os.path.join(REPO, "configs", "veto_vg_predcls.yaml"),
                       list(opts))


@pytest.mark.parametrize("tool", ("train", "evaluate"))
@pytest.mark.parametrize("key", sorted(SLICES))
def test_unserved_output_keys_raise_in_both_tools(tmp_path, key, tool):
    """The key set raises in the tool, naming its slice, before a model is
    built (``device="no-such-device"`` would fail any build)."""
    assert {k for k, _ in UNSERVED_OUTPUTS} == set(SLICES)
    cfg = _cfg([f"{key}=True", f"output_dir={tmp_path}"])
    run = train if tool == "train" else relation_test_net.evaluate
    with pytest.raises(NotImplementedError, match=SLICES[key]) as err:
        run(cfg, "no-such-device", log=lambda s: None)
    assert key in str(err.value)


@pytest.mark.parametrize("tool", ("train", "evaluate"))
def test_global_buffer_on_is_served_in_both_tools(tmp_path, tool):
    """``global_buffer_on`` runs in both tools: training a ``rel_aware``
    BGNN for 2 steps pickles both keys, one entry a step, each a column of
    the valid pairs' rows; evaluating writes no buffer."""
    import pickle

    from torch_port_legacy_case import TOOL_OPTS

    from veto_tpu_torch.utils import global_buffer

    cfg = _cfg(TOOL_OPTS + ["relation.predictor=BGNNPredictor", "relation.rel_aware=True",
                            "relation.mp_valid_pairs=8", "global_buffer_on=True",
                            "solver.max_iter=2", f"output_dir={tmp_path}"])
    path = tmp_path / "inter_data_buffer.pkl"
    try:
        if tool == "train":
            train(cfg, "cpu", log=lambda s: None)
            with open(path, "rb") as f:
                data = pickle.load(f)
            assert set(data) == {"rel_pn-train_y", "rel_pn-train_pred"}
            assert [len(e) for e in data["rel_pn-train_y"]] == [
                len(e) for e in data["rel_pn-train_pred"]]
            assert len(data["rel_pn-train_y"]) == 2
            assert all(e.ndim == 2 and e.shape[1] == 1 and len(e) > 0
                       for e in data["rel_pn-train_pred"])
        else:
            relation_test_net.evaluate(cfg, "cpu", max_batches=1, log=lambda s: None)
            assert (tmp_path / "evaluation_res.txt").exists() and not path.exists()
    finally:
        global_buffer.reset()


def test_evaluate_writes_evaluation_res_like_the_jax_tool(tmp_path, monkeypatch):
    """One CPU eval batch of the toy PredCls model: ``evaluation_res.txt``
    holds the summary and a newline, and that text equals the JAX
    evaluator's on the same images and predictions."""
    mirrors = []
    make = relation_test_net.make_sgg_evaluator

    def mirrored(cfg, train_ds=None, eval_ds=None):
        ev = make(cfg, train_ds, eval_ds)
        jev = JEvaluator(mode=ev.mode, num_rel_classes=ev.num_rel,
                         iou_thres=ev.iou_thres, zeroshot_triplets=ev.zeroshot_triplets,
                         longtail_parts=ev.longtail_parts)
        add = ev.add_image

        def add_both(*args, **kw):
            add(*args, **kw)
            jev.add_image(*args, **kw)

        ev.add_image = add_both
        mirrors.append(jev)
        return ev

    monkeypatch.setattr(relation_test_net, "make_sgg_evaluator", mirrored)
    cfg = _cfg(SMALL_EVAL + [f"output_dir={tmp_path}"])
    lines = []
    relation_test_net.evaluate(cfg, "cpu", max_batches=1, log=lines.append)
    with open(tmp_path / "evaluation_res.txt") as f:
        text = f.read()
    assert len(mirrors) == 1 and mirrors[0].num_images > 0
    assert text == mirrors[0].summary_string() + "\n"
    assert text.startswith("SGG eval (predcls, ") and "R@100" in text
    assert lines[-1] + "\n" == text
