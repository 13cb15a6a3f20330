"""Config keys that change the computation and that the port does not yet
carry out raise ``NotImplementedError`` instead of being ignored, on the
CPU; the shipped defaults still build, train and evaluate.

- ``model.pretrained_detector_ckpt``: the JAX train tool imports the
  detector from it; the port's ``train`` refuses it (slice A8a).
- ``model.attribute_on`` / ``mask_on`` / ``keypoint_on``: the JAX
  ``build_model`` builds those heads; the port's refuses them (A14).
- ``test.zeroshot_file`` with ``test.zeroshot_eval``: the JAX evaluator
  loads the triplets from it; the port's refuses it (A8b).
- A non-empty ``output_dir/ckpt``: the JAX test tool restores it; the
  port's ``evaluate`` refuses to evaluate seeded weights in its place (A8c).
"""

import os

import pytest

from veto_tpu_torch.config import load_config
from veto_tpu_torch.models.sgg import build_model
from veto_tpu_torch.tools.relation_test_net import evaluate, make_sgg_evaluator
from veto_tpu_torch.tools.relation_train_net import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["model.stage_blocks=(1,1,1,1)", "veto.t_input_dim=96",
         "veto.enc_layers=2", "data.max_boxes=8"]
SMALL_TRAIN = SMALL + ["data.min_size_train=64", "data.max_size_train=96",
                       "relation.batch_size_per_image=16",
                       "solver.ims_per_batch=2", "solver.max_iter=1"]
SMALL_EVAL = SMALL + ["data.min_size_test=64", "data.max_size_test=96",
                      "relation.max_proposal_pairs=48", "test.ims_per_batch=2"]


def _cfg(opts):
    return load_config(os.path.join(REPO, "configs", "veto_vg_predcls.yaml"),
                       list(opts))


def test_train_refuses_a_detector_checkpoint(tmp_path):
    ckpt = tmp_path / "model_final.pth"
    ckpt.write_bytes(b"")
    cfg = _cfg(SMALL_TRAIN + [f"model.pretrained_detector_ckpt={ckpt}"])
    with pytest.raises(NotImplementedError, match="A8a"):
        train(cfg, "cpu", log=lambda s: None)


@pytest.mark.parametrize("key", ("attribute_on", "mask_on", "keypoint_on"))
def test_build_model_refuses_the_heads_it_does_not_build(key):
    with pytest.raises(NotImplementedError, match=f"model.{key}.*A14"):
        build_model(_cfg(SMALL + [f"model.{key}=True"]), "cpu")


def test_evaluator_refuses_a_zeroshot_file(tmp_path):
    path = tmp_path / "zeroshot_triplet.pytorch"
    path.write_bytes(b"")
    cfg = _cfg(SMALL_EVAL + ["test.zeroshot_eval=True",
                             f"test.zeroshot_file={path}"])
    with pytest.raises(NotImplementedError, match="A8b"):
        make_sgg_evaluator(cfg)
    # without zero-shot recall the file is not read, as in the JAX tool
    make_sgg_evaluator(_cfg(SMALL_EVAL + ["test.zeroshot_eval=False",
                                          f"test.zeroshot_file={path}"]))


def test_evaluate_refuses_a_checkpoint_it_cannot_restore(tmp_path):
    (tmp_path / "ckpt" / "100").mkdir(parents=True)
    (tmp_path / "ckpt" / "100" / "state").write_bytes(b"")
    cfg = _cfg(SMALL_EVAL + [f"output_dir={tmp_path}"])
    with pytest.raises(NotImplementedError, match="A8c"):
        evaluate(cfg, "cpu", max_batches=1, log=lambda s: None)


def test_defaults_still_build_train_and_evaluate(tmp_path):
    """The shipped defaults (zero-shot recall on with no file, no detector
    checkpoint, no heads, an ``output_dir`` with no ``ckpt``) run as
    before; an empty ``ckpt`` directory holds nothing to restore."""
    cfg = _cfg(SMALL_TRAIN)
    assert cfg.test.zeroshot_eval and not cfg.test.zeroshot_file
    assert not cfg.model.pretrained_detector_ckpt
    _, history = train(cfg, "cpu", log=lambda s: None)
    assert len(history) == 1 and history[0]["loss"] > 0
    (tmp_path / "ckpt").mkdir()
    for out in (None, str(tmp_path)):
        cfg = _cfg(SMALL_EVAL + ([f"output_dir={out}"] if out else []))
        agg, seconds = evaluate(cfg, "cpu", max_batches=1, log=lambda s: None)
        assert len(seconds) == 1 and set(agg) >= {"R", "mR"}
