"""Config keys that change the computation: the port carries them out, and
refuses what it cannot honour instead of ignoring it, on the CPU; the
shipped defaults still build, train and evaluate.

- ``model.pretrained_detector_ckpt``: ``train`` imports the detector from
  it (slice A8a) and refuses a file that is not a checkpoint.
- ``model.attribute_on`` / ``mask_on`` / ``keypoint_on``: the JAX
  ``build_model`` builds those heads; the port's refuses them (A14).
- ``test.zeroshot_file`` with ``test.zeroshot_eval``: the evaluator loads
  the triplets from it (A8b) and refuses a file that holds none.
- ``output_dir/ckpt``: ``evaluate`` restores the latest checkpoint there
  (A8c) and refuses a directory it cannot restore, rather than evaluating
  seeded weights in its place.
"""

import os

import numpy as np
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
    """An empty file is refused; a reference-format one is imported into
    the frozen detector (its stem here, folded: ``model.fold_bn``)."""
    import torch

    ckpt = tmp_path / "model_final.pth"
    ckpt.write_bytes(b"")
    opts = SMALL_TRAIN + [f"output_dir={tmp_path / 'out'}"]
    with pytest.raises(EOFError):
        train(_cfg(opts + [f"model.pretrained_detector_ckpt={ckpt}"]), "cpu",
              log=lambda s: None)
    g = torch.Generator().manual_seed(0)
    ref = {"backbone.body.stem.conv1.weight": torch.randn(64, 3, 7, 7, generator=g),
           "backbone.body.stem.bn1.weight": torch.rand(64, generator=g) + 0.5,
           "backbone.body.stem.bn1.bias": torch.randn(64, generator=g),
           "backbone.body.stem.bn1.running_mean": torch.randn(64, generator=g),
           "backbone.body.stem.bn1.running_var": torch.rand(64, generator=g) + 0.5}
    torch.save({"model": ref}, ckpt)
    lines = []
    state, history = train(_cfg(opts + [f"model.pretrained_detector_ckpt={ckpt}"]),
                           "cpu", log=lines.append)
    assert len(history) == 1
    assert any("torch import: 2 tensors loaded" in x for x in lines)
    # the reference's fold in numpy's arithmetic, as the JAX import does it
    # (torch's CPU sqrt is not always correctly rounded)
    r = {k.rsplit(".", 1)[-1] if "bn1" in k else "conv": v.numpy()
         for k, v in ref.items()}
    scale = r["weight"] / np.sqrt(r["running_var"])
    stem = state.model.backbone.body.stem_conv
    np.testing.assert_array_equal(stem.weight.detach().numpy(),
                                  r["conv"] * scale[:, None, None, None])
    np.testing.assert_array_equal(stem.bias.detach().numpy(),
                                  r["bias"] - r["running_mean"] * scale)


@pytest.mark.parametrize("key", ("attribute_on", "mask_on", "keypoint_on"))
def test_build_model_refuses_the_heads_it_does_not_build(key):
    with pytest.raises(NotImplementedError, match=f"model.{key}.*A14"):
        build_model(_cfg(SMALL + [f"model.{key}=True"]), "cpu")


def test_evaluator_refuses_a_zeroshot_file(tmp_path):
    """A file that holds no triplets is refused; a reference
    ``zeroshot_triplet.pytorch`` is loaded into the evaluator."""
    import torch

    path = tmp_path / "zeroshot_triplet.pytorch"
    path.write_bytes(b"")
    cfg = _cfg(SMALL_EVAL + ["test.zeroshot_eval=True",
                             f"test.zeroshot_file={path}"])
    with pytest.raises(EOFError):
        make_sgg_evaluator(cfg)
    # without zero-shot recall the file is not read, as in the JAX tool
    assert make_sgg_evaluator(_cfg(SMALL_EVAL + [
        "test.zeroshot_eval=False", f"test.zeroshot_file={path}"])
                              ).zeroshot_triplets is None
    triplets = torch.tensor([[3, 7, 1], [5, 2, 20]])
    torch.save(triplets, path)
    got = make_sgg_evaluator(cfg).zeroshot_triplets
    assert got.dtype.name == "int64" and (got == triplets.numpy()).all()


def test_evaluate_refuses_a_checkpoint_it_cannot_restore(tmp_path):
    """A ``ckpt`` directory without a checkpoint of the port (the JAX
    package's orbax steps) and a checkpoint of another model are refused;
    the port's own checkpoint is restored and evaluated."""
    from veto_tpu_torch.engine.train import create_train_state
    from veto_tpu_torch.utils.checkpoint import CheckpointManager

    (tmp_path / "ckpt" / "100").mkdir(parents=True)
    (tmp_path / "ckpt" / "100" / "state").write_bytes(b"")
    cfg = _cfg(SMALL_EVAL + [f"output_dir={tmp_path}"])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        evaluate(cfg, "cpu", max_batches=1, log=lambda s: None)
    (tmp_path / "ckpt" / "100" / "state").unlink()
    (tmp_path / "ckpt" / "100").rmdir()
    ckpt = CheckpointManager(tmp_path / "ckpt")
    other = build_model(_cfg(SMALL_EVAL + ["veto.t_input_dim=48"]), "cpu")
    ckpt.save(7, create_train_state(other, cfg.solver))
    with pytest.raises(RuntimeError, match="size mismatch"):
        evaluate(cfg, "cpu", max_batches=1, log=lambda s: None)
    model = build_model(cfg, "cpu", seed=5)
    ckpt.save(8, create_train_state(model, cfg.solver))
    lines = []
    agg, _ = evaluate(cfg, "cpu", max_batches=1, log=lines.append)
    assert "evaluating the checkpoint of step 8" in lines
    ref, _ = evaluate(cfg, "cpu", max_batches=1, log=lambda s: None,
                      model=model)
    assert agg["R"] == ref["R"] and agg["mR"] == ref["mR"]


def test_defaults_still_build_train_and_evaluate(tmp_path):
    """The shipped defaults (zero-shot recall on with no file, no detector
    checkpoint, no heads, an ``output_dir`` with no ``ckpt``) run as
    before; an empty ``ckpt`` directory holds nothing to restore."""
    cfg = _cfg(SMALL_TRAIN + [f"output_dir={tmp_path / 'train'}"])
    assert cfg.test.zeroshot_eval and not cfg.test.zeroshot_file
    assert not cfg.model.pretrained_detector_ckpt
    _, history = train(cfg, "cpu", log=lambda s: None)
    assert len(history) == 1 and history[0]["loss"] > 0
    (tmp_path / "ckpt").mkdir()
    for out in (None, str(tmp_path)):
        cfg = _cfg(SMALL_EVAL + ([f"output_dir={out}"] if out else []))
        agg, seconds = evaluate(cfg, "cpu", max_batches=1, log=lambda s: None)
        assert len(seconds) == 1 and set(agg) >= {"R", "mR"}
