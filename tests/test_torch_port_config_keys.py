"""Config keys that change the computation: the port carries them out, and
refuses what it cannot honour instead of ignoring it, on the CPU; the
shipped defaults still build, train and evaluate.

- ``model.pretrained_detector_ckpt``: ``train`` imports the detector from
  it (slice A8a) and refuses a file that is not a checkpoint.
- ``model.attribute_on`` / ``mask_on`` / ``keypoint_on``: the port builds
  those heads, as the JAX ``build_model`` does (A13b; refused before).
- ``test.zeroshot_file`` with ``test.zeroshot_eval``: the evaluator loads
  the triplets from it (A8b) and refuses a file that holds none.
- ``output_dir/ckpt``: ``evaluate`` restores the latest checkpoint there
  (A8c) and refuses a directory it cannot restore, rather than evaluating
  seeded weights in its place.
- ``relation.use_gt_object_label`` false: the SGCls configs build, train
  and evaluate (A9); ``relation.use_gt_box`` false: the SGDet configs
  build, train and evaluate (A10), and ``relation.require_box_overlap`` and
  ``test.relation_require_overlap`` reach the SGDet pair sampler and test
  pairs; ``ensemble.enabled`` builds MEET's predictor (A11), a
  ``VETOPredictor_MEET`` name without it the plain VETO one, the four
  ported legacy ``*_MEET`` predictors their MEET heads, one without MEET
  heads (BGNN, KERN) raises ``ValueError`` with ``ensemble.enabled``;
  ``model.box_pooler_resolution`` and ``model.box_mlp_head_dim`` shape the
  SGCls box head.
"""

import os

import numpy as np
import pytest

from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

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


def _cfg(opts, config="veto_vg_predcls.yaml"):
    return load_config(os.path.join(REPO, "configs", config), list(opts))


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
    """Since slice A13b the port builds all three heads (the attribute head
    over a frozen box head, ``att_score`` trained; the mask and keypoint
    heads trained), at the widths their keys give; none is refused."""
    extra = {"attribute_on": ["model.num_attributes=13"],
             "mask_on": ["model.mask_conv_layers=(16,8)"],
             "keypoint_on": ["model.num_keypoints=5"]}[key]
    model = build_model(_cfg(SMALL + [f"model.{key}=True", "model.box_mlp_head_dim=16",
                                      *extra]), "cpu")
    if key == "attribute_on":
        assert model.attribute_predictor.att_score.weight.shape == (13, 16)
        assert model.attribute_predictor.att_score.weight.requires_grad
        assert not model.box_extractor.fc6.weight.requires_grad
    elif key == "mask_on":
        assert model.mask_extractor.mask_fcn2.weight.shape == (8, 16, 3, 3)
        assert model.mask_predictor.conv5_mask.weight.shape == (8, 8, 2, 2)
        assert model.mask_predictor.mask_fcn_logits.weight.shape[0] == 151
    else:
        assert model.keypoint_predictor.kps_score_lowres.weight.shape == (512, 5, 4, 4)


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


@pytest.mark.parametrize("config", ("veto_vg_sgcls.yaml", "gqa_sgcls.yaml"))
def test_sgcls_configs_train_and_evaluate(tmp_path, config):
    """One CPU train step and one eval batch of each shipped SGCls config at
    toy widths: the object loss is logged (``metrics.jsonl`` too) and the
    box head stays as it was."""
    import json

    import torch

    out = tmp_path / "out"
    cfg = _cfg(SMALL_TRAIN + SMALL_EVAL[len(SMALL):] + [
        "model.box_mlp_head_dim=32", f"output_dir={out}"], config)
    assert cfg.relation.mode == "sgcls"
    model = build_model(cfg, "cpu")
    head = {k: v.clone() for k, v in model.state_dict().items()
            if k.startswith("box_")}
    assert head["box_predictor.cls_score.weight"].shape == (
        cfg.model.num_obj_classes, 32)
    from veto_tpu_torch.engine.train import create_train_state

    with pytest.raises(ValueError, match="built for 'sgcls'"):
        create_train_state(model, cfg.solver)  # the default mode, predcls
    state, history = train(cfg, "cpu", log=lambda s: None, model=model)
    assert len(history) == 1 and history[0]["obj_loss"] > 0
    np.testing.assert_allclose(history[0]["loss"], history[0]["rel_loss"]
                               + history[0]["obj_loss"], rtol=1e-6)
    for k, v in head.items():
        assert torch.equal(state.model.state_dict()[k], v), k
    with open(out / "metrics.jsonl") as f:
        assert "obj_loss" in json.loads(f.readline())
    agg, seconds = evaluate(cfg, "cpu", max_batches=1, log=lambda s: None,
                            model=state.model)
    assert len(seconds) == 1 and all(np.isfinite(v) for v in agg["R"].values())


def test_sgdet_and_meet_still_raise():
    """SGDet builds (the RPN head and the box head, frozen), and so does
    MEET: ``ensemble.enabled`` builds ``MeetPredictor`` (SGCls here: its
    trunk embeds the hard labels), ``VETOPredictor_MEET`` without it the
    plain VETO predictor, as the JAX tool resolves the name; a legacy
    ``*_MEET`` predictor of the ported four builds its MEET heads, and one
    without MEET heads (BGNN, KERN) raises ``ValueError`` under
    ``ensemble.enabled``."""
    from veto_tpu_torch.models.relation.predictor_meet import MeetPredictor
    from veto_tpu_torch.models.relation.predictor_veto import VetoPredictor

    model = build_model(_cfg(SMALL + ["relation.use_gt_box=False",
                                      "model.box_mlp_head_dim=16"],
                             "veto_vg_sgcls.yaml"), "cpu")
    assert model.mode == "sgdet"
    assert model.rpn.cls_logits.weight.shape == (4, 256, 1, 1)
    assert not any(p.requires_grad for n, p in model.named_parameters()
                   if n.startswith(("rpn.", "box_")))
    meet = build_model(_cfg(SMALL + ["ensemble.enabled=True",
                                     "model.box_mlp_head_dim=16"],
                            "veto_vg_sgcls.yaml"), "cpu").relation
    assert isinstance(meet, MeetPredictor) and meet.trunk.hard_label_embed
    assert meet.rel_out_e0_g4.weight.shape == (12 + 2, 96)
    plain = build_model(_cfg(SMALL + ["relation.predictor=VETOPredictor_MEET"]),
                        "cpu").relation
    assert isinstance(plain, VetoPredictor) and not plain.trunk.hard_label_embed
    motifs = build_model(_cfg(SMALL + ["relation.predictor=MotifPredictor_MEET",
                                       "ensemble.enabled=True",
                                       "relation.context_hidden_dim=16",
                                       "relation.context_pooling_dim=32"]),
                         "cpu").relation
    assert motifs.meet_heads.rel_out_e0_g4.weight.shape == (12 + 2, 32)
    with pytest.raises(ValueError, match="no MEET heads"):
        build_model(_cfg(SMALL + ["relation.predictor=KERNPredictor_MEET",
                                  "ensemble.enabled=True"]), "cpu")
    with pytest.raises(ValueError, match="no MEET heads"):
        build_model(_cfg(SMALL + ["relation.predictor=BGNNPredictor_MEET",
                                  "ensemble.enabled=True"]), "cpu")


def test_box_head_keys_change_the_model():
    """``model.box_pooler_resolution`` is the box pool's P (fc6 eats P x P x
    256) and ``model.box_mlp_head_dim`` the fc6/fc7 width; a forward runs
    at both."""
    import torch

    from veto_tpu_torch.data.synthetic import SyntheticSGGDataset

    cfg = _cfg(SMALL + ["model.box_pooler_resolution=5",
                        "model.box_mlp_head_dim=24"], "veto_vg_sgcls.yaml")
    model = build_model(cfg, "cpu")
    assert model.box_extractor.fc6.weight.shape == (24, 5 * 5 * 256)
    assert model.box_extractor.fc7.weight.shape == (24, 24)
    ds = SyntheticSGGDataset(num_images=1, image_size=(64, 96),
                             num_obj_classes=cfg.model.num_obj_classes,
                             max_objects=4, seed=0)
    batch, _ = next(ds.batches(1, 8))
    b = batch.to("cpu")
    with torch.no_grad():
        feats = model.extract_features(b.images)
        assert model._pool_boxes(feats, b.boxes, 5).shape == (1, 8, 5, 5, 256)
        logits = model._box_logits(feats, b.boxes)
    assert logits.shape == (1, 8, cfg.model.num_obj_classes)
    assert torch.isfinite(logits).all()


# detections at seeded weights need a threshold under 1 / num_obj_classes
SGDET_TOY = ["model.box_mlp_head_dim=32", "model.rpn_pre_nms_top_n_test=200",
             "model.rpn_post_nms_top_n_test=50", "model.box_detections_per_img=8",
             "model.box_score_thresh=0.002"]


@pytest.mark.parametrize("config", ("veto_vg_sgdet.yaml", "gqa_sgdet.yaml"))
def test_sgdet_configs_train_and_evaluate(tmp_path, config):
    """One CPU train step and one eval batch of each shipped SGDet config at
    toy widths, through both tools: the object loss is logged, the
    detector, RPN and box head stay as they were, the evaluation reports
    R@K and the detections' COCO mAP, and ``relation_test_net.main``
    writes its results."""
    import json

    import torch

    from veto_tpu_torch.tools import relation_test_net

    out = tmp_path / "out"
    opts = SMALL_TRAIN + SMALL_EVAL[len(SMALL):] + SGDET_TOY + [f"output_dir={out}"]
    cfg = _cfg(opts, config)
    assert cfg.relation.mode == "sgdet"
    model = build_model(cfg, "cpu")
    frozen = {k: v.clone() for k, v in model.state_dict().items()
              if k.startswith(("backbone.", "rpn.", "box_"))}
    state, history = train(cfg, "cpu", log=lambda s: None, model=model)
    assert len(history) == 1 and np.isfinite(history[0]["rel_loss"])
    assert history[0]["obj_loss"] > 0
    for k, v in frozen.items():
        assert torch.equal(state.model.state_dict()[k], v), k
    logs = []
    agg, seconds = evaluate(cfg, "cpu", max_batches=1, log=logs.append,
                            model=state.model)
    assert len(seconds) == 1 and all(np.isfinite(v) for v in agg["R"].values())
    assert np.isfinite(agg["bbox"]["mAP"]) and any("detection mAP" in s for s in logs)
    relation_test_net.main(["--config", os.path.join(REPO, "configs", config),
                            "--device", "cpu", "--max-batches", "1", *opts])
    with open(out / "eval_results.json") as f:
        assert "bbox" in json.load(f)


def test_sgdet_overlap_keys_are_honoured(tmp_path, monkeypatch):
    """``relation.require_box_overlap`` reaches ``detect_relsample`` in
    training and ``test.relation_require_overlap`` reaches
    ``prepare_test_pairs`` in evaluation, each way."""
    from veto_tpu_torch.engine import evaluate as ev
    from veto_tpu_torch.engine import train as tr

    seen = []

    def spy(real, key):
        def call(*args, **kw):
            seen.append((key, kw.get("require_overlap")))
            return real(*args, **kw)
        return call

    monkeypatch.setattr(tr, "detect_relsample", spy(tr.detect_relsample, "train"))
    monkeypatch.setattr(ev, "prepare_test_pairs", spy(ev.prepare_test_pairs, "eval"))
    for flag in (True, False):
        cfg = _cfg(SMALL_TRAIN + SMALL_EVAL[len(SMALL):] + SGDET_TOY + [
            f"output_dir={tmp_path / str(flag)}", f"relation.require_box_overlap={flag}",
            f"test.relation_require_overlap={flag}"], "veto_vg_sgdet.yaml")
        state, _ = train(cfg, "cpu", log=lambda s: None)
        evaluate(cfg, "cpu", max_batches=1, log=lambda s: None, model=state.model)
        assert ("train", flag) in seen and ("eval", flag) in seen
        seen.clear()
