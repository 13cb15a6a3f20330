"""The port's train and test tools on Visual-Genome-format files written into
``tmp_path``: checkpoints hold everything a resumed run needs, validation
drives the plateau controller as the JAX package's does, SIGTERM saves and
exits, the final checkpoint is restored by ``relation_test_net``.

A resumed run restarts the loader's stream at its first batch, in the JAX
package as in the port (``SGGLoader.iterations(max_iter, start_iter)``), so
"2k steps" and "k steps, save, restore, k steps" do not see the same
batches.  The completeness test therefore holds the tool's save-and-resume
against k steps followed by k more on the resumed run's own stream,
``iterations(2k, start_iter=k)`` of a fresh dataset (the readers' own
RandomState is not part of a checkpoint, in either package), in one
process with no save between.

The tests run in f32: on the CPU, PyTorch's bf16 grouped convolution with
stride 2 on the smallest maps (layer4's first block here) does not give
the same bits twice, which would hide what the checkpoint holds; and the
bit-equality test runs on one CPU thread, since PyTorch's CPU backward of
the trunk's pair gathers accumulates in thread order."""

import json
import os
import signal

import pytest
import torch

pytest.importorskip("h5py")
pytest.importorskip("PIL")

from veto_tpu.config import load_config as j_load_config
from veto_tpu.solver.optim import LRController as JController

from torch_port_vg_files import write_fake_vg
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401
from veto_tpu_torch.config import load_config
from veto_tpu_torch.engine.train import create_train_state, train_step
from veto_tpu_torch.models.sgg import build_model
from veto_tpu_torch.solver.optim import LRController
from veto_tpu_torch.tools import relation_test_net, relation_train_net
from veto_tpu_torch.tools.relation_train_net import (
    batches_for, build_dataset, rel_class_weights, train,
)
from veto_tpu_torch.utils.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "veto_vg_predcls.yaml")
SMALL = ["model.stage_blocks=(1,1,1,1)", "veto.t_input_dim=96",
         "veto.enc_layers=2", "data.max_boxes=8", "data.min_size_train=32",
         "data.max_size_train=56", "data.min_size_test=32",
         "data.max_size_test=56", "data.size_divisibility=8",
         "data.num_val_images=5", "relation.batch_size_per_image=16",
         "relation.max_proposal_pairs=48", "solver.ims_per_batch=2",
         "test.ims_per_batch=3", "dtype=float32"]


@pytest.fixture(scope="module")
def vg_dir(tmp_path_factory):
    return write_fake_vg(str(tmp_path_factory.mktemp("vg")))


def _opts(vg_dir, out, **solver):
    return SMALL + [f"data.data_dir={vg_dir}", f"output_dir={out}"] + [
        f"solver.{k}={v}" for k, v in solver.items()]


def _quiet(line):
    pass


def _same_state(a, b):
    """Model tensors (parameters and BN statistics) and Adam's state bit-equal."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.inner.state_dict(), b.optimizer.inner.state_dict()
    assert oa["state"].keys() == ob["state"].keys() and len(oa["state"]) > 0
    for i in oa["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(oa["state"][i][k], ob["state"][i][k]), (i, k)
    assert a.step == b.step


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _resume_matches_the_stream(vg_dir, tmp_path, config):
    k = 2
    # plateau_patience high: the validations do not move the LR
    opts = _opts(vg_dir, tmp_path / "a", checkpoint_period=k, val_period=1,
                 plateau_patience=100)
    first_state, first = train(load_config(config, opts + [f"solver.max_iter={k}"]),
                               "cpu", log=_quiet)
    assert len(first) == k and all("val_mR100" in r for r in first)
    resumed, second = train(load_config(config, opts + [f"solver.max_iter={2 * k}"]),
                            "cpu", log=_quiet)
    assert len(second) == k and resumed.step == 2 * k
    assert resumed.model is not first_state.model

    cfg = load_config(config, _opts(vg_dir, tmp_path / "b"))
    ref = create_train_state(build_model(cfg, "cpu"), cfg.solver,
                             rel_class_weights(cfg), mode=cfg.relation.mode)
    ref.generator = torch.Generator().manual_seed(cfg.solver.seed)
    ctrl = LRController(cfg.solver)
    for lo, hi in ((0, k), (k, 2 * k)):
        gen = batches_for(cfg, build_dataset(cfg, "train"), "train")
        for it, (batch, _) in enumerate(gen(hi, lo), start=lo):
            m = train_step(ref, batch.to("cpu"), ref.generator, ctrl.scale(it),
                           cfg.relation.batch_size_per_image,
                           cfg.relation.positive_fraction)
            rec = (first + second)[it]
            assert float(m["loss"]) == rec["loss"], it
    _same_state(resumed, ref)
    assert torch.equal(resumed.generator.get_state(), ref.generator.get_state())
    return resumed


def test_resume_is_bit_equal_to_the_same_stream_without_a_save(vg_dir, tmp_path,
                                                              one_thread):
    """k steps, a checkpoint, a fresh process state restored from it and k
    more steps equal k steps and k more on the same stream: the checkpoint
    holds the model, its BN statistics, Adam, the iteration and the
    sampler's generator.  Validation runs after every step of the tool's
    run and none of the other, so it must leave the running statistics
    alone (the model goes back to train mode after it)."""
    _resume_matches_the_stream(vg_dir, tmp_path, CONFIG)


def test_sgcls_resume_is_bit_equal_to_the_same_stream_without_a_save(
        vg_dir, tmp_path, one_thread):
    """The same for SGCls: the checkpoint carries the frozen box head too,
    and the object loss is in every step's record."""
    resumed = _resume_matches_the_stream(
        vg_dir, tmp_path, os.path.join(REPO, "configs", "veto_vg_sgcls.yaml"))
    assert any(k.startswith("box_extractor.") for k in resumed.model.state_dict())
    payload = CheckpointManager(tmp_path / "a" / "ckpt").load()
    assert {"box_extractor.fc6.weight", "box_predictor.cls_score.weight"} <= set(
        payload["model"])


def test_validation_drives_the_plateau_controller_as_in_jax(vg_dir, tmp_path):
    """Validation every step with patience 1 and no cooldown: the LR decays
    after each flat report until ``max_decay_step`` stops the run; the
    checkpoint's controller fields are the JAX controller's after the same
    reports."""
    solver = dict(max_iter=8, val_period=1, checkpoint_period=100,
                  plateau_patience=1, plateau_cooldown=0, max_decay_step=2)
    opts = _opts(vg_dir, tmp_path, **solver)
    _, history = train(load_config(CONFIG, opts), "cpu", log=_quiet)
    ref = JController(j_load_config(CONFIG, opts).solver)
    for i, rec in enumerate(history):
        assert rec["lr_scale"] == pytest.approx(ref.scale(i), rel=1e-12)
        ref.report_validation(rec["val_mR100"])
    assert ref.should_stop and len(history) < solver["max_iter"]
    extra = CheckpointManager(tmp_path / "ckpt").load()["extra"]
    assert extra == {k: getattr(ref, k) for k in (
        "best", "bad_epochs", "cooldown_counter", "num_decays")}
    assert extra["num_decays"] == 2
    lines = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert [x["val_mR100"] for x in lines if "val_mR100" in x] == [
        r["val_mR100"] for r in history]


def test_sigterm_saves_at_the_next_iteration_and_exits(vg_dir, tmp_path):
    def log(line):
        if line.startswith("iter 1/"):
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    state, history = train(load_config(CONFIG, _opts(vg_dir, tmp_path,
                                                     max_iter=6)), "cpu", log=log)
    assert len(history) == 2 and state.step == 2
    assert signal.getsignal(signal.SIGTERM) is before
    ckpt = CheckpointManager(tmp_path / "ckpt")
    assert ckpt.steps() == [2] and ckpt.latest_step() == 2
    payload = ckpt.load()
    assert payload["step"] == 2 and set(payload["extra"]) == {
        "best", "bad_epochs", "cooldown_counter", "num_decays"}


def test_cli_trains_resumes_and_test_net_restores(vg_dir, tmp_path, capsys):
    """The command lines: train through a validation and a checkpoint to a
    final save, resume one more step, then ``relation_test_net --split val``
    restores the last checkpoint and reproduces the model's validation."""
    base = ["--config", CONFIG, "--device", "cpu"] + _opts(
        vg_dir, tmp_path, checkpoint_period=2, val_period=2)
    history = relation_train_net.main(base + ["solver.max_iter=3"])
    assert len(history) == 3 and "val_mR100" in history[1]
    ckpt = CheckpointManager(tmp_path / "ckpt")
    assert ckpt.steps() == [2, 3]
    history = relation_train_net.main(base + ["solver.max_iter=4"])
    assert len(history) == 1 and ckpt.steps() == [2, 3, 4]

    cfg = load_config(CONFIG, _opts(vg_dir, tmp_path))
    agg = relation_test_net.main(["--config", CONFIG, "--device", "cpu",
                                  "--split", "val"] + _opts(vg_dir, tmp_path))
    model = build_model(cfg, "cpu")
    model.load_state_dict(ckpt.load(4)["model"])
    ref, _ = relation_test_net.evaluate(cfg, model=model, split="val", log=_quiet)
    for m in ("R", "mR", "zR"):
        assert agg[m] == ref[m], m
    assert "evaluating the checkpoint of step 4" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "eval_results.json")
    assert os.path.exists(tmp_path / "zeroshot_triplets.npy")


def test_load_params_partially_keeps_what_does_not_match():
    from veto_tpu_torch.utils.checkpoint import load_params_partially

    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loaded = {"0.weight": torch.ones(4, 3), "0.bias": torch.ones(5),
              "1.weight": torch.full((2, 4), 2.0), "extra": torch.zeros(1)}
    lines = []
    assert load_params_partially(model, loaded, lines.append) == [
        "0.weight", "1.weight"]
    sd = model.state_dict()
    assert torch.equal(sd["0.weight"], loaded["0.weight"])
    assert torch.equal(sd["1.weight"], loaded["1.weight"])
    for k in ("0.bias", "1.bias"):
        assert torch.equal(sd[k], before[k])
    assert lines == ["checkpoint: no match for 0.bias, keeping init",
                     "checkpoint: no match for 1.bias, keeping init"]
