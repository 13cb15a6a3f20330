"""The port's evaluation gather, global buffer and both relation tools on
several gloo ranks (``tests/torch_port_ddp_worker.py``: one process a
rank, one thread; three ranks for the gather, two for the tools).

- ``pad_allgather`` with ragged lengths 0, 3 and 7: every rank gets every
  rank's array, trimmed, in rank order.
- ``merge_evaluators`` against the JAX package's on the same per-image
  inputs; ``sync_gather_evaluator`` over the three ranks' shards against
  one evaluator fed every image, to 1e-12 (as
  ``tests/test_gather_and_sharding.py`` holds the JAX merge).
- The train tool on two ranks (BGNN with ``relation.rel_aware`` on the
  synthetic corpus, ``global_buffer_on``, validation and a checkpoint
  after each of 2 steps): bit-equal parameters, the same ``lr_scale`` and
  ``val_mR100`` histories; only rank 0 writes the checkpoints,
  ``metrics.jsonl``, ``inter_data_buffer.pkl`` and ``evaluation_res.txt``;
  the buffer holds both ranks' rows of every step.  Rank 0's checkpoint
  restores into one process bit for bit, and a one-process checkpoint
  into the two ranks.  The test tool on two
  ranks with ``test.sync_gather``: its R@K equals one process's on the
  same checkpoint and images.
- The global buffer's rows equal the JAX step's diagnostics
  (``make_train_step(collect_diagnostics=True)``) on the same weights,
  batch and samples.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from veto_tpu.config import SolverConfig as JSolverConfig
from veto_tpu.engine.batch import SGGBatch as JBatch
from veto_tpu.engine.gather import merge_evaluators as j_merge
from veto_tpu.engine.train import TrainState as JTrainState
from veto_tpu.engine.train import make_train_step
from veto_tpu.evaluation.sgg_eval import SGGEvaluator as JEvaluator
from veto_tpu.models.relation.sampling import gtbox_relsample as j_relsample
from veto_tpu.solver.optim import make_optimizer as j_make_optimizer

import torch_port_ddp_worker as worker
from torch_port_det_steps import compiled
from torch_port_legacy_case import TINY, class_weights, jax_variables
from torch_port_mp_case import jax_model, mp_kw
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.config import SolverConfig
from veto_tpu_torch.data.synthetic import SyntheticSGGDataset
from veto_tpu_torch.engine.gather import merge_evaluators, pad_allgather
from veto_tpu_torch.engine.train import create_train_state, train_on_pairs
from veto_tpu_torch.models.relation.sampling import RelSample
from veto_tpu_torch.models.sgg import SGGModel
from veto_tpu_torch.solver.optim import FROZEN_DETECTOR
from veto_tpu_torch.utils import global_buffer
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict

METRICS = ("R", "ngR", "zR", "mR", "ngmR", "A")
PAIRS = 16


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The three-rank gather and the two-rank tools, started together; the
    JAX step of the buffer test compiles meanwhile (``jax_buffer``)."""
    d3, d2 = tmp_path_factory.mktemp("gather"), tmp_path_factory.mktemp("tools")
    p3 = worker.start_ranks(d3, ["gather"], world=3)
    p2 = worker.start_ranks(d2, ["tools"])
    worker.give_inputs(d3, {})
    worker.give_inputs(d2, {"tools": {"directory": str(d2)}})
    try:
        jax_ref = _jax_buffer_step()
    except BaseException:
        worker.stop_ranks(p3 + p2)
        raise
    return dict(gather=worker.join_ranks(p3, d3, ["gather"])["gather"],
                tools=worker.join_ranks(p2, d2, ["tools"])["tools"],
                out=d2 / "out", jax_buffer=jax_ref)


def _same_aggregate(got, want, tol=1e-12):
    for metric in METRICS:
        for k, v in want[metric].items():
            assert got[metric][k] == pytest.approx(v, abs=tol), (metric, k)
    np.testing.assert_allclose(got["mR_per_class"][100], want["mR_per_class"][100],
                               atol=tol, rtol=0)


def test_pad_allgather_ragged(ranks):
    want = [np.arange(n, dtype=np.float64) + 100 * r + 0.5
            for r, n in enumerate((0, 3, 7))]
    for r in ranks["gather"]:
        assert len(r["gathered"]) == 3
        for got, w in zip(r["gathered"], want):
            np.testing.assert_array_equal(got, w)
    assert [len(a) for a in pad_allgather(np.arange(4.0))] == [4]  # one process


def test_host_decisions_agree(ranks):
    """The preemption flag raised on one rank stops every rank; without
    the gather every rank takes rank 0's validation reading."""
    for r in ranks["gather"]:
        assert r["agree"] == [True, False] and r["broadcast"] == 0.25


def test_merge_evaluators_matches_jax():
    images = worker.fake_images()
    parts = ([], [])
    for ev_cls, out in ((worker.evaluator, parts[0]),
                        (lambda: JEvaluator(mode="predcls", num_rel_classes=worker.EVAL_REL,
                                            zeroshot_triplets=np.array([[1, 2, 3]])),
                         parts[1])):
        hosts = [ev_cls(), ev_cls()]
        for img in images[:3]:
            hosts[0].add_image(**img)
        for img in images[3:]:
            hosts[1].add_image(**img)
        out.append(hosts)
    merged, jmerged = worker.evaluator(), JEvaluator(mode="predcls",
                                                     num_rel_classes=worker.EVAL_REL)
    merge_evaluators(merged, parts[0][0])
    j_merge(jmerged, parts[1][0])
    assert merged.num_images == jmerged.num_images == len(images)
    for k in merged.ks:
        assert merged.recall[k] == jmerged.recall[k]
        assert merged.mean_recall_collect[k] == jmerged.mean_recall_collect[k]
    _same_aggregate(merged.aggregate(), jmerged.aggregate(), tol=0)


def test_sync_gather_equals_one_evaluator(ranks):
    whole = worker.evaluator()
    for img in worker.fake_images():
        whole.add_image(**img)
    for r in ranks["gather"]:
        assert r["num_images"] == whole.num_images
        _same_aggregate(r["aggregate"], whole.aggregate())


def test_train_tool_ranks_agree(ranks):
    r0, r1 = ranks["tools"]
    assert len(r0["history"]) == 2
    for key in ("lr_scale", "val_mR100", "loss", "grad_norm"):
        assert [h.get(key) for h in r0["history"]] == [h.get(key) for h in r1["history"]]
    assert all(h.get("val_mR100") is not None for h in r0["history"])
    for n, p in r0["params"].items():
        assert torch.equal(p, r1["params"][n]), n


def test_only_rank_0_writes(ranks):
    r0, r1 = ranks["tools"]
    assert r1["written"] == []
    names = {w.split(".")[0] for w in r0["written"]}
    assert {"ckpt/model_0000001", "ckpt/model_0000002", "ckpt/last_checkpoint",
            "metrics", "inter_data_buffer", "evaluation_res"} <= names, names
    assert sorted(os.listdir(ranks["out"] / "ckpt")) == [
        "last_checkpoint", "model_0000001.pth", "model_0000002.pth"]


def test_buffer_holds_every_rank_rows(ranks):
    r0, r1 = ranks["tools"]
    with open(ranks["out"] / "inter_data_buffer.pkl", "rb") as f:
        data = pickle.load(f)
    assert set(data) == {"rel_pn-train_y", "rel_pn-train_pred"}
    for key, entries in data.items():
        counts = [[c for k, c in r["stored"] if k == key] for r in (r0, r1)]
        assert [len(e) for e in entries] == [a + b for a, b in zip(*counts)]
        assert all(e.shape[1] == 1 for e in entries)
    y = np.concatenate(data["rel_pn-train_y"])
    pred = np.concatenate(data["rel_pn-train_pred"])
    assert set(np.unique(y)) <= {0, 1} and ((pred > 0) & (pred < 1)).all()


def test_checkpoints_restore_across_world_sizes(ranks):
    """Rank 0's checkpoint of the two-rank run restores into one process:
    the parameters, Adam's state, the step and the generator are the
    ranks' own at the end, bit for bit, and the plateau fields come back.
    The reverse: a one-process checkpoint at step 1, resumed by the two
    ranks to step 2, whose parameters stay bit-equal."""
    from veto_tpu_torch.models.sgg import build_model
    from veto_tpu_torch.tools.relation_train_net import rel_class_weights
    from veto_tpu_torch.utils.checkpoint import CheckpointManager

    r0, r1 = ranks["tools"]
    cfg = worker.toy_config("veto_vg_predcls.yaml",
                            worker.TOOLS + [f"output_dir={ranks['out']}"])
    state = create_train_state(build_model(cfg, "cpu"), cfg.solver,
                               rel_class_weights(cfg), mode=cfg.relation.mode)
    state.generator = torch.Generator().manual_seed(0)
    extra = CheckpointManager(str(ranks["out"] / "ckpt")).restore(state)
    assert state.step == 2 and set(extra) >= {"best", "bad_epochs", "num_decays"}
    assert torch.equal(state.generator.get_state(), r0["generator"])
    for n, p in state.model.named_parameters():
        assert torch.equal(p.detach(), r0["params"][n]), n
    got, want = state.optimizer.inner.state_dict()["state"], r0["optimizer"]["state"]
    assert set(got) == set(want) and got
    for i in want:
        for k, v in want[i].items():
            assert torch.equal(torch.as_tensor(got[i][k]), torch.as_tensor(v)), (i, k)
    for r in (r0, r1):
        assert "resumed from iteration 1" in r["resumed"]["lines"]
        assert r["resumed"]["step"] == 2 and len(r["resumed"]["history"]) == 1
    for n, p in r0["resumed"]["params"].items():
        assert torch.equal(p, r1["resumed"]["params"][n]), n


def test_test_tool_gathers_one_process_recall(ranks):
    r0, r1 = ranks["tools"]
    for r in (r0, r1):
        _same_aggregate(r["aggregate"], r0["one"])
    assert r0["one"]["R"][20] > 0


def _jax_buffer_step():
    """The JAX BGNN (``rel_aware``) PredCls step with ``collect_diagnostics``
    on a seeded fill of its variables, and its samples."""
    ds = SyntheticSGGDataset(num_images=2, image_size=(64, 64),
                             num_obj_classes=TINY["num_obj_classes"], num_rel_classes=7,
                             max_objects=5, min_objects=3, max_relations=6, seed=4)
    batch, _ = next(ds.batches(2, 6))
    jbatch = JBatch(**{k: jnp.asarray(v) for k, v in batch.fields().items()})
    jm = jax_model("BGNNPredictor", "predcls", rel_aware=True, mp_valid_pairs=8)
    v = jax_variables(jm, (*(x[:1] for x in (
        jbatch.images, jbatch.depth, jbatch.boxes, jbatch.box_mask, jbatch.labels,
        jbatch.obj_logits)), jnp.zeros((1, PAIRS, 2), jnp.int32),
        jnp.ones((1, PAIRS), bool)), method=None)
    solver = dict(ims_per_batch=2, base_lr=1e-3)
    cw = class_weights()
    tx = j_make_optimizer(JSolverConfig(**solver), v["params"], FROZEN_DETECTOR)
    state = JTrainState(step=jnp.asarray(0, jnp.int32), params=v["params"],
                        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
                        rng=jax.random.PRNGKey(7))
    step = compiled(make_train_step(jm, tx, cw, batch_size_per_image=PAIRS,
                                    positive_fraction=0.25, mode="predcls",
                                    collect_diagnostics=True),
                    state, jbatch, jnp.asarray(1.0))
    _, metrics = step(state, jbatch, jnp.asarray(1.0))
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(7), 0), 2)
    js = jax.vmap(lambda k, r, m: j_relsample(
        k, r, m, batch_size=PAIRS, positive_fraction=0.25))(
        keys, jbatch.rel_matrix, jbatch.box_mask)
    return dict(buffer=jax.tree.map(np.asarray, metrics["buffer"]), variables=v,
                batch=batch, solver=solver, cw=cw,
                samples=RelSample(*(torch.from_numpy(np.array(a))
                                    for a in (js.pair_idx, js.labels, js.mask))))


def test_buffer_rows_equal_the_jax_step_diagnostics(ranks, tmp_path):
    """The port's step on the JAX step's weights, batch and samples, its
    diagnostics stored and pickled through the global buffer: the rows are
    the JAX step's valid pairs' (targets exact, relness scores 1e-5)."""
    ref = ranks["jax_buffer"]
    model = SGGModel(mode="predcls", predictor="BGNNPredictor", num_rel_classes=7,
                     **TINY, dtype=torch.float32, **mp_kw(True, 8))
    _, unexpected = model.load_state_dict(flax_to_state_dict(ref["variables"]),
                                          strict=False)
    assert not unexpected
    state = create_train_state(model, SolverConfig(**ref["solver"]), ref["cw"])
    m = train_on_pairs(state, ref["batch"].to("cpu"), ref["samples"], 1.0,
                       collect_diagnostics=True)
    buf = m["buffer"]
    global_buffer.reset()
    try:
        global_buffer.enable(True)
        for key in ("rel_pn-train_y", "rel_pn-train_pred"):
            global_buffer.store_data(key, buf[key], mask=buf["mask"])
        path = global_buffer.save_buffer(str(tmp_path))
    finally:
        global_buffer.reset()
    with open(path, "rb") as f:
        data = pickle.load(f)
    jbuf = ref["buffer"]
    mask = jbuf["mask"].astype(bool)
    np.testing.assert_array_equal(buf["mask"].numpy(), mask)
    np.testing.assert_array_equal(data["rel_pn-train_y"][0][:, 0],
                                  jbuf["rel_pn-train_y"][mask])
    np.testing.assert_allclose(data["rel_pn-train_pred"][0][:, 0],
                               jbuf["rel_pn-train_pred"][mask], atol=1e-5, rtol=0)
