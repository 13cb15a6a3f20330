"""Data-parallel PredCls training of the port on two gloo ranks against the
JAX step over a ``make_mesh(2, 1)`` mesh, the faults each rule of the
two-rank step repairs, and the refusals.

(a) The JAX ``make_train_step`` jitted by ``shard_train_step`` over
    ``make_mesh(2, 1)`` (conftest's 8 CPU devices) on 4 images, in f32,
    its encoder the plain XLA layer (the Pallas kernel's reference, as
    ``veto.encoder_impl=xla``); the port's two ranks
    (``tests/torch_port_ddp_worker.py``, one process each) take 2 images
    each and the JAX step's samples through ``train_on_pairs``.  Loss 1e-6
    relative; every gradient 1e-4 of its largest |g|; the updated
    parameters 1e-5; the BatchNorm running statistics 1e-5 (as the
    one-process test ``test_torch_port_train.py`` holds them).
(c) Each rule, taken away alone, moves the step beyond those tolerances:
    per-rank BatchNorm statistics (the depth ResNet's gradients), each
    rank's own denominators, DDP's averaged gradients.
(f) The refusals: a world size that does not divide the batch, each
    configuration of ROADMAP queue A12b at W > 1, a ``LOCAL_RANK`` past the
    device count.
"""

import functools
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from veto_tpu.config import SolverConfig as JSolverConfig
from veto_tpu.data.predicate_stats import predicate_counts as j_predicate_counts
from veto_tpu.engine.batch import SGGBatch as JBatch
from veto_tpu.engine.train import TrainState as JTrainState
from veto_tpu.engine.train import make_mesh, make_train_step, shard_train_step
from veto_tpu.models.relation.predictor_veto import beta_class_weights as j_beta
from veto_tpu.models.relation.sampling import gtbox_relsample as j_relsample
from veto_tpu.models.sgg import SGGModel as JModel
from veto_tpu.solver.optim import make_optimizer as j_make_optimizer

import torch_port_ddp_worker as worker
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.config import load_config
from veto_tpu_torch.data.synthetic import SyntheticSGGDataset
from veto_tpu_torch.engine import distributed
from veto_tpu_torch.solver.optim import FROZEN_DETECTOR, param_label
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict

BATCH, LR_SCALE = 4, 0.5


def _names(tree):
    return flax_to_state_dict({"params": jax.tree.map(np.asarray, tree)})


def _perturb(tree, rng):
    """Random norm affines and statistics (init leaves 1, 0, 0, 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("bias", "mean"):
            out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def _lr(name):
    """A parameter's learning rate before the LR scale (``SOLVER``)."""
    s = worker.SOLVER
    factor = s["bias_lr_factor"] if param_label(name) == "bias" else 1.0
    return s["base_lr"] * factor * s["ims_per_batch"]


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The JAX mesh step, in float64, and the port's two ranks (started
    first, so that they import while JAX compiles) on its
    samples, in f32.  Float64 on the JAX side: on this batch the JAX step
    over ``make_mesh(2, 1)`` in f32 is 8.7% of the largest |g| off its own
    ``make_mesh(1, 1)`` step in the depth ResNet's layer3 (flax's f32
    train-mode BatchNorm sums, taken in another order over the two shards;
    ROADMAP queue C, "not port faults"), where the port's ranks are within
    1e-4 of both the one-device step and the float64 one.  The solver is
    SGD without weight decay, so that the float64 step's update gives its
    clipped gradients back: ``(p - p_new) / (lr * lr_scale)``."""
    d = tmp_path_factory.mktemp("ddp")
    procs = worker.start_ranks(d, ["jax_predcls"])
    try:
        jax_ref, inputs = _jax_mesh_step()
    except BaseException:
        worker.stop_ranks(procs)
        raise
    worker.give_inputs(d, {"jax_predcls": inputs})
    return jax_ref, worker.join_ranks(procs, d, ["jax_predcls"])["jax_predcls"]


def _jax_mesh_step():
    ds = SyntheticSGGDataset(num_images=BATCH, image_size=(64, 96),
                             num_obj_classes=worker.NUM_OBJ,
                             num_rel_classes=worker.NUM_REL, max_objects=6,
                             min_objects=3, max_relations=6, seed=21)
    batch, _ = next(ds.batches(BATCH, worker.MAX_BOXES))
    jbatch = JBatch(**{k: jnp.asarray(v) for k, v in batch.fields().items()})
    jm = JModel(mode="predcls", **worker.SMALL, dtype=jnp.float32,
                veto_encoder_impl="xla", pooler_impl="separable",
                veto_remat=False)
    init_args = (jax.random.PRNGKey(0), *(x[:1] for x in (
        jbatch.images, jbatch.depth, jbatch.boxes, jbatch.box_mask,
        jbatch.labels, jbatch.obj_logits)),
        jnp.zeros((1, worker.PAIRS, 2), jnp.int32), jnp.ones((1, worker.PAIRS), bool))
    init = jax.jit(functools.partial(jm.init, train=False))
    shapes = jax.eval_shape(init, *init_args)
    cw = j_beta(j_predicate_counts("VG")[:worker.NUM_REL])
    mesh = make_mesh(2, 1)

    def f64(tree):  # numpy: the step donates its state, not host arrays
        return jax.tree.map(lambda x: np.asarray(x, np.float64) if np.issubdtype(
            np.asarray(x).dtype, np.floating) else np.asarray(x), tree)

    def abstract64(tree):
        return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, jnp.float64 if (
            jnp.issubdtype(x.dtype, jnp.floating)) else x.dtype), tree)

    compiled = {}

    def compile_step():  # the float64 step, compiled while init runs
        with jax.enable_x64(True):
            p, s = abstract64(shapes["params"]), abstract64(shapes["batch_stats"])
            tx = j_make_optimizer(JSolverConfig(**worker.SOLVER), p, FROZEN_DETECTOR)
            step = shard_train_step(make_train_step(
                jm.clone(dtype=jnp.float64), tx, jnp.asarray(cw, jnp.float64),
                batch_size_per_image=worker.PAIRS, positive_fraction=0.25,
                mode="predcls", mesh=mesh), mesh)
            state = JTrainState(step=jax.ShapeDtypeStruct((), jnp.int32), params=p,
                                batch_stats=s, opt_state=jax.eval_shape(tx.init, p),
                                rng=jax.eval_shape(lambda: jax.random.PRNGKey(5)))
            compiled.update(tx=tx, step=step.lower(
                state, abstract64(jbatch), jax.ShapeDtypeStruct((), jnp.float64)).compile())

    thread = threading.Thread(target=compile_step)
    thread.start()
    try:
        variables = init(*init_args)
    finally:
        thread.join()
    assert compiled, "the float64 step did not compile"
    params = jax.tree.map(np.asarray, variables["params"])
    stats = _perturb(jax.tree.map(np.asarray, variables["batch_stats"]),
                     np.random.RandomState(0))
    assert all(x.dtype == np.float32 for x in jax.tree.leaves(params))

    with jax.enable_x64(True):
        p64, s64, b64 = f64(params), f64(stats), f64(jbatch)
        tx = compiled["tx"]
        state = JTrainState(step=jnp.asarray(0, jnp.int32), params=p64,
                            batch_stats=s64, opt_state=tx.init(p64),
                            rng=jax.random.PRNGKey(5))
        new, jmetrics = compiled["step"](state, b64,
                                         jnp.asarray(LR_SCALE, jnp.float64))
        # the update in float64, before the converter's f32 cast
        update = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                              p64, new.params)
        new = flax_to_state_dict({"params": new.params,
                                  "batch_stats": new.batch_stats})
        # the step's samples, as it draws them (its uniforms are float64 here)
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(5), 0), BATCH)
        js = jax.vmap(lambda k, r, m: j_relsample(
            k, r, m, batch_size=worker.PAIRS, positive_fraction=0.25))(
            keys, jbatch.rel_matrix, jbatch.box_mask)
    inputs = dict(
        state_dict=flax_to_state_dict({"params": params, "batch_stats": stats}),
        class_weights=torch.from_numpy(np.asarray(cw)),
        batch=batch.to("cpu"), lr_scale=LR_SCALE,
        samples=tuple(torch.from_numpy(np.array(a))
                      for a in (js.pair_idx, js.labels, js.mask)))
    update = _names(jax.tree.map(lambda u: u / LR_SCALE, update))
    trained = [n for n in update if n.split(".")[0] in ("depth_backbone", "relation")]
    jax_ref = dict(
        loss=float(jmetrics["loss"]), grad_norm=float(jmetrics["grad_norm"]),
        grads={n: update[n] / _lr(n) for n in trained},
        params={n: new[n] for n in update},
        batch_stats={k: v for k, v in new.items()
                     if k.rsplit(".", 1)[-1] in ("running_mean", "running_var")})
    return jax_ref, inputs


def _worst(got, ref):
    """Each tensor's largest |got - ref| over its largest |ref|."""
    out = {}
    for n, r in ref.items():
        scale = float(r.abs().max())
        if scale > 0:
            out[n] = float((got[n] - r).abs().max()) / scale
    return out


def test_two_ranks_match_the_jax_mesh_step(steps):
    """Loss, gradient norm, each clipped gradient, the updated parameters
    and the BatchNorm statistics of both ranks against the JAX step over
    ``make_mesh(2, 1)``; the ranks' parameters bit-equal."""
    ref, ranks = steps
    r0, r1 = ranks
    for r in (r0, r1):
        assert r["loss"] == pytest.approx(ref["loss"], rel=1e-6)
        assert r["rel_loss"] == pytest.approx(ref["loss"], rel=1e-6)
        assert r["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-5)
        trained = {n for n in r["params"] if n.split(".")[0] in
                   ("depth_backbone", "relation")}
        assert set(r["grads"]) == trained
        worst = _worst(r["grads"], {n: ref["grads"][n] for n in trained})
        assert max(worst.values()) < 1e-4, sorted(worst.items(), key=lambda x: -x[1])[:5]
        for n, p in r["params"].items():
            np.testing.assert_allclose(p.numpy(), ref["params"][n].numpy(),
                                       atol=1e-5, rtol=0, err_msg=n)
        assert set(r["batch_stats"]) == set(ref["batch_stats"])
        for k, v in ref["batch_stats"].items():
            np.testing.assert_allclose(r["batch_stats"][k].numpy(), v.numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
    for n in r0["params"]:
        assert torch.equal(r0["params"][n], r1["params"][n]), n
    for k in r0["batch_stats"]:
        assert torch.equal(r0["batch_stats"][k], r1["batch_stats"][k]), k


# ---------------------------------------------------------------- refusals
REPO = worker.REPO


def _cfg(config="veto_vg_predcls.yaml", *opts):
    return load_config(os.path.join(REPO, "configs", config), list(opts))


def test_world_size_must_divide_the_batch():
    assert distributed.local_batch(12, 2) == 6
    assert distributed.local_batch(12, 3) == 4
    with pytest.raises(ValueError, match="pair axis"):
        distributed.local_batch(12, 5)


SERVED = [("veto_vg_predcls.yaml",), ("veto_vg_sgcls.yaml",),
          ("veto_vg_sgdet.yaml",), ("veto_meet_vg_predcls.yaml",),
          ("veto_vg_predcls.yaml", "veto.encoder_impl=fused"),
          ("veto_vg_predcls.yaml", "veto.encoder_impl=xla"),
          ("veto_vg_predcls.yaml", "relation.predictor=BGNNPredictor",
           "relation.rel_aware=True")]
A12B = [("veto_vg_predcls.yaml", "veto.encoder_impl=pair_attn"),
        ("veto_vg_predcls.yaml", "model.attribute_on=True"),
        ("veto_vg_sgcls.yaml", "ensemble.enabled=True"),
        ("veto_vg_sgdet.yaml", "ensemble.enabled=True"),
        ("veto_vg_predcls.yaml", "relation.predictor=BGNNPredictor"),
        ("veto_vg_sgcls.yaml", "relation.predictor=BGNNPredictor",
         "relation.rel_aware=True"),
        ("veto_vg_predcls.yaml", "relation.predictor=MSDNPredictor",
         "relation.rel_aware=True"),
        ("veto_vg_predcls.yaml", "relation.predictor=IMPPredictor"),
        ("veto_vg_predcls.yaml", "relation.predictor=GPSNetPredictor"),
        ("veto_vg_predcls.yaml", "relation.predictor=MotifPredictor"),
        ("veto_vg_predcls.yaml", "relation.predictor=VCTreePredictor"),
        ("veto_vg_predcls.yaml", "relation.predictor=TransformerPredictor"),
        ("veto_vg_predcls.yaml", "relation.predictor=TransLikePredictor")]


def test_configurations_outside_the_scope_raise_on_several_ranks():
    for case in SERVED:
        cfg = _cfg(*case)
        distributed.check_scope(cfg, 2)
    for case in A12B:
        cfg = _cfg(*case)
        distributed.check_scope(cfg, 1)  # one process runs them all
        with pytest.raises(NotImplementedError, match="A12b"):
            distributed.check_scope(cfg, 2)


def test_tools_refuse_before_any_work(tmp_path, monkeypatch):
    """Both relation tools under a two-rank group refuse an A12b
    configuration, and detector pretraining refuses under ``WORLD_SIZE``
    2, before any model is built."""
    from veto_tpu_torch.tools import detector_pretrain_net, relation_test_net
    from veto_tpu_torch.tools.relation_train_net import train

    class Two:
        rank, world, host_group = 0, 2, None

    monkeypatch.setattr(distributed, "init_from_env",
                        lambda device=None: (Two(), torch.device("cpu")))
    cfg = _cfg("veto_vg_predcls.yaml", "veto.encoder_impl=pair_attn",
               f"output_dir={tmp_path}")
    for run in (train, relation_test_net.evaluate):
        with pytest.raises(NotImplementedError, match="A12b"):
            run(cfg, "cpu", log=lambda s: None)
    with pytest.raises(ValueError, match="do not divide"):
        train(_cfg("veto_vg_predcls.yaml", "solver.ims_per_batch=3",
                   f"output_dir={tmp_path}"), "cpu", log=lambda s: None)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="A12b"):
        detector_pretrain_net.train(_cfg("veto_vg_sgdet.yaml",
                                         f"output_dir={tmp_path}"), "cpu",
                                    log=lambda s: None)


def test_local_rank_past_the_cards_raises(monkeypatch):
    """Each rank's device is ``cuda:LOCAL_RANK``; a local rank at or past
    the card count raises (no wrap-around), a named device is kept."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distributed.rank_device(1) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK=2"):
        distributed.rank_device(2)
    assert distributed.rank_device(5, "cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(RuntimeError, match="LOCAL_RANK=2"):
        distributed.init_from_env()


def test_single_process_has_no_group(monkeypatch):
    """No group and no ``WORLD_SIZE``: the plain single process."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.init_from_env("cpu") == (None, torch.device("cpu"))
    assert (distributed.rank(), distributed.world(), distributed.is_main()) == (
        0, 1, True)


@pytest.mark.parametrize("tool", ["train", "evaluate"])
def test_tools_join_the_group_once(tool, tmp_path, monkeypatch):
    """Each tool's ``main`` joins the group and hands its ranks to ``train``
    / ``evaluate``, which then do not join again (under NCCL each join
    would make another gloo group for host values)."""
    from veto_tpu_torch.tools import relation_test_net, relation_train_net

    class Two:
        rank, world, host_group = 0, 2, None

    joins = []

    def join(device=None):
        joins.append(device)
        return Two(), torch.device("cpu")

    monkeypatch.setattr(distributed, "init_from_env", join)
    main = (relation_train_net if tool == "train" else relation_test_net).main
    with pytest.raises(NotImplementedError, match="A12b"):  # after the join
        main(["--config", os.path.join(REPO, "configs", "veto_vg_predcls.yaml"),
              "--device", "cpu", f"output_dir={tmp_path}",
              "veto.encoder_impl=pair_attn"])
    assert joins == ["cpu"]


def test_build_model_weights_do_not_depend_on_the_global_rng():
    """``build_model`` constructs the model on its device, so on a card the
    layers' default initialisation draws from the CUDA generator, not the
    CPU's; the seeded ``init_weights`` overwrites every parameter and
    statistic, so the built weights are the same whatever the global
    generators hold."""
    from veto_tpu_torch.models.sgg import build_model

    cfg = _cfg("veto_vg_predcls.yaml", *worker.TOY)
    built = []
    for seed in (0, 1):
        torch.manual_seed(seed)
        built.append(build_model(cfg, "cpu").state_dict())
    assert built[0].keys() == built[1].keys()
    for k, v in built[0].items():
        assert torch.equal(v, built[1][k]), k
