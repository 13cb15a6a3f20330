"""Ranks for the port's data-parallel tests, started as W processes on the
gloo backend.

The parent (a pytest process, which has JAX loaded) starts the ranks
(:func:`start_ranks`), hands them their inputs (:func:`give_inputs`,
``torch.save`` into a directory) once it has computed them, and collects
their results (:func:`join_ranks`); each child
runs this file as a script (so that it imports only ``torch`` and
``veto_tpu_torch``), joins the group through a ``file://`` rendezvous in
that directory (no port to race for under xdist), runs on one thread the
cases it is given, one after another, and saves each case's result as
``<case>.rank<r>.pt``.  A case is a function of this module named
``case_<name>(dp, inputs) -> dict``; it may also return the one-process
reference (rank 0 computes it after the ranks' run).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NUM_OBJ, NUM_REL = 11, 7
MAX_BOXES, PAIRS = 8, 16
SMALL = dict(num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL,
             stage_blocks=(1, 1, 1, 1), groups=4, width_per_group=4,
             fpn_channels=32, veto_dim=96, veto_layers=2, veto_heads=6,
             veto_depth_proj_dim=32, veto_visual_proj_dim=16, embed_dim=200,
             fold_bn=True)
# SGD: its update is continuous in the gradient (Adam's first step is
# lr * sign(g), which flips where a gradient is 0 up to rounding); no
# weight decay, so that the JAX step's update gives back its gradient
SOLVER = dict(ims_per_batch=4, base_lr=1e-3, bias_lr_factor=2.0,
              weight_decay=0.0, weight_decay_bias=0.0, grad_clip_norm=5.0,
              optimizer="sgd")
# the toy models of the configurations the port trains on several ranks
TOY = ["model.stage_blocks=(1,1,1,1)", "veto.t_input_dim=96", "veto.enc_layers=2",
       "data.max_boxes=8", "data.min_size_train=64", "data.max_size_train=96",
       "data.min_size_test=64", "data.max_size_test=96",
       "relation.batch_size_per_image=16", "relation.max_proposal_pairs=48",
       "solver.ims_per_batch=4", "test.ims_per_batch=4", "dtype=float32",
       "model.box_mlp_head_dim=32", "relation.context_hidden_dim=16",
       "relation.context_pooling_dim=32"]
SGDET = ["model.rpn_pre_nms_top_n_train=64", "model.rpn_post_nms_top_n_train=16",
         "model.rpn_pre_nms_top_n_test=64", "model.rpn_post_nms_top_n_test=16",
         "model.box_detections_per_img=8", "model.num_obj_classes=11",
         "model.box_score_thresh=0.002"]


def start_ranks(directory, cases, world: int = 2):
    """Start ``world`` ranks that will run ``cases`` (names) once the
    parent has given them their inputs (:func:`give_inputs`): they import
    and join the group meanwhile."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(directory), str(r),
         str(world), ",".join(cases)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def stop_ranks(procs) -> None:
    """Kill the ranks that are still running (the parent failed)."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def give_inputs(directory, inputs) -> None:
    """Hand the ranks their inputs: ``{case: inputs}``."""
    tmp = os.path.join(directory, "inputs.tmp")
    torch.save(inputs, tmp)
    os.replace(tmp, os.path.join(directory, "inputs.pt"))


def join_ranks(procs, directory, cases, timeout: float = 240.0):
    """Wait for the ranks; returns, per case, the list of the ranks'
    results (a rank that failed raises with its output)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        stop_ranks(procs)
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{out[-6000:]}")
    return {c: [torch.load(os.path.join(directory, f"{c}.rank{r}.pt"),
                           weights_only=False) for r in range(len(procs))]
            for c in cases}


def run_ranks(directory, cases, world: int = 2, inputs=None):
    """Run ``cases`` on ``world`` ranks with ``inputs``; see
    :func:`join_ranks`."""
    procs = start_ranks(directory, cases, world)
    give_inputs(directory, inputs or {})
    return join_ranks(procs, directory, cases)


# ------------------------------------------------------------------ helpers
def rows(x, rank: int, world: int, dim: int = 0):
    """This rank's share of the global batch's rows of ``x``."""
    b = x.shape[dim] // world
    return x.narrow(dim, rank * b, b)


def local_batch(batch, rank: int, world: int):
    from veto_tpu_torch.engine.batch import SGGBatch

    return SGGBatch(**{k: rows(torch.as_tensor(v), rank, world)
                       for k, v in batch.fields().items()})


def grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def small_model(state_dict):
    from veto_tpu_torch.models.sgg import SGGModel

    model = SGGModel(**SMALL, dtype=torch.float32)
    model.load_state_dict(state_dict, strict=False)
    return model


def step_on_pairs(dp, inputs):
    """The port's PredCls step on the parent's model, batch and samples
    (the JAX step's), this rank's rows under ``dp``."""
    from veto_tpu_torch.config import SolverConfig
    from veto_tpu_torch.engine.train import create_train_state, train_on_pairs
    from veto_tpu_torch.models.relation.sampling import RelSample

    model = small_model(inputs["state_dict"])
    state = create_train_state(model, SolverConfig(**SOLVER),
                               inputs["class_weights"], dp=dp)
    batch, samples = inputs["batch"], RelSample(*inputs["samples"])
    if dp is not None:
        batch = local_batch(batch, dp.rank, dp.world)
        samples = RelSample(*(rows(t, dp.rank, dp.world) for t in samples))
    m = train_on_pairs(state, batch, samples, inputs["lr_scale"])
    return {"loss": float(m["loss"]), "rel_loss": float(m["rel_loss"]),
            "grad_norm": float(m["grad_norm"]), "grads": grads(model),
            "params": params(model), "batch_stats": m["batch_stats"]}


# ------------------------------------------------------------------- cases
def case_jax_predcls(dp, inputs):
    return step_on_pairs(dp, inputs)


def toy_config(name: str, extra=()):
    from veto_tpu_torch.config import load_config

    return load_config(os.path.join(REPO, "configs", name), TOY + list(extra))


MODES = {
    "predcls": ("veto_vg_predcls.yaml", []),
    "sgcls": ("veto_vg_sgcls.yaml", []),
    "sgdet": ("veto_vg_sgdet.yaml", SGDET),
    "meet": ("veto_meet_vg_predcls.yaml", []),
    "xla": ("veto_vg_predcls.yaml", ["veto.encoder_impl=xla"]),
    "bgnn": ("veto_vg_predcls.yaml", ["relation.predictor=BGNNPredictor",
                                      "relation.rel_aware=True",
                                      "relation.mp_valid_pairs=8"]),
}


def mode_step(cfg, batch, dp):
    """One step of the configuration's model from its seed on ``batch``
    (the global one; this rank's rows under ``dp``): the samples, losses,
    gradients, running statistics, parameters and generator state."""
    from veto_tpu_torch.engine.train import (
        create_train_state, sample_detections, sample_pairs, train_on_pairs,
    )
    from veto_tpu_torch.models.sgg import build_model
    from veto_tpu_torch.tools.relation_train_net import (
        build_meet_config, rel_class_weights,
    )

    model = build_model(cfg, "cpu")
    state = create_train_state(model, cfg.solver, rel_class_weights(cfg),
                               mode=cfg.relation.mode,
                               meet=build_meet_config(cfg), dp=dp)
    state.generator = torch.Generator().manual_seed(cfg.solver.seed)
    if dp is not None:
        batch = local_batch(batch, dp.rank, dp.world)
    rel = cfg.relation
    if cfg.relation.mode == "sgdet":
        samples = sample_detections(model, batch, state.generator,
                                    rel.batch_size_per_image,
                                    rel.positive_fraction,
                                    rel.num_sample_per_gt_rel,
                                    rel.require_box_overlap, dp)
        drawn = samples.pairs._asdict()
        drawn["detections"] = samples.det.detections.boxes
    else:
        samples = sample_pairs(batch, state.generator, rel.batch_size_per_image,
                               rel.positive_fraction, dp)
        drawn = samples._asdict()
    m = train_on_pairs(state, batch, samples, 0.5, collect_diagnostics=True)
    return {"samples": {k: v.clone() for k, v in drawn.items()},
            "losses": {k: float(v) for k, v in m.items() if k.endswith("loss")},
            "grad_norm": float(m["grad_norm"]), "grads": grads(model),
            "batch_stats": m["batch_stats"], "params": params(model),
            "generator": state.generator.get_state(),
            "buffer": m.get("buffer")}


def mode_batch(cfg):
    from veto_tpu_torch.tools.relation_train_net import (
        batches_for, synthetic_train_dataset,
    )

    return next(batches_for(cfg, synthetic_train_dataset(cfg, 8), "train")(1))[0].to("cpu")


def _mode_case(name):
    def case(dp, inputs):
        cfg = toy_config(*MODES[name])
        batch = mode_batch(cfg)
        out = {"ranks": mode_step(cfg, batch, dp)}
        if dp.rank == 0:
            out["one"] = mode_step(cfg, batch, None)
        return out
    return case


for _name in MODES:
    globals()[f"case_{_name}"] = _mode_case(_name)


def _fault_step(dp):
    cfg = toy_config(*MODES["predcls"])
    return mode_step(cfg, mode_batch(cfg), dp)


def case_per_rank_stats(dp, inputs):
    """The fault that cross-rank BatchNorm repairs: each rank normalises
    with its own images' statistics."""
    from veto_tpu_torch.engine.distributed import DataParallel

    class PerRankStats(DataParallel):
        def sum(self, x):
            return x

    return _fault_step(PerRankStats(dp.group, dp.host_group))


def case_local_denominators(dp, inputs):
    """The fault that global denominators repair: each rank's mean over its
    own pairs, the gradients still summed."""
    from veto_tpu_torch.engine import distributed

    summed = distributed.total
    distributed.total = lambda dp_, x: x
    try:
        return _fault_step(dp)
    finally:
        distributed.total = summed


def case_averaged_grads(dp, inputs):
    """The fault that summing repairs: DDP's mean of the ranks' gradients."""
    import veto_tpu_torch.engine.train as engine

    summed = engine.all_reduce_grads

    def averaged(params_, group=None, extra=()):
        out = summed(params_, group, extra)
        with torch.no_grad():
            for p in params_:
                p.grad /= dp.world
        return out

    engine.all_reduce_grads = averaged
    try:
        return _fault_step(dp)
    finally:
        engine.all_reduce_grads = summed


# ------------------------------------------------------- gather and tools
EVAL_REL = 8


def fake_image(rng, n_obj=6, n_gt=4, n_pred=18):
    """One image's ground truth and predictions for the evaluator (the JAX
    package's ``tests/test_gather_and_sharding.py`` case)."""
    boxes = np.sort(rng.uniform(0, 80, (n_obj, 4)), -1).astype(np.float32)
    boxes[:, 2:] += 20
    classes = rng.randint(1, 9, n_obj)
    pairs = [(i, j) for i in range(n_obj) for j in range(n_obj) if i != j]
    sel = rng.choice(len(pairs), n_gt, replace=False)
    rels = np.array([[pairs[k][0], pairs[k][1], rng.randint(1, EVAL_REL)]
                     for k in sel])
    pri = np.array([pairs[k] for k in rng.choice(len(pairs), n_pred, replace=False)])
    scores = rng.dirichlet(np.ones(EVAL_REL), n_pred)
    return dict(gt_boxes=boxes, gt_classes=classes, gt_rels=rels, pred_boxes=boxes,
                pred_classes=classes, obj_scores=np.ones(n_obj),
                pred_rel_inds=pri, rel_scores=scores)


def fake_images(n=7):
    rng = np.random.RandomState(5)
    return [fake_image(rng) for _ in range(n)]


def evaluator():
    from veto_tpu_torch.evaluation.sgg_eval import SGGEvaluator

    return SGGEvaluator(mode="predcls", num_rel_classes=EVAL_REL,
                        zeroshot_triplets=np.array([[1, 2, 3]]))


def case_gather(dp, inputs):
    """``pad_allgather`` of ragged lengths (0, 3, 7 on ranks 0, 1, 2),
    ``sync_gather_evaluator`` over the ranks' shards of the images, and
    the host decisions' ``agree`` and ``broadcast_value``."""
    from veto_tpu_torch.engine.gather import pad_allgather, sync_gather_evaluator

    arr = np.arange((0, 3, 7)[dp.rank % 3], dtype=np.float64) + 100 * dp.rank + 0.5
    ev = evaluator()
    for img in fake_images()[dp.rank:: dp.world]:
        ev.add_image(**img)
    sync_gather_evaluator(ev, dp.host_group)
    from veto_tpu_torch.engine.distributed import broadcast_value

    return {"gathered": pad_allgather(arr, dp.host_group), "num_images": ev.num_images,
            "aggregate": ev.aggregate(),
            # the host decisions: a flag one rank raises, rank 0's reading
            "agree": [dp.agree(dp.rank == 1), dp.agree(False)],
            "broadcast": broadcast_value(dp.rank + 0.25, dp)}


def _written(root):
    """Record the files this process writes under ``root``: every ``open``
    for writing (an audit hook) and every ``torch.save``, whose writer
    opens its file in C++."""
    seen = []
    root = os.path.abspath(root)

    def note(path):
        path = os.path.abspath(path)
        if path.startswith(root):
            seen.append(os.path.relpath(path, root))

    def hook(event, args):
        if event == "open" and isinstance(args[0], str) and args[1] and any(
                c in str(args[1]) for c in "wax+"):
            note(args[0])

    sys.addaudithook(hook)
    save = torch.save

    def recorded(obj, f, *a, **kw):
        if isinstance(f, (str, os.PathLike)):
            note(os.fspath(f))
        return save(obj, f, *a, **kw)

    torch.save = recorded
    return seen


TOOLS = ["relation.predictor=BGNNPredictor", "relation.rel_aware=True",
         "relation.mp_valid_pairs=8", "global_buffer_on=True", "solver.max_iter=2",
         "solver.val_period=1", "solver.checkpoint_period=1", "solver.seed=3"]


def case_tools(dp, inputs):
    """Both tools on two ranks: training BGNN (``rel_aware``, the global
    buffer on) with validation and checkpoints, then evaluating its last
    checkpoint with the gather; rank 0 then evaluates it alone."""
    from veto_tpu_torch.engine import distributed
    from veto_tpu_torch.tools import relation_test_net
    from veto_tpu_torch.tools.relation_train_net import train
    from veto_tpu_torch.utils import global_buffer

    out = os.path.join(inputs["directory"], "out")
    written = _written(out)
    cfg = toy_config("veto_vg_predcls.yaml", TOOLS + [f"output_dir={out}"])
    stored = []
    store = global_buffer.store_data

    def counted(key, val, mask=None):
        stored.append((key, int(mask.sum())))
        store(key, val, mask)

    global_buffer.store_data = counted
    state, history = train(cfg, "cpu", log=lambda s: None)
    agg, _ = relation_test_net.evaluate(cfg, "cpu", log=lambda s: None)
    result = {"history": history, "params": params(state.model), "stored": stored,
              "written": sorted(set(written)), "aggregate": agg,
              "generator": state.generator.get_state(),
              "optimizer": state.optimizer.inner.state_dict()}
    global_buffer.store_data = store
    global_buffer.reset()
    dp.barrier()
    alone = (lambda device=None: (None, torch.device("cpu")))
    saved = distributed.init_from_env
    # a checkpoint of one process restored by the two ranks: rank 0 alone
    # trains 1 step into ``resumed``, then both ranks go on to step 2
    resumed = cfg.override("output_dir", os.path.join(inputs["directory"], "resumed"))
    if dp.rank == 0:
        distributed.init_from_env = alone
        try:  # the same evaluation in one process, then the 2 steps
            result["one"] = relation_test_net.evaluate(cfg, "cpu",
                                                       log=lambda s: None)[0]
            train(resumed.override("solver.max_iter", 1), "cpu", log=lambda s: None)
        finally:
            distributed.init_from_env = saved
    dp.barrier()
    lines = []
    state, history = train(resumed, "cpu", log=lines.append)
    result["resumed"] = {"lines": lines, "history": history,
                         "params": params(state.model), "step": state.step}
    global_buffer.reset()
    return result


def main(argv):
    directory, rank, world, cases = argv[1], int(argv[2]), int(argv[3]), argv[4]
    import torch.distributed as dist

    from veto_tpu_torch.engine.distributed import DataParallel

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{directory}/rendezvous",
                            rank=rank, world_size=world)
    try:
        dp = DataParallel()
        inputs_path = os.path.join(directory, "inputs.pt")
        deadline = time.monotonic() + 300
        while not os.path.exists(inputs_path):
            if time.monotonic() > deadline:
                raise TimeoutError("no inputs from the parent")
            time.sleep(0.05)
        inputs = torch.load(inputs_path, weights_only=False)
        for case in cases.split(","):
            out = globals()[f"case_{case}"](dp, inputs.get(case))
            torch.save(out, os.path.join(directory, f"{case}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
