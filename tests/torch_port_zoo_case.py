"""Helpers the rest-of-the-zoo tests share (``test_torch_port_causal*.py``,
``test_torch_port_agcn.py``, ``test_torch_port_loss_variants.py``,
``test_torch_port_zoo_rest_tools.py``), on ``torch_port_legacy_case``'s
case:

- the causal predictor's JAX model, its filled variables (its untreated
  averages among their ``batch_stats``, nonzero) and the port model that
  loads them through the weight bridge;
- :func:`narrow_agrcnn`: AGRCNN's graph cut from its fixed 1024 to
  ``GRAPH`` in the port (and the JAX package), as the attention contexts'
  depth is cut in ``torch_port_legacy_case.shallow_attention``;
- :func:`resume_matches_one_run`: the train tool's k steps, a checkpoint,
  k more after a restore, against 2k engine steps in one process.
"""

import functools
import os

import torch

import jax
import jax.numpy as jnp

from veto_tpu.models.sgg import SGGModel as JModel

from torch_port_legacy_case import NUM_REL, TINY, fill, make_inputs, relate_args

from veto_tpu_torch.config import load_config
from veto_tpu_torch.engine.train import create_train_state, train_step
from veto_tpu_torch.models.relation import legacy as tlegacy
from veto_tpu_torch.models.sgg import SGGModel, build_model
from veto_tpu_torch.solver.optim import LRController
from veto_tpu_torch.tools.relation_train_net import (
    batches_for, build_dataset, rel_class_weights, train,
)
from veto_tpu_torch.utils.checkpoint import CheckpointManager
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAUSAL = "CausalAnalysisPredictor"
GRAPH = 32  # AGRCNN's graph width in the tests


def causal_kw(effect, fusion):
    return dict(causal_effect_type=effect, causal_fusion_type=fusion)


def causal_jax_model(mode, effect, fusion, dtype=jnp.float32):
    return JModel(mode=mode, predictor=CAUSAL, num_rel_classes=NUM_REL, **TINY,
                  dtype=dtype, pooler_impl="separable", **causal_kw(effect, fusion))


@functools.lru_cache(maxsize=None)
def causal_variables(mode, effect, fusion):
    """The filled variables of the configuration's ``relate`` tree (the
    untreated averages among its ``batch_stats``)."""
    jm = causal_jax_model(mode, effect, fusion)
    shapes = jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a,
                                               method="relate"),
                            *relate_args(make_inputs()))
    return fill(shapes, seed=3)


def causal_port_model(mode, effect, fusion, v):
    """The port model with the JAX weights: every leaf of its relation head
    loads, the untreated averages too."""
    model = SGGModel(mode=mode, predictor=CAUSAL, num_rel_classes=NUM_REL, **TINY,
                     dtype=torch.float32, **causal_kw(effect, fusion)).eval()
    missing, unexpected = model.load_state_dict(flax_to_state_dict(v), strict=False)
    assert not unexpected, unexpected
    assert all(k.startswith(("backbone.", "rpn.", "box_"))
               or k.endswith("num_batches_tracked") for k in missing), missing
    return model


def narrow_agrcnn(monkeypatch, jax_too=True):
    """Build AGRCNN with a ``GRAPH``-wide graph in the port (and, with
    ``jax_too``, in the JAX package) until the test ends: the same code at
    a width that keeps the CPU runs and the JAX compiles short (1024 in
    every model the JAX package builds, no config key)."""
    if jax_too:
        from veto_tpu.models.relation import legacy as jlegacy

        base = jlegacy.AGRCNNPredictor
        narrow = type("AGRCNNPredictor", (base,), {
            "__annotations__": {"graph_hidden_dim": int}, "graph_hidden_dim": GRAPH})
        monkeypatch.setattr(jlegacy, "AGRCNNPredictor", narrow)
    monkeypatch.setitem(tlegacy.PREDICTORS, "AGRCNNPredictor",
                        functools.partial(tlegacy.AGRCNNPredictor, graph_hidden_dim=GRAPH))


def resume_matches_one_run(tmp_path, config, opts, k=2):
    """The train tool's k steps, its checkpoint, a second run that restores
    it and takes k more, against 2k steps of ``train_step`` on the same
    stream in one process (the resumed run's stream is
    ``iterations(2k, start_iter=k)``, as in ``test_torch_port_resume.py``),
    on one thread: the model's ``state_dict`` (buffers included), Adam's
    state, the loss state and the generator bit-equal.  Returns the resumed
    state and the checkpoint's payload."""
    def cfg_of(out, steps):
        return load_config(config, opts + [f"output_dir={out}",
                                           f"solver.max_iter={steps}",
                                           f"solver.checkpoint_period={k}"])

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train(cfg_of(tmp_path / "a", k), "cpu", log=lambda *_: None)
        resumed, second = train(cfg_of(tmp_path / "a", 2 * k), "cpu",
                                log=lambda *_: None)
        assert resumed.step == 2 * k and len(second) == k
        cfg = cfg_of(tmp_path / "b", 2 * k)
        ref = create_train_state(build_model(cfg, "cpu"), cfg.solver,
                                 rel_class_weights(cfg), mode=cfg.relation.mode,
                                 loss_variant=resumed.loss_variant)
        ref.generator = torch.Generator().manual_seed(cfg.solver.seed)
        ctrl = LRController(cfg.solver)
        for lo, hi in ((0, k), (k, 2 * k)):
            gen = batches_for(cfg, build_dataset(cfg, "train"), "train")
            for it, (batch, _) in enumerate(gen(hi, lo), start=lo):
                train_step(ref, batch.to("cpu"), ref.generator, ctrl.scale(it),
                           cfg.relation.batch_size_per_image,
                           cfg.relation.positive_fraction)
    finally:
        torch.set_num_threads(threads)
    sa, sb = resumed.model.state_dict(), ref.model.state_dict()
    assert sa.keys() == sb.keys()
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name
    oa, ob = resumed.optimizer.inner.state_dict(), ref.optimizer.inner.state_dict()
    for i in oa["state"]:
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(oa["state"][i][key], ob["state"][i][key]), (i, key)
    assert (resumed.loss_state is None) == (ref.loss_state is None)
    if ref.loss_state is not None:
        assert torch.equal(resumed.loss_state, ref.loss_state)
    assert torch.equal(resumed.generator.get_state(), ref.generator.get_state())
    return resumed, CheckpointManager(str(tmp_path / "a" / "ckpt")).load()
