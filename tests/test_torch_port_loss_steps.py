"""The relation loss variants in one whole PredCls step against the JAX
package's ``make_train_step(loss_variant=...)`` on the CPU: its samples fed
to the port's ``train_on_pairs``, its optimizer one that keeps its raw
gradients and updates nothing, on a small model with the Naive relation
head (no encoder: the variants act on the relation logits alone), the JAX
step in float64 (the union features' BatchNorm sums in flax's f32 are the
imprecise side, ``torch_port_legacy_case.UNION``): ``rel_loss`` and
``loss`` 1e-5, the gradient norm 1e-5, every gradient 1e-4 of its tensor's
largest |g|, the balanced norm's new running probability 1e-6.  The
functions alone, the resume and the scope: ``test_torch_port_loss_variants.py``.
"""

import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import veto_tpu.ops.losses as jl
from veto_tpu.engine.batch import SGGBatch as JBatch
from veto_tpu.engine.train import TrainState as JTrainState
from veto_tpu.engine.train import make_train_step as j_make_train_step
from veto_tpu.models.relation.sampling import gtbox_relsample as j_relsample
from veto_tpu.models.sgg import SGGModel as JModel

from torch_port_det_steps import compiled, keep_grads
from torch_port_legacy_case import NUM_REL, TINY, ZERO_GRAD, class_weights, fill, scaled
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.config import SolverConfig
from veto_tpu_torch.data.predicate_stats import predicate_counts
from veto_tpu_torch.data.synthetic import SyntheticSGGDataset
from veto_tpu_torch.engine.train import create_train_state, train_on_pairs
from veto_tpu_torch.models.relation.sampling import RelSample
from veto_tpu_torch.models.sgg import SGGModel
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict

PAIRS, VARIANTS = 16, ("label_smoothing", "ldam", "balanced_norm")


@functools.lru_cache(maxsize=None)
def naive_case():
    """A small PredCls model with the Naive head, its filled variables (f32)
    and a synthetic batch of 2 images."""
    ds = SyntheticSGGDataset(num_images=2, image_size=(64, 96), num_obj_classes=8,
                             num_rel_classes=NUM_REL, max_objects=6, min_objects=4,
                             max_relations=6, seed=11)
    batch, _ = next(ds.batches(2, 8))
    fields = batch.fields()
    jm = JModel(mode="predcls", predictor="NaivePredictor", num_rel_classes=NUM_REL,
                **TINY, pooler_impl="separable")
    args = tuple(jnp.asarray(fields[k]) for k in ("images", "depth", "boxes", "box_mask",
                                                   "labels", "obj_logits"))
    args += (jnp.zeros((2, PAIRS, 2), jnp.int32), jnp.ones((2, PAIRS), bool))
    shapes = jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a), *args)
    return batch, fill(shapes, seed=2)


def _solver(cls):
    return cls(ims_per_batch=2, base_lr=1e-3, bias_lr_factor=2.0, weight_decay=0.3,
               weight_decay_bias=0.05, grad_clip_norm=5.0)


def _jax_samples(key, rel_matrix, box_mask):
    """The pairs ``make_train_step`` samples at step 0."""
    keys = jax.random.split(jax.random.fold_in(key, 0), rel_matrix.shape[0])
    return jax.vmap(lambda k, r, m: j_relsample(k, r, m, batch_size=PAIRS,
                                                positive_fraction=0.25))(
        keys, rel_matrix, box_mask)


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_step_matches_jax_make_train_step(variant):
    batch, v = naive_case()
    cw = class_weights()
    margins = jl.ldam_margins(predicate_counts("VG")[:NUM_REL], 0.5) \
        if variant == "ldam" else None
    running = np.full(NUM_REL, 0.03, np.float32)
    running[0] = 1.0
    key, lr_scale = jax.random.PRNGKey(5), 0.5
    with jax.enable_x64(True):
        f64 = functools.partial(jax.tree.map, lambda a: jnp.asarray(
            a, jnp.float64 if np.asarray(a).dtype == np.float32 else None))
        jbatch = JBatch(**f64(batch.fields()))
        params, stats = f64(v["params"]), f64(v["batch_stats"])
        jm = JModel(mode="predcls", predictor="NaivePredictor", num_rel_classes=NUM_REL,
                    **TINY, pooler_impl="separable", dtype=jnp.float64)
        # the step's raw gradients kept, no update traced: the comparison is
        # of the losses, the gradients and the loss state
        tx = keep_grads(optax.inject_hyperparams(lambda lr_scale: optax.scale(0.0))(
            lr_scale=1.0))
        jstate = JTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                             batch_stats=stats, opt_state=jax.jit(tx.init)(params), rng=key,
                             loss_state=jnp.asarray(running, jnp.float64)
                             if variant == "balanced_norm" else None)
        step = j_make_train_step(jm, tx, cw, batch_size_per_image=PAIRS,
                                 positive_fraction=0.25, mode="predcls",
                                 loss_variant=variant, ldam_margins=margins)
        lr = jnp.asarray(lr_scale, jnp.float64)
        new, metrics = compiled(step, jstate, jbatch, lr)(jstate, jbatch, lr)
        js = jax.jit(_jax_samples)(key, jbatch.rel_matrix, jbatch.box_mask)
        metrics, jgrads = jax.tree.map(np.asarray, (metrics, new.opt_state[1]))
        new_running = None if new.loss_state is None else np.asarray(new.loss_state)
    samples = RelSample(*(torch.from_numpy(np.array(a))
                          for a in (js.pair_idx, js.labels, js.mask)))

    model = SGGModel(mode="predcls", predictor="NaivePredictor", num_rel_classes=NUM_REL,
                     **TINY, dtype=torch.float32)
    missing, unexpected = model.load_state_dict(flax_to_state_dict(v), strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    state = create_train_state(model, _solver(SolverConfig), cw, loss_variant=variant,
                               ldam_margins=margins)
    m = train_on_pairs(state, batch.to("cpu"), samples, lr_scale)
    for k in ("rel_loss", "loss"):
        np.testing.assert_allclose(float(m[k]), float(metrics[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(m["grad_norm"]), float(metrics["grad_norm"]),
                               rtol=1e-5)
    norm = float(optax.global_norm(jgrads))
    clip = 1.0 if norm < 5.0 else 5.0 / norm
    ref = flax_to_state_dict({"params": jax.tree.map(lambda g: g * clip, jgrads)})
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert {n.split(".")[0] for n in trained} == {"relation", "rel_box_extractor",
                                                   "union_extractor"}
    floor = ZERO_GRAD * max(float(ref[n].abs().max()) for n in trained)
    for n, p in trained.items():
        if float(ref[n].abs().max()) <= floor:  # 0 analytically (a bias under BN)
            assert float(p.grad.abs().max()) <= floor, n
            continue
        scaled(p.grad, ref[n].numpy(), 1e-4, f"{variant} {n}")
    if variant == "balanced_norm":
        assert not np.array_equal(new_running, running)
        np.testing.assert_allclose(state.loss_state.numpy(), new_running, rtol=0,
                                   atol=1e-6)
        assert float(state.loss_state[0]) == 1.0
    else:
        assert state.loss_state is None and new_running is None
