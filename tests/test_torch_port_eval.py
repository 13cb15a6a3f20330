"""The whole PredCls slice: one synthetic batch through the port's eval step
and the JAX package's ``make_eval_step``, f32, with parameters from the JAX
model's ``init`` through the weight bridge, then through both evaluators.

The JAX model runs its fused encoder in the Pallas interpreter and the
separable pooler (``_pool_boxes`` passes no ``interpret`` flag to the
windowed one; the two poolers share their semantics).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import veto_tpu.ops.fused_encoder as jfe
from veto_tpu.engine.batch import SGGBatch as JBatch
from veto_tpu.engine.train import make_eval_step as j_make_eval_step
from veto_tpu.evaluation.sgg_eval import SGGEvaluator as JEvaluator
from veto_tpu.models.sgg import SGGModel as JModel

from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.data.synthetic import SyntheticSGGDataset
from veto_tpu_torch.engine.evaluate import (
    accumulate_eval, make_eval_step, to_numpy,
)
from veto_tpu_torch.evaluation.sgg_eval import SGGEvaluator
from veto_tpu_torch.models.sgg import SGGModel
from veto_tpu_torch.utils.jax_weights import load_flax_variables

NUM_OBJ, NUM_REL = 11, 7
MAX_BOXES, MAX_PAIRS = 8, 48  # 48 < 8 * 8: the pair cap is exercised
SMALL = dict(num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL,
             stage_blocks=(1, 1, 1, 1), groups=4, width_per_group=4,
             fpn_channels=32, veto_dim=48, veto_layers=2, veto_heads=6,
             veto_depth_proj_dim=32, veto_visual_proj_dim=16, embed_dim=200,
             fold_bn=True)


@pytest.fixture
def interpret():
    jfe.INTERPRET = True
    yield
    jfe.INTERPRET = False


def _perturb_stats(tree, rng):
    """Non-trivial BN running statistics (init leaves mean 0, var 1)."""
    if isinstance(tree, dict):
        return {k: _perturb_stats(v, rng) if isinstance(v, dict) else (
            rng.uniform(0.5, 2.0, v.shape) if k == "var"
            else rng.randn(*v.shape) * 0.1).astype(np.float32)
            for k, v in tree.items()}
    return tree


def test_eval_step_matches_jax_f32(interpret):
    ds = SyntheticSGGDataset(num_images=2, image_size=(64, 64),
                             num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL,
                             max_objects=6, min_objects=3, seed=11)
    batch, recs = next(ds.batches(2, MAX_BOXES))
    jbatch = JBatch(**{k: jnp.asarray(v) for k, v in batch.fields().items()})

    jm = JModel(mode="predcls", **SMALL, dtype=jnp.float32,
                veto_encoder_impl="fused", pooler_impl="separable",
                veto_remat=False)
    pairs0 = jnp.zeros((2, MAX_PAIRS, 2), jnp.int32)
    variables = jm.clone(veto_encoder_impl="xla").init(
        jax.random.PRNGKey(0), jbatch.images, jbatch.depth, jbatch.boxes,
        jbatch.box_mask, jbatch.labels, jbatch.obj_logits, pairs0,
        jnp.ones((2, MAX_PAIRS), bool), train=False)
    rng = np.random.RandomState(0)
    variables = {"params": jax.tree.map(np.asarray, variables["params"]),
                 "batch_stats": _perturb_stats(
                     jax.tree.map(np.asarray, variables["batch_stats"]), rng)}
    state = types.SimpleNamespace(**variables)
    ref = jax.device_get(j_make_eval_step(jm, max_pairs=MAX_PAIRS)(state, jbatch))

    model = SGGModel(**SMALL, dtype=torch.float32).eval()
    load_flax_variables(model, variables)
    got = to_numpy(make_eval_step(model, max_pairs=MAX_PAIRS)(batch.to("cpu")))

    assert got.pair_idx.shape == (2, MAX_PAIRS, 2)
    assert got.pair_mask.sum() == sum(len(r["boxes"]) * (len(r["boxes"]) - 1)
                                      for r in recs)
    for name in ("pair_idx", "pair_mask", "rel_labels", "obj_labels"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(ref, name)), name)
    # f32 through the backbone, pooler and two encoder layers: summation
    # order only; softmax probabilities agree to 1e-5, the GT-injected
    # object scores are exactly 1
    np.testing.assert_allclose(got.rel_scores, np.asarray(ref.rel_scores),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.obj_scores, np.asarray(ref.obj_scores))

    jev = JEvaluator("predcls", NUM_REL)
    tev = SGGEvaluator("predcls", NUM_REL)
    for i, rec in enumerate(recs):
        n, pm = len(rec["boxes"]), np.asarray(ref.pair_mask[i])
        jev.add_image(rec["boxes"], rec["labels"], rec["rel_tuples"],
                      rec["boxes"], np.asarray(ref.obj_labels[i][:n]),
                      np.asarray(ref.obj_scores[i][:n]),
                      np.asarray(ref.pair_idx[i][pm]),
                      np.asarray(ref.rel_scores[i][pm]))
    accumulate_eval(got, recs, tev)
    assert tev.aggregate() == jev.aggregate()
