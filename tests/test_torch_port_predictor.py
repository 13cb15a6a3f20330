"""Port parity for the VETO predictor, pair preparation, post-processing,
the evaluator, the config loader and the synthetic corpus."""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import veto_tpu.ops.fused_encoder as jfe
from veto_tpu.config import load_config as j_load_config
from veto_tpu.data.synthetic import SyntheticSGGDataset as JSynthetic
from veto_tpu.evaluation.sgg_eval import SGGEvaluator as JEvaluator
from veto_tpu.evaluation.sgg_eval import vg_longtail_parts as j_parts
from veto_tpu.models.relation.postprocess import postprocess_relations as j_post
from veto_tpu.models.relation.predictor_veto import VetoPredictor as JPredictor
from veto_tpu.models.relation.sampling import prepare_test_pairs as j_pairs

from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.config import load_config
from veto_tpu_torch.data.synthetic import SyntheticSGGDataset
from veto_tpu_torch.evaluation.sgg_eval import SGGEvaluator, vg_longtail_parts
from veto_tpu_torch.models.relation.postprocess import postprocess_relations
from veto_tpu_torch.models.relation.predictor_veto import VetoPredictor
from veto_tpu_torch.models.relation.sampling import prepare_test_pairs
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_OBJ, NUM_REL = 11, 7
SMALL = dict(embed_dim=200, dim=48, layers=2, heads=6, patch_size=2,
             depth_proj_dim=32, visual_proj_dim=16)


@pytest.fixture
def interpret():
    jfe.INTERPRET = True
    yield
    jfe.INTERPRET = False


def _perturb_stats(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_stats(v, rng)
        elif k == "var":
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k == "mean":
            out[k] = (rng.randn(*v.shape) * 10).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def test_veto_predictor_matches_jax_f32(interpret):
    """rel_logits for the same pooled maps and pairs: the fused encoder on
    the JAX side (interpret), the port's plain layer on the other."""
    rng = np.random.RandomState(0)
    b, n, p, c_rgb, c_dep = 2, 6, 10, 32, 256
    x1y1 = rng.uniform(0, 40, (b, n, 2))
    boxes = np.concatenate([x1y1, x1y1 + rng.uniform(2, 30, (b, n, 2))],
                           -1).astype(np.float32)
    box_mask = np.array([[1] * 6, [1] * 4 + [0] * 2], bool)
    labels = (rng.randint(1, NUM_OBJ, (b, n)) * box_mask).astype(np.int32)
    pair_idx = rng.randint(0, n, (b, p, 2)).astype(np.int32)
    pair_mask = np.ones((b, p), bool)
    roi = rng.randn(b, n, 8, 8, c_rgb).astype(np.float32)
    dep = rng.randn(b, n, 8, 8, c_dep).astype(np.float32)
    logits = np.zeros((b, n, NUM_OBJ), np.float32)

    jp = JPredictor(num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL, **SMALL,
                    dtype=jnp.float32, remat=False, encoder_impl="fused")
    args = [jnp.asarray(a) for a in (boxes, box_mask, labels, logits, pair_idx,
                                     pair_mask, roi, dep)]
    variables = jp.clone(encoder_impl="xla").init(jax.random.PRNGKey(0), *args)
    variables = {"params": variables["params"],
                 "batch_stats": _perturb_stats(variables["batch_stats"], rng)}
    ref = np.asarray(jp.apply(variables, *args).rel_logits)

    sd = flax_to_state_dict(variables)
    tp = VetoPredictor(NUM_OBJ, NUM_REL, **SMALL, rgb_channels=c_rgb,
                       depth_channels=c_dep, dtype=torch.float32).eval()
    tp.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = tp(*[torch.from_numpy(a) for a in (boxes, box_mask, labels,
                                                   pair_idx, roi, dep)])
    assert tuple(out.rel_logits.shape) == (b, p, NUM_REL)
    np.testing.assert_allclose(out.rel_logits.numpy(), ref, atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(out.obj_dists.numpy(),
                                  np.eye(NUM_OBJ, dtype=np.float32)[labels])


def test_prepare_test_pairs_matches_jax():
    rng = np.random.RandomState(1)
    mask = np.array([[1] * 5 + [0] * 3, [1] * 8, [1, 0] * 4], bool)
    scores = np.where(mask, rng.choice([0.5, 0.25, 1.0], mask.shape), 0.0
                      ).astype(np.float32)
    for max_pairs in (20, 100):  # capped below n*n, padded above it
        got_idx, got_mask = prepare_test_pairs(
            torch.from_numpy(mask), torch.from_numpy(scores), max_pairs)
        for i in range(len(mask)):
            ref_idx, ref_mask = j_pairs(jnp.asarray(mask[i]),
                                        jnp.asarray(scores[i]),
                                        max_pairs=max_pairs)
            np.testing.assert_array_equal(got_idx[i].numpy(), np.asarray(ref_idx))
            np.testing.assert_array_equal(got_mask[i].numpy(), np.asarray(ref_mask))


def test_postprocess_relations_matches_jax():
    rng = np.random.RandomState(2)
    b, p, n = 2, 12, 5
    rel_logits = rng.randn(b, p, NUM_REL).astype(np.float32)
    rel_logits[0, 3] = rel_logits[0, 7]  # an exact tie keeps index order
    labels = rng.randint(1, NUM_OBJ, (b, n))
    obj = (np.eye(NUM_OBJ, dtype=np.float32)[labels] * 2000 - 1000)
    obj[1, 2] = rng.randn(NUM_OBJ)  # a soft row too
    pair_idx = rng.randint(0, n, (b, p, 2)).astype(np.int32)
    pair_mask = rng.rand(b, p) > 0.3
    got = postprocess_relations(*[torch.from_numpy(a) for a in
                                  (rel_logits, obj, pair_idx, pair_mask)])
    for i in range(b):
        ref = j_post(*[jnp.asarray(a[i]) for a in
                       (rel_logits, obj, pair_idx, pair_mask)])
        for name in ("pair_idx", "pair_mask", "rel_labels", "obj_labels"):
            np.testing.assert_array_equal(getattr(got, name)[i].numpy(),
                                          np.asarray(getattr(ref, name)), name)
        for name in ("rel_scores", "obj_scores"):
            np.testing.assert_allclose(getattr(got, name)[i].numpy(),
                                       np.asarray(getattr(ref, name)),
                                       atol=1e-6, err_msg=name)


def test_evaluator_matches_jax():
    ds = SyntheticSGGDataset(num_images=4, image_size=(64, 64), seed=3)
    rng = np.random.RandomState(3)
    jev = JEvaluator("predcls", 51, longtail_parts=j_parts())
    tev = SGGEvaluator("predcls", 51, longtail_parts=vg_longtail_parts())
    assert vg_longtail_parts() == j_parts()
    for i in range(len(ds)):
        rec = ds[i]
        n = len(rec["boxes"])
        pairs = np.array([(s, o) for s in range(n) for o in range(n) if s != o])
        rel = rng.dirichlet(np.ones(51), len(pairs)).astype(np.float32)
        args = (rec["boxes"], rec["labels"], rec["rel_tuples"], rec["boxes"],
                rec["labels"], np.ones(n), pairs, rel)
        jev.add_image(*args)
        tev.add_image(*args)
    assert tev.aggregate() == jev.aggregate()
    assert tev.summary_string() == jev.summary_string()


def test_synthetic_records_match_jax():
    kw = dict(num_images=3, image_size=(48, 80), max_objects=12, seed=5)
    tds, jds = SyntheticSGGDataset(**kw), JSynthetic(**kw)
    assert len(tds) == len(jds) == 3
    for i in range(len(tds)):
        a, b = tds[i], jds[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs",
                                                               "*.yaml"))))
def test_config_loader_matches_jax(path):
    opts = ["solver.base_lr=2e-4", "model.stage_blocks=(1,1,1,1)"]
    assert load_config(path, opts).to_dict() == j_load_config(path, opts).to_dict()
