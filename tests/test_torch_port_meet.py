"""Port parity for MEET: the routing constants, the in-group labels, the
routing's rules, the per-group losses, the single and voting
post-processing, the grouped-expert predictor, a PredCls train step, the
PredCls eval step through ``accumulate_eval``, an SGDet eval batch on
given detections, and a resumed run, against the JAX package.

The sizes are ``tests/test_meet.py``'s: 11 object / 12 predicate classes,
groups (3, 4, 4), a 64x64 image, a tiny body; the trunk 48 wide, 2
layers, 6 heads, f32.  The JAX model runs its ``xla`` encoder, the port
its default ``fused`` one (the plain versions of the kernels, on the
CPU).  ``meet_route`` cannot repeat ``jax.random``'s draws: the losses are
held to JAX's on JAX's own membership (``meet_losses(member=)``) and the
port's draw to the routing's rules.
"""

import functools
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from veto_tpu.data import predicate_stats as jstats
from veto_tpu.engine.batch import SGGBatch as JBatch
from veto_tpu.engine.train import TrainState as JTrainState
from veto_tpu.engine.train import make_meet_eval_step as j_make_meet_eval_step
from veto_tpu.evaluation.sgg_eval import SGGEvaluator as JEvaluator
from veto_tpu.models.detector.box_head import Detections as JDetections
from veto_tpu.models.relation import predictor_meet as jmeet
from veto_tpu.models.relation.sampling import gtbox_relsample as j_relsample
from veto_tpu.models.sgg import DetectOutput as JDetectOutput
from veto_tpu.models.sgg import SGGModel as JModel

from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.config import SolverConfig, load_config
from veto_tpu_torch.data import predicate_stats as stats
from veto_tpu_torch.data.synthetic import SyntheticSGGDataset
from veto_tpu_torch.engine.evaluate import (
    MeetEval, accumulate_eval, make_meet_eval_step, to_numpy,
)
from veto_tpu_torch.engine.train import (
    create_train_state, sample_pairs, train_on_pairs, train_step,
)
from veto_tpu_torch.evaluation.sgg_eval import SGGEvaluator
from veto_tpu_torch.models.detector.box_head import Detections
from veto_tpu_torch.models.relation import predictor_meet as meet
from veto_tpu_torch.models.relation.sampling import RelSample
from veto_tpu_torch.models.sgg import DetectOutput, SGGModel, build_model
from veto_tpu_torch.solver.optim import FROZEN_DETECTOR, LRController
from veto_tpu_torch.tools.relation_train_net import (
    batches_for, build_dataset, build_meet_config, train,
)
from veto_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_variables

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import relation_train_net as jtool  # noqa: E402  (the JAX tool)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_OBJ, NUM_REL, GROUPS = 11, 12, (3, 4, 4)
MAX_BOXES, PAIRS = 6, 16
TINY = dict(num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL,
            stage_blocks=(1, 1, 1, 1), groups=1, width_per_group=16,
            fpn_channels=32, veto_dim=48, veto_layers=2, veto_heads=6,
            veto_depth_proj_dim=32, veto_visual_proj_dim=16)
TRUNK = dict(embed_dim=200, dim=48, layers=2, heads=6, patch_size=2,
             depth_proj_dim=32, visual_proj_dim=16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _scaled(got, ref, tol, what):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, atol=tol * max(float(np.abs(ref).max()), 1e-6),
                               rtol=0, err_msg=what)


def _tiny_cfg(experts=1, voting="C", rate=None):
    """``tests/test_meet.py``'s constants: groups (3, 4, 4) over 12
    predicates, all-ones thresholds unless ``rate`` is given."""
    incre = stats.incre_idx_list(list(GROUPS), NUM_REL)
    rate = np.ones((len(GROUPS), NUM_REL), np.float32) if rate is None else rate
    return meet.MeetConfig(GROUPS, incre, rate, experts, voting)


# ------------------------------------------------------- routing constants
SPLITS = [("VG", k) for k in stats._VG_SPLITS] + [("GQA", k) for k in stats._GQA_SPLITS]


@pytest.mark.parametrize("dataset,split", SPLITS)
def test_routing_constants_match_jax(dataset, split):
    """Every split of VG and GQA-200: the groups, the 1-based group of each
    predicate and the (G, C) thresholds, exactly; ``make_meet_config``
    field by field."""
    assert stats.get_group_splits(dataset, split) == jstats.get_group_splits(dataset, split)
    sizes = stats.get_group_splits(dataset, split)[1]
    n = len(stats.predicate_counts(dataset))
    got = stats.generate_sample_rate_matrix(dataset, sizes)
    ref = jstats.generate_sample_rate_matrix(dataset, sizes)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(stats.incre_idx_list(sizes, n),
                                  jstats.incre_idx_list(sizes, n))
    for expert_group, voting in ((False, "C"), (True, "U")):
        a = meet.make_meet_config(dataset, split, expert_group, voting)
        b = jmeet.make_meet_config(dataset, split, expert_group, voting)
        assert (a.group_sizes, a.experts_per_group, a.voting) == (
            b.group_sizes, b.experts_per_group, b.voting)
        np.testing.assert_array_equal(a.incre_idx, b.incre_idx)
        np.testing.assert_array_equal(a.sample_rate, b.sample_rate)


def test_generate_group_splits_matches_jax():
    """Group sizes for a dataset of one's own, from VG's and GQA's counts
    and from a made-up tail (VG gives divide4)."""
    rng = np.random.RandomState(0)
    cases = [stats.predicate_counts("VG")[1:], stats.predicate_counts("GQA")[1:],
             np.sort(rng.randint(1, 5000, 40))[::-1], [], [7]]
    for counts in cases:
        assert stats.generate_group_splits(counts) == jstats.generate_group_splits(counts)
    assert stats.generate_group_splits(stats.predicate_counts("VG")[1:]) == [4, 6, 9, 19, 12]


def test_build_meet_config_serves_or_refuses_every_value():
    """The tool's ``build_meet_config``: off without ``ensemble.enabled``; GQA's
    groups for a GQA dataset; ``ensemble.voting`` outside C/U and a
    ``zero_label_padding_mode`` other than rand_insert raise (the JAX
    package reads an unknown vote as 'U' and ignores the padding mode)."""
    cfg = os.path.join(REPO, "configs", "veto_meet_vg_predcls.yaml")
    assert build_meet_config(load_config(cfg, ["ensemble.enabled=false"])) is None
    vg = build_meet_config(load_config(cfg))
    assert vg.group_sizes == (4, 6, 9, 19, 12) and vg.experts_per_group == 1
    gqa = build_meet_config(load_config(os.path.join(REPO, "configs",
                                                     "gqa_meet_predcls.yaml")))
    assert gqa.group_sizes == (5, 10, 20, 65) and gqa.incre_idx.shape == (101,)
    three = build_meet_config(load_config(cfg, ["ensemble.expert_group=true",
                                                "ensemble.voting=U"]))
    assert three.experts_per_group == 3 and three.voting == "U"
    with pytest.raises(ValueError, match="voting"):
        build_meet_config(load_config(cfg, ["ensemble.voting=X"]))
    with pytest.raises(ValueError, match="zero_label_padding_mode"):
        build_meet_config(load_config(cfg, ["ensemble.zero_label_padding_mode=none"]))


# ------------------------------------------------------ training pieces
def test_meet_group_labels_match_jax():
    """In-group labels of every predicate, the background and padding."""
    labels = np.array([[0, 1, 3, 4, 7, 8, 11, -1], [5, 2, 0, -1, 9, 10, 6, 1]])
    got = meet.meet_group_labels(_t(labels), GROUPS)
    ref = jmeet.meet_group_labels(jnp.asarray(labels), GROUPS)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _prefix_rows(member):
    on = [np.where(row)[0] for row in member]
    return all((o == np.arange(len(o))).all() for o in on), [len(o) for o in on]


def test_meet_route_invariants():
    """The port's own draw: padded pairs go to no group, background pairs
    to exactly one (each group drawn), a foreground pair to a prefix of
    the groups that covers every group below its own; with all-ones
    thresholds the prefix is all groups.  Draws come from the generator:
    the same seed, the same membership."""
    rng = np.random.RandomState(3)
    labels = rng.randint(-1, NUM_REL, (4, 200))
    labels[:, :40] = 0
    mask = labels >= 0
    lt, mt = _t(labels), _t(mask)
    cfg = _tiny_cfg()
    member = meet.meet_route(torch.Generator().manual_seed(0), lt, mt,
                             cfg.incre_idx, cfg.sample_rate).numpy()
    again = meet.meet_route(torch.Generator().manual_seed(0), lt, mt,
                            cfg.incre_idx, cfg.sample_rate).numpy()
    np.testing.assert_array_equal(member, again)
    assert member.shape == labels.shape + (3,) and member.dtype == bool
    assert not member[~mask].any()
    bg = member[labels == 0]
    assert (bg.sum(-1) == 1).all() and bg.any(0).all()
    assert member[labels > 0].all()
    vg = meet.make_meet_config("VG", "divide4")
    labels = np.tile(np.arange(-1, 51), 40)
    member = meet.meet_route(torch.Generator().manual_seed(1), _t(labels),
                             _t(labels >= 0), vg.incre_idx, vg.sample_rate).numpy()
    assert not member[labels < 0].any() and (member[labels == 0].sum(-1) == 1).all()
    fg = labels > 0
    prefix, lengths = _prefix_rows(member[fg])
    assert prefix
    assert (np.asarray(lengths) >= vg.incre_idx[labels[fg]] - 1).all()
    # the thresholds bite: a head predicate is not always taken to the last group
    assert not member[labels == 1].all()


@pytest.mark.parametrize("experts", [1, 3])
def test_meet_losses_on_jax_member_match_jax(experts):
    """Per-(expert, group) losses on JAX's own routing draw, fed in as
    ``member``: keys in JAX's order, values at rtol 1e-6; a group no pair
    reached is 0 (not NaN) in both."""
    rng = np.random.RandomState(experts)
    b, p = 2, 24
    labels = rng.randint(-1, NUM_REL, (b, p)).astype(np.int32)
    labels[:, :4] = 0
    mask = labels >= 0
    logits = [[(rng.randn(b, p, gs + 2) * 2).astype(np.float32) for gs in GROUPS]
              for _ in range(experts)]
    vg_like = np.ones((3, NUM_REL), np.float32)
    vg_like[:, 1:4] = 0.3
    cfg = _tiny_cfg(experts, rate=vg_like)
    key = jax.random.PRNGKey(4)
    args = (jnp.asarray(labels), jnp.asarray(mask), jnp.asarray(cfg.incre_idx),
            jnp.asarray(cfg.sample_rate))
    member = np.asarray(jax.jit(jmeet.meet_route)(key, *args))
    jlosses = jax.jit(functools.partial(jmeet.meet_losses, group_sizes=GROUPS))
    jlogits = tuple(tuple(jnp.asarray(x) for x in e) for e in logits)
    ref = jlosses(key, jlogits, *args)
    got = meet.meet_losses(None, [[_t(x) for x in e] for e in logits], _t(labels),
                           _t(mask), cfg.incre_idx, cfg.sample_rate, GROUPS,
                           member=_t(member))
    assert list(got) == [f"group_{k}{e + 1}_CE_loss" for e in range(experts)
                         for k in range(3)]  # JAX's insertion order
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6, err_msg=k)
    # no pair routed anywhere: every loss 0 in both
    none = np.zeros_like(member)
    got0 = meet.meet_losses(None, [[_t(x) for x in e] for e in logits], _t(labels),
                            _t(mask), cfg.incre_idx, cfg.sample_rate, GROUPS,
                            member=_t(none))
    ref0 = jlosses(key, jlogits, args[0], args[1] & False, args[2], args[3])
    assert all(float(v) == 0.0 for v in got0.values())
    assert all(float(v) == 0.0 for v in ref0.values())


# -------------------------------------------------------- post-processing
def _post_inputs(seed, experts, b=2, p=20, n=6):
    """Group logits on a coarse grid (exact ties between in-group classes
    and across pairs), object scores with ties, masked pairs."""
    rng = np.random.RandomState(seed)
    logits = [[(np.round(rng.randn(b, p, gs + 2) * 2) / 2).astype(np.float32)
               for gs in GROUPS] for _ in range(experts)]
    logits[0][0][:, :4] = 1.0  # whole rows tied: every class, every pair
    scores = np.round(rng.rand(b, n), 1).astype(np.float32)
    scores[:, 0] = scores[:, 1]
    obj_labels = rng.randint(1, NUM_OBJ, (b, n)).astype(np.int32)
    pair_idx = rng.randint(0, n, (b, p, 2)).astype(np.int32)
    pair_mask = rng.rand(b, p) > 0.25
    return logits, obj_labels, scores, pair_idx, pair_mask


def _check_prediction(got, ref_fn, b):
    for i in range(b):
        ref = ref_fn(i)
        for name in ("pair_idx", "rel_labels", "pair_mask", "obj_labels"):
            np.testing.assert_array_equal(getattr(got, name)[i].numpy(),
                                          np.asarray(getattr(ref, name)), name)
        for name in ("rel_scores", "obj_scores"):
            np.testing.assert_allclose(getattr(got, name)[i].numpy(),
                                       np.asarray(getattr(ref, name)), atol=1e-6,
                                       rtol=0, err_msg=name)


def test_postprocess_meet_single_matches_jax():
    """G·P candidates ranked by triple score with exact ties (the stable
    sort of ``jnp.argsort``, masked candidates last) and in-group classes
    that tie exactly (``jnp.argmax``'s first maximum): pairs, labels and
    mask exactly JAX's, scores at 1e-6."""
    logits, labels, scores, pi, pm = _post_inputs(0, 1)
    got = meet.postprocess_meet_single([_t(x) for x in logits[0]], _t(labels),
                                       _t(scores), _t(pi), _t(pm), GROUPS, NUM_REL)
    assert got.pair_idx.shape == (2, 3 * 20, 2) and got.rel_scores.shape == (2, 60, NUM_REL)
    ref = jax.jit(jax.vmap(lambda lg, lab, sc, p, m: jmeet.postprocess_meet_single(
        lg, lab, sc, p, m, GROUPS, NUM_REL)))(
        [jnp.asarray(x) for x in logits[0]], *(jnp.asarray(a) for a in (labels, scores,
                                                                        pi, pm)))
    _check_prediction(got, lambda i: jax.tree.map(lambda x: x[i], ref), 2)
    assert got.pair_mask.sum() == 3 * pm.sum()


@pytest.mark.parametrize("voting", ["C", "U"])
def test_postprocess_meet_voting_matches_jax(voting):
    """Three experts vote: consensus (two agreeing, the last agreeing pair's
    class) or unanimous; experts that agree on exactly tied classes, pairs
    masked by the vote or by the pair mask; exactly JAX's."""
    logits, labels, scores, pi, pm = _post_inputs(1, 3)
    # experts 0 and 2 agree everywhere in group 1; expert 1 copies expert 0
    # in group 2 on half the pairs
    logits[2][1] = logits[0][1].copy()
    logits[1][2][:, ::2] = logits[0][2][:, ::2]
    got = meet.postprocess_meet_voting(
        [[_t(x) for x in e] for e in logits], _t(labels), _t(scores), _t(pi),
        _t(pm), GROUPS, NUM_REL, voting)
    ref = jax.jit(jax.vmap(lambda lg, lab, sc, p, m: jmeet.postprocess_meet_voting(
        lg, lab, sc, p, m, GROUPS, NUM_REL, voting=voting)))(
        tuple(tuple(jnp.asarray(x) for x in e) for e in logits),
        *(jnp.asarray(a) for a in (labels, scores, pi, pm)))
    _check_prediction(got, lambda i: jax.tree.map(lambda x: x[i], ref), 2)
    kept = int(got.pair_mask.sum())
    assert 0 < kept < 3 * pm.sum()


# -------------------------------------------------------------- predictor
@pytest.mark.parametrize("mode,experts", [("predcls", 1), ("predcls", 3),
                                          ("sgcls", 1), ("sgcls", 3)])
def test_meet_predictor_matches_jax(mode, experts):
    """``MeetPredictor`` with bridged weights (every ``rel_out_e{e}_g{k}``
    and the trunk, loaded strictly): each head's logits within 1e-4 of
    their scale.  In SGCls the trunk embeds the given (predicted) labels,
    not the softmax of the logits (``hard_label_embed``)."""
    rng = np.random.RandomState(7)
    b, n, p = 2, 5, 12
    xy = rng.uniform(0, 40, (b, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 20, (b, n, 2))], -1).astype(np.float32)
    box_mask = np.ones((b, n), bool)
    box_mask[1, -1] = False
    labels = rng.randint(1, NUM_OBJ, (b, n)).astype(np.int32)
    obj_logits = (rng.randn(b, n, NUM_OBJ) * 3).astype(np.float32)
    pair_idx = rng.randint(0, n, (b, p, 2)).astype(np.int32)
    pair_mask = np.ones((b, p), bool)
    roi = rng.randn(b, n, 8, 8, 32).astype(np.float32)
    depth = rng.randn(b, n, 8, 8, 256).astype(np.float32)
    jm = jmeet.MeetPredictor(group_sizes=GROUPS, experts_per_group=experts,
                             num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL,
                             mode=mode, remat=False, encoder_impl="xla", **TRUNK)
    args = [jnp.asarray(a) for a in (boxes, box_mask, labels, obj_logits, pair_idx,
                                     pair_mask, roi, depth)]
    variables = jax.tree.map(np.asarray,
                             jax.jit(jm.init)(jax.random.PRNGKey(experts), *args))
    ref = jax.jit(jm.apply)(variables, *args)
    model = meet.MeetPredictor(GROUPS, experts, NUM_OBJ, rgb_channels=32,
                               depth_channels=256, dtype=torch.float32, mode=mode,
                               **TRUNK).eval()
    sd = flax_to_state_dict(variables)
    assert {f"rel_out_e{e}_g{k}.weight" for e in range(experts)
            for k in range(3)} <= set(sd)
    model.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(model.rel_out_e0_g2.weight.detach().numpy(),
                                  variables["params"]["rel_out_e0_g2"]["kernel"].T)
    with torch.no_grad():
        out = model(_t(boxes), _t(box_mask), _t(labels), _t(pair_idx), _t(roi),
                    _t(depth), _t(obj_logits))
    assert len(out.group_logits) == experts
    for e in range(experts):
        for k, gs in enumerate(GROUPS):
            assert out.group_logits[e][k].shape == (b, p, gs + 2)
            assert out.group_logits[e][k].dtype == torch.float32
            _scaled(out.group_logits[e][k], ref.group_logits[e][k], 1e-4, f"e{e} g{k}")
    np.testing.assert_array_equal(out.obj_dists.numpy(), np.asarray(ref.obj_dists))


# --------------------------------------------------- the model: steps
@pytest.fixture(scope="module")
def predcls_meet():
    """The tiny PredCls MEET model's flax variables, the port model with
    them, and a synthetic batch of 2 images."""
    ds = SyntheticSGGDataset(num_images=2, image_size=(64, 64),
                             num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL,
                             max_objects=MAX_BOXES - 2, min_objects=3,
                             max_relations=4, seed=11)
    batch, recs = next(ds.batches(2, MAX_BOXES))
    jb = JBatch(**{k: jnp.asarray(v) for k, v in batch.fields().items()})
    jm = JModel(mode="predcls", **TINY, meet_group_sizes=GROUPS, meet_experts=1,
                dtype=jnp.float32, veto_encoder_impl="xla", pooler_impl="separable",
                veto_remat=False, fold_bn=True)
    variables = jax.jit(functools.partial(jm.init, train=False))(
        jax.random.PRNGKey(0), jb.images, jb.depth, jb.boxes, jb.box_mask,
        jb.labels, jb.obj_logits, jnp.zeros((2, PAIRS, 2), jnp.int32),
        jnp.ones((2, PAIRS), bool))
    variables = jax.tree.map(np.asarray, variables)
    model = SGGModel(**TINY, meet_group_sizes=GROUPS, meet_experts=1,
                     dtype=torch.float32, fold_bn=True)
    load_flax_variables(model, variables)  # strict: every MEET head and the trunk
    return dict(jm=jm, variables=variables, batch=batch, recs=recs, jb=jb,
                model=model)


def _solver(cls):
    return cls(ims_per_batch=2, base_lr=1e-3, bias_lr_factor=2.0, weight_decay=0.3,
               weight_decay_bias=0.05, grad_clip_norm=5.0)


def test_predcls_meet_train_step_matches_jax(predcls_meet):
    """One PredCls MEET step: the samples and routing draw of JAX's
    ``make_train_step(meet=)`` (its keys: ``fold_in(rng, step)``, then
    ``fold_in(·, 1)`` for the routing), fed to the port's
    ``train_on_pairs(member=)``: every ``group_*`` loss and the total at
    1e-5 against that step's loss function (no Rwt weights: the class
    weights given are not used), the gradient norm at 1e-4, every
    trainable gradient within 1e-4 of its tensor's largest |g| against
    ``jax.grad`` of it; the detector unchanged."""
    s = predcls_meet
    jm, v, jb = s["jm"], s["variables"], s["jb"]
    params, bstats = v["params"], v["batch_stats"]
    cfg = _tiny_cfg(rate=np.full((3, NUM_REL), 0.5, np.float32))
    incre, rate = jnp.asarray(cfg.incre_idx), jnp.asarray(cfg.sample_rate)
    # make_train_step's samples and routing key at step 0 of rng 5
    step_rng = jax.random.fold_in(jax.random.PRNGKey(5), 0)
    keys = jax.random.split(step_rng, 2)
    js = jax.vmap(lambda k, r, m: j_relsample(k, r, m, batch_size=PAIRS,
                                              positive_fraction=0.25))(
        keys, jb.rel_matrix, jb.box_mask)
    route = jax.random.fold_in(step_rng, 1)
    member = jmeet.meet_route(route, js.labels, js.mask, incre, rate)
    assert np.asarray(member).any(axis=(0, 1)).all()

    def jloss(p):
        # make_train_step(meet=)'s loss_fn: _rel_losses' MEET branch
        out, _ = jm.apply({"params": p, "batch_stats": bstats}, jb.images, jb.depth,
                          jb.boxes, jb.box_mask, jb.labels, jb.obj_logits,
                          js.pair_idx, js.mask, train=True, mutable=["batch_stats"])
        losses = jmeet.meet_losses(route, out.rel_logits, js.labels, js.mask, incre,
                                   rate, GROUPS)
        return sum(losses.values()), losses

    (jl, jlosses), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    norm = float(np.sqrt(sum(float((np.asarray(g) ** 2).sum())
                             for g in jax.tree.leaves(jg))))
    clip = 1.0 if norm < 5.0 else 5.0 / norm
    ref = flax_to_state_dict({"params": jax.tree.map(lambda g: np.asarray(g) * clip, jg)})

    model = SGGModel(**TINY, meet_group_sizes=GROUPS, meet_experts=1,
                     dtype=torch.float32, fold_bn=True)
    load_flax_variables(model, v)
    detector = {k: t.clone() for k, t in model.backbone.state_dict().items()}
    cw = np.linspace(0.5, 2.0, NUM_REL).astype(np.float32)
    state = create_train_state(model, _solver(SolverConfig), cw, meet=cfg)
    assert state.meet.sample_rate.device == torch.device("cpu")
    samples = RelSample(*(_t(a) for a in (js.pair_idx, js.labels, js.mask)))
    m = train_on_pairs(state, s["batch"].to("cpu"), samples, 0.5, member=_t(member))
    keys_ = [f"group_{k}1_CE_loss" for k in range(3)]
    assert [k for k in m if k.endswith("loss")] == ["loss"] + keys_
    for k in keys_:
        np.testing.assert_allclose(float(m[k]), float(jlosses[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), norm, rtol=1e-4)
    trained = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    assert {n.split(".")[0] for n, _ in trained} == {"depth_backbone", "relation"}
    assert any("rel_out_e0_g2" in n for n, _ in trained)
    for n, p in trained:
        _scaled(p.grad, ref[n].numpy(), 1e-4, n)
    for k, t in model.backbone.state_dict().items():
        assert torch.equal(t, detector[k]), k


def _evaluators(mode):
    return SGGEvaluator(mode, NUM_REL), JEvaluator(mode, NUM_REL)


def _same_aggregate(tev, jev):
    got, ref = tev.aggregate(), jev.aggregate()
    for metric in ("R", "mR"):
        assert got[metric] == ref[metric], metric
    return got


def _with_ranked_relation(recs, pred, rank=10):
    """The records with one more GT relation each: the ``rank``-th ranked
    candidate of the prediction (seeded weights rarely rank a synthetic
    relation, and a recall of 0 would show nothing)."""
    out = []
    for i, rec in enumerate(recs):
        pi, lab = pred.pair_idx[i][rank], pred.rel_labels[i][rank]
        extra = np.array([[pi[0], pi[1], lab]], rec["rel_tuples"].dtype)
        out.append({**rec, "rel_tuples": np.concatenate([rec["rel_tuples"], extra])})
    return out


def test_predcls_meet_eval_step_recall_matches_jax(predcls_meet):
    """The PredCls MEET eval step end to end (test pairs, model, object
    labels from ``predict_logits``, ranking) against JAX's
    ``make_meet_eval_step``: the ranking's pairs, labels and mask exactly,
    scores at 1e-5, and the same R@K / mR@K through both tools'
    ``accumulate_eval``."""
    s = predcls_meet
    v, jb, recs = s["variables"], s["jb"], s["recs"]
    jcfg = jmeet.MeetConfig(GROUPS, stats.incre_idx_list(list(GROUPS), NUM_REL),
                            np.ones((3, NUM_REL), np.float32), 1, "C")
    jstate = JTrainState(step=0, params=v["params"], batch_stats=v["batch_stats"],
                         opt_state=None, rng=None)
    jstep = j_make_meet_eval_step(s["jm"], jcfg, max_pairs=MAX_BOXES * MAX_BOXES)
    jout = jax.device_get(jax.jit(jstep)(jstate, jb))
    step = make_meet_eval_step(s["model"].eval(), _tiny_cfg(),
                               max_pairs=MAX_BOXES * MAX_BOXES)
    got = step(s["batch"].to("cpu"))
    assert isinstance(got, MeetEval)
    preds = to_numpy(got)
    ref = jout[0]
    for name in ("pair_idx", "rel_labels", "pair_mask", "obj_labels"):
        np.testing.assert_array_equal(getattr(preds.prediction, name),
                                      np.asarray(getattr(ref, name)), name)
    for name in ("rel_scores", "obj_scores"):
        np.testing.assert_allclose(getattr(preds.prediction, name),
                                   np.asarray(getattr(ref, name)), atol=1e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(preds.boxes, np.asarray(jout[1]))
    recs = _with_ranked_relation(recs, preds.prediction)
    tev, jev = _evaluators("predcls")
    sizes = np.asarray(s["batch"].sizes)
    accumulate_eval(preds, recs, tev, sizes)
    jtool.accumulate_eval("meet", jout, recs, jev, input_sizes=sizes)
    agg = _same_aggregate(tev, jev)
    assert agg["R"][100] > 0


def test_sgdet_meet_eval_batch_on_given_detections_matches_jax():
    """One SGDet MEET eval batch, both packages fed the same detections
    (JAX through a model whose ``detect`` returns them, the port through
    the instance's ``detect``): the test pairs over the detections, the
    relation head, the late object NMS and the boxes it picks, the
    ranking, and R@K through both tools' ``accumulate_eval``."""
    rng = np.random.RandomState(2)
    b, d = 2, 8
    grid = np.stack(np.meshgrid(np.arange(4), np.arange(2)), -1).reshape(-1, 2) * 15.0
    boxes = np.concatenate([grid + 2, grid + 12], -1)[None].repeat(b, 0).astype(np.float32)
    det_mask = np.ones((b, d), bool)
    det_mask[1, -2:] = False
    logits = (rng.randn(b, d, NUM_OBJ) * 2).astype(np.float32)
    det_labels = logits[..., 1:].argmax(-1).astype(np.int32) + 1
    bpc = np.repeat(boxes[:, :, None], NUM_OBJ, 2) + rng.uniform(
        -0.5, 0.5, (b, d, NUM_OBJ, 4)).astype(np.float32)
    dets = dict(boxes=boxes, scores=rng.uniform(0.2, 1, (b, d)).astype(np.float32),
                labels=det_labels, mask=det_mask,
                orig_idx=np.tile(np.arange(d, dtype=np.int32), (b, 1)), boxes_per_cls=bpc)
    feats = [rng.randn(b, 64 // s_, 64 // s_, 32).astype(np.float32)
             for s_ in (4, 8, 16, 32, 64)]
    depth = rng.uniform(-1, 1, (b, 64, 64, 1)).astype(np.float32)

    class GivenDetections(JModel):
        def detect(self, images, image_sizes):
            return JDetectOutput(tuple(jnp.asarray(f) for f in feats),
                                 JDetections(**{k: jnp.asarray(a) for k, a in dets.items()}),
                                 jnp.asarray(logits))

    kw = dict(mode="sgdet", **TINY, meet_group_sizes=GROUPS, meet_experts=1,
              dtype=jnp.float32, veto_encoder_impl="xla", pooler_impl="separable",
              veto_remat=False, detections_per_img=d)
    jm = GivenDetections(**kw)
    pi0 = jnp.zeros((b, 4, 2), jnp.int32)
    variables = jax.tree.map(np.asarray, jax.jit(functools.partial(
        jm.init, method="relate"))(
        jax.random.PRNGKey(3), tuple(jnp.asarray(f) for f in feats), jnp.asarray(depth),
        jnp.asarray(boxes), jnp.asarray(det_mask), jnp.asarray(det_labels),
        jnp.asarray(logits), pi0, jnp.ones((b, 4), bool)))
    recs = [dict(boxes=boxes[i][det_mask[i]][:5], labels=det_labels[i][det_mask[i]][:5],
                 rel_tuples=np.array([[0, 1, 2], [1, 3, 5], [2, 4, 9], [4, 0, 11]]))
            for i in range(b)]
    images = jnp.zeros((b, 64, 64, 3), jnp.float32)
    sizes = np.full((b, 2), 64, np.int32)
    jcfg = jmeet.MeetConfig(GROUPS, stats.incre_idx_list(list(GROUPS), NUM_REL),
                            np.ones((3, NUM_REL), np.float32), 1, "C")
    jstate = JTrainState(step=0, params=variables["params"],
                         batch_stats=variables["batch_stats"], opt_state=None, rng=None)
    jstep = j_make_meet_eval_step(jm, jcfg, max_pairs=d * d, mode="sgdet")
    jout = jax.device_get(jax.jit(lambda st, im, sz, dp: jstep(st, SimpleNamespace(
        images=im, sizes=sz, depth=dp)))(jstate, images, jnp.asarray(sizes),
                                         jnp.asarray(depth)))

    model = SGGModel(mode="sgdet", **TINY, meet_group_sizes=GROUPS, meet_experts=1,
                     dtype=torch.float32, detections_per_img=d)
    missing, unexpected = model.load_state_dict(flax_to_state_dict(variables),
                                                strict=False)
    assert not unexpected and all(k.startswith(FROZEN_DETECTOR) or
                                  k.endswith("num_batches_tracked") for k in missing)
    model.detect = lambda images, image_sizes: DetectOutput(
        [_t(f) for f in feats], Detections(**{k: _t(a) for k, a in dets.items()}),
        _t(logits))
    tb = SimpleNamespace(images=torch.zeros(b, 64, 64, 3), sizes=_t(sizes),
                         depth=_t(depth))
    preds = to_numpy(make_meet_eval_step(model.eval(), _tiny_cfg(), max_pairs=d * d,
                                         mode="sgdet")(tb))
    ref = jout[0]
    for name in ("pair_idx", "rel_labels", "pair_mask", "obj_labels"):
        np.testing.assert_array_equal(getattr(preds.prediction, name),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_allclose(preds.prediction.rel_scores, np.asarray(ref.rel_scores),
                               atol=1e-5)
    np.testing.assert_array_equal(preds.boxes, np.asarray(jout[1]))
    np.testing.assert_array_equal(preds.det_mask, np.asarray(jout[2]))
    tev, jev = _evaluators("sgdet")
    accumulate_eval(preds, recs, tev, sizes)
    jtool.accumulate_eval("meet", jout, recs, jev, input_sizes=sizes)
    agg = _same_aggregate(tev, jev)
    assert agg["R"][100] > 0


# ------------------------------------------------------------------ resume
SMALL = ["model.stage_blocks=(1,1,1,1)", "veto.t_input_dim=48", "veto.enc_layers=2",
         "veto.depth_proj_dim=32", "veto.visual_proj_dim=16", "data.max_boxes=6",
         "data.min_size_train=32", "data.max_size_train=48", "data.min_size_test=32",
         "data.max_size_test=48", "data.size_divisibility=16",
         "relation.batch_size_per_image=16", "relation.max_proposal_pairs=30",
         "solver.ims_per_batch=2", "test.ims_per_batch=4", "dtype=float32"]


def test_meet_resume_is_bit_equal_to_the_same_stream(tmp_path):
    """The tool's MEET training: k steps, a checkpoint, a resumed run of k
    more equal k steps and k more on the resumed run's own stream with no
    save between (the routing draws from the checkpointed generator after
    the sampler's draws), on one CPU thread in f32; every step's record
    holds each group's loss, and the validations run MEET's eval step."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        k = 2
        config = os.path.join(REPO, "configs", "veto_meet_vg_predcls.yaml")
        opts = SMALL + [f"output_dir={tmp_path / 'a'}", f"solver.checkpoint_period={k}",
                        "solver.val_period=1", "solver.plateau_patience=100"]
        first_state, first = train(load_config(config, opts + [f"solver.max_iter={k}"]),
                                   "cpu", log=lambda line: None)
        assert all("val_mR100" in r for r in first)
        assert {f"group_{g}1_CE_loss" for g in range(5)} <= set(first[0])
        resumed, second = train(load_config(config, opts + [f"solver.max_iter={2 * k}"]),
                                "cpu", log=lambda line: None)
        assert len(second) == k and resumed.step == 2 * k

        cfg = load_config(config, SMALL + [f"output_dir={tmp_path / 'b'}"])
        ref = create_train_state(build_model(cfg, "cpu"), cfg.solver,
                                 mode=cfg.relation.mode, meet=build_meet_config(cfg))
        ref.generator = torch.Generator().manual_seed(cfg.solver.seed)
        ctrl = LRController(cfg.solver)
        for lo, hi in ((0, k), (k, 2 * k)):
            gen = batches_for(cfg, build_dataset(cfg, "train"), "train")
            for it, (batch, _) in enumerate(gen(hi, lo), start=lo):
                m = train_step(ref, batch.to("cpu"), ref.generator, ctrl.scale(it),
                               cfg.relation.batch_size_per_image,
                               cfg.relation.positive_fraction)
                rec = (first + second)[it]
                for key in rec:
                    if key.endswith("loss"):
                        assert float(m[key]) == rec[key], (it, key)
        sa, sb = resumed.model.state_dict(), ref.model.state_dict()
        for key in sa:
            assert torch.equal(sa[key], sb[key]), key
        assert torch.equal(resumed.generator.get_state(), ref.generator.get_state())
    finally:
        torch.set_num_threads(threads)


def test_meet_sampler_and_routing_share_the_generator():
    """``train_step``'s routing draws from the state's generator after the
    pair sampler's draws: the membership equals ``meet_route`` drawn on a
    generator advanced by the same sampling."""
    cfg = _tiny_cfg(rate=np.full((3, NUM_REL), 0.5, np.float32))
    ds = SyntheticSGGDataset(num_images=2, image_size=(64, 64), num_obj_classes=NUM_OBJ,
                             num_rel_classes=NUM_REL, max_objects=4, min_objects=3,
                             max_relations=4, seed=5)
    batch, _ = next(ds.batches(2, MAX_BOXES))
    tb = batch.to("cpu")
    g = torch.Generator().manual_seed(9)
    samples = sample_pairs(tb, g, PAIRS)
    want = meet.meet_route(g, samples.labels, samples.mask, cfg.incre_idx,
                           cfg.sample_rate)
    seen = {}
    real = meet.meet_route

    def spy(*args):
        seen["member"] = real(*args)
        return seen["member"]

    model = SGGModel(**TINY, meet_group_sizes=GROUPS, dtype=torch.float32)
    state = create_train_state(model, _solver(SolverConfig), meet=cfg)
    state.generator = torch.Generator().manual_seed(9)
    meet.meet_route = spy
    try:
        m = train_step(state, tb, state.generator, 1.0, PAIRS)
    finally:
        meet.meet_route = real
    assert torch.equal(seen["member"], want)
    assert all(np.isfinite(float(m[f"group_{k}1_CE_loss"])) for k in range(3))
