"""Port parity for the greedy NMS family (``veto_tpu_torch/ops/nms.py``):
``nms``, ``nms_sequential``, ``batched_nms`` and ``multiclass_nms_mask``
against the JAX package's on the same numpy inputs, the top-k tie rule,
and kernel N1's host-side rules (its refusals, its shared-memory mirror).

On the CPU the walk is the plain blockwise version; keep sets and their
order must equal JAX's exactly (the IoU is f32 in the same order of
operations on both sides).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from veto_tpu.ops import nms as jn

from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.models.detector.rpn import topk_first
from veto_tpu_torch.ops import cuda_lib
from veto_tpu_torch.ops import nms as tn


def _boxes(rng, n, span=60.0, size=30.0):
    xy = rng.uniform(0, span, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(1, size, (n, 2))], 1).astype(np.float32)


def _case(name, rng):
    """(boxes, scores, valid) of one named case."""
    n = 150
    boxes = _boxes(rng, n)
    scores = rng.rand(n).astype(np.float32)
    valid = np.ones(n, bool)
    if name == "pure ties":
        scores[:] = 0.5
    elif name == "bf16 scores":
        # the RPN head's bf16 logits through a sigmoid: few distinct values
        logits = jnp.asarray(rng.randn(n) * 2, jnp.bfloat16).astype(jnp.float32)
        scores = np.array(jax.nn.sigmoid(logits))
    elif name == "duplicates":
        boxes = np.repeat(boxes[:15], 10, 0)
        scores = np.round(scores, 1)
    elif name == "masked":
        valid = rng.rand(n) > 0.4
    elif name == "n not a block multiple":
        boxes, scores, valid = boxes[:77], scores[:77], valid[:77]
    return boxes, scores, valid


CASES = ["random", "pure ties", "bf16 scores", "duplicates", "masked",
         "n not a block multiple"]


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("max_outputs", [5, 40, 1000])
@pytest.mark.parametrize("case", CASES)
def test_nms_matches_jax(case, max_outputs, early_exit):
    """``nms`` (blockwise, block 16) equals JAX's ``nms`` and
    ``nms_sequential`` in keep set and order, and ``nms_sequential`` of the
    port equals JAX's; ``max_outputs`` cuts, ``early_exit`` both ways."""
    rng = np.random.RandomState(CASES.index(case))
    boxes, scores, valid = _case(case, rng)
    jb, js, jv = jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid)
    ji, jo = jn.nms(jb, js, 0.5, max_outputs, jv, block=16, early_exit=early_exit)
    si, so = jn.nms_sequential(jb, js, 0.5, max_outputs, jv)
    tb, ts, tv = (torch.from_numpy(a) for a in (boxes, scores, valid))
    ti, to = tn.nms(tb, ts, 0.5, max_outputs, tv, block=16, early_exit=early_exit)
    for ref_i, ref_o in ((ji, jo), (si, so)):
        np.testing.assert_array_equal(to.numpy(), np.asarray(ref_o))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ref_i))
    qi, qo = tn.nms_sequential(tb, ts, 0.5, max_outputs, tv)
    np.testing.assert_array_equal(qi.numpy(), np.asarray(si))
    np.testing.assert_array_equal(qo.numpy(), np.asarray(so))
    assert to.any()


def test_nms_batches_problems_as_one_call_each():
    """Leading axes are independent problems: one batched call equals one
    call per problem (the RPN's (image, level) walks)."""
    rng = np.random.RandomState(7)
    boxes = np.stack([np.stack([_boxes(rng, 90) for _ in range(3)]) for _ in range(2)])
    scores = rng.rand(2, 3, 90).astype(np.float32)
    valid = rng.rand(2, 3, 90) > 0.2
    idx, ok = tn.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.7, 30,
                     torch.from_numpy(valid), early_exit=True)
    assert idx.shape == (2, 3, 30) and idx.dtype == torch.int32
    for i in range(2):
        for j in range(3):
            ji, jo = jn.nms(jnp.asarray(boxes[i, j]), jnp.asarray(scores[i, j]),
                            0.7, 30, jnp.asarray(valid[i, j]), early_exit=True)
            np.testing.assert_array_equal(idx[i, j].numpy(), np.asarray(ji))
            np.testing.assert_array_equal(ok[i, j].numpy(), np.asarray(jo))


@pytest.mark.parametrize("ties", [False, True])
def test_multiclass_nms_mask_matches_jax(ties):
    """(image, class) problems: the per-class keep mask, score threshold,
    per-class budget and box mask equal to JAX's (vmapped over images)."""
    rng = np.random.RandomState(3 + ties)
    b, n, c = 2, 60, 6
    xy = rng.uniform(0, 60, (b, n, c, 2))
    bpc = np.concatenate([xy, xy + rng.uniform(1, 30, (b, n, c, 2))], -1
                         ).astype(np.float32)
    sc = rng.rand(b, n, c).astype(np.float32)
    if ties:
        sc = np.round(sc, 1)
    vm = rng.rand(b, n) > 0.15
    got = tn.multiclass_nms_mask(torch.from_numpy(bpc), torch.from_numpy(sc),
                                 0.05, 0.3, 7, torch.from_numpy(vm))
    assert got.shape == (b, n, c)
    for i in range(b):
        ref = jn.multiclass_nms_mask(jnp.asarray(bpc[i]), jnp.asarray(sc[i]), 0.05,
                                     0.3, 7, jnp.asarray(vm[i]), block=16)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref))
    assert got.sum() > 0 and (got.sum(1) <= 7).all()


def test_batched_nms_matches_jax():
    """Class-aware NMS by the coordinate offset: boxes of different ids
    never suppress each other."""
    rng = np.random.RandomState(5)
    boxes = _boxes(rng, 80)
    scores = rng.rand(80).astype(np.float32)
    ids = rng.randint(0, 4, 80).astype(np.int32)
    ji, jo = jn.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                            jnp.asarray(ids), 0.4, 50)
    ti, to = tn.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                            torch.from_numpy(ids), 0.4, 50)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("k", [1, 7, 64])
def test_topk_tie_rule_matches_lax_top_k(k):
    """Among equal values the lower index comes first, as ``jax.lax.top_k``
    orders them: pure ties, and ties inside a list of few distinct values
    with -inf entries."""
    rng = np.random.RandomState(k)
    for x in (np.zeros((3, 64), np.float32),
              np.where(rng.rand(3, 64) < 0.3, -np.inf,
                       np.round(rng.rand(3, 64), 1)).astype(np.float32)):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = topk_first(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_greedy_keep_plain_walk_matches_sequential_on_sorted_problems():
    """The plain walk over G sorted problems at several block sizes equals
    the one-box-a-trip walk; the budget cuts later keeps only."""
    rng = np.random.RandomState(11)
    boxes = torch.from_numpy(np.stack([_boxes(rng, 130) for _ in range(4)]))
    scores = torch.from_numpy(np.round(rng.rand(4, 130), 2).astype(np.float32))
    live = torch.where(torch.from_numpy(rng.rand(4, 130) > 0.1), scores, tn._NEG_INF)
    sboxes, order, active = tn._sorted_problems(boxes, live)
    ref_i, ref_o = tn.nms_sequential(sboxes, torch.where(active, 1.0 - torch.arange(
        130) / 1000.0, 0.0), 0.6, 1000, active)
    full = tn.reference_greedy_keep(sboxes, active, 0.6, 1000, block=130)
    for block in (1, 16, 64, 512):
        keep = tn.greedy_keep_sorted(sboxes, active, 0.6, 1000, block=block)
        assert torch.equal(keep, full), block
    for g in range(4):
        assert torch.equal(full[g].nonzero()[:, 0], ref_i[g][ref_o[g]].long())
    cut = tn.greedy_keep_sorted(sboxes, active, 0.6, 9)
    assert torch.equal(cut, full & (full.cumsum(1) <= 9))


def test_kernel_wrapper_refuses_what_it_cannot_take(monkeypatch):
    """Kernel N1's wrapper refuses, before any library is loaded: tensors
    off the card (TypeError), non-contiguous or mistyped boxes, a mask of
    another shape, more problems than the grid takes, and an N whose scan
    words exceed the shared memory it plans for (ValueError)."""
    def no_library(name):
        raise AssertionError("a library was loaded")

    monkeypatch.setattr(cuda_lib, "library", no_library)
    boxes = torch.rand(2, 100, 4)
    active = torch.ones(2, 100, dtype=torch.bool)
    with pytest.raises(TypeError, match="CUDA"):
        tn._launch_greedy(boxes, active, 0.5, 10)
    with pytest.raises(ValueError, match="contiguous"):
        tn._launch_greedy(torch.rand(2, 4, 100).transpose(1, 2), active, 0.5, 10)
    with pytest.raises(ValueError, match="float32"):
        tn._launch_greedy(boxes.double(), active, 0.5, 10)
    with pytest.raises(ValueError, match="active"):
        tn._launch_greedy(boxes, active[:, :50], 0.5, 10)
    with pytest.raises(ValueError, match="problems"):
        tn._launch_greedy(torch.rand(tn.MAX_PROBLEMS + 1, 1, 4),
                          torch.ones(tn.MAX_PROBLEMS + 1, 1, dtype=torch.bool), 0.5, 1)
    big = 64 * (tn.SCAN_SMEM_MAX // (tn.SCAN_WARPS * 16)) + 1
    with pytest.raises(ValueError, match="shared memory"):
        tn._launch_greedy(torch.rand(1, big, 4), torch.ones(1, big, dtype=torch.bool),
                          0.5, 10)
    # the CPU walk needs no library
    assert tn.greedy_keep_sorted(boxes, active, 0.5, 10).sum() > 0


def test_scan_shared_memory_mirror():
    """The scan's shared memory (Python mirror of ``nms_scan_smem_bytes``):
    two words a 64-box block for each of the block's warps; the RPN's 6000
    and the largest N it plans for fit, one more block does not."""
    assert tn.mask_words(6000) == 94 and tn.mask_words(64) == 1
    assert tn.scan_smem_bytes(6000) == tn.SCAN_WARPS * 2 * 94 * 8
    largest = 64 * (tn.SCAN_SMEM_MAX // (tn.SCAN_WARPS * 16))
    assert tn.scan_smem_bytes(largest) == tn.SCAN_SMEM_MAX
    assert tn.scan_smem_bytes(largest + 1) > tn.SCAN_SMEM_MAX
