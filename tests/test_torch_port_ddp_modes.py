"""Data-parallel training of the port on two gloo ranks against the port's
one-process step on the same global batch of 4 images (2 a rank), in
every configuration that runs on several ranks: VETO PredCls, SGCls and
SGDet (the detections the frozen detector makes of each rank's images),
VETO PredCls with the plain encoder (``veto.encoder_impl=xla``), MEET
PredCls, BGNN with ``relation.rel_aware`` PredCls
(``tests/torch_port_ddp_worker.py``: one process a rank, one thread).

Each rank draws from the same seeded generator at the global batch's size
and keeps its rows: the samples (SGDet: the detections and every field of
the pair sample) are bit-equal to the one-process draw, and the
generator's state after the step (MEET's routing draws included) is the
one-process generator's.  Losses 1e-6 relative; every gradient 1e-5 of
its tensor's largest |g|; the BatchNorm running statistics 1e-6; after the
step the ranks' parameters are bit-equal.  BGNN's relness diagnostics
(the global buffer's rows) are the one-process step's.

Each rule of the two-rank step, taken away alone, moves the step beyond
those tolerances: per-rank BatchNorm statistics (the depth ResNet's
gradients), each rank's own denominators, DDP's averaged gradients.
"""

import pytest
import torch

import torch_port_ddp_worker as worker
from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

MODES = ("predcls", "sgcls", "sgdet", "meet", "bgnn", "xla")
FAULTS = ("per_rank_stats", "local_denominators", "averaged_grads")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return worker.run_ranks(tmp_path_factory.mktemp("modes"), MODES + FAULTS)


def _worst(got, ref):
    """Each tensor's largest |got - ref| over its largest |ref|.  A bias
    whose gradient is zero up to rounding (its largest |g| under 1e-4 of
    its layer's weight's: a bias under a train-mode BatchNorm, whose mean
    subtraction cancels it) is measured against its layer's weight's."""
    def scale(n):
        s = float(ref[n].abs().max())
        w = n[: -len("bias")] + "weight"
        if n.endswith(".bias") and w in ref:
            sw = float(ref[w].abs().max())
            if s < 1e-4 * sw:
                return sw
        return s

    return {n: float((got[n] - r).abs().max()) / scale(n) for n, r in ref.items()
            if scale(n) > 0}


@pytest.mark.parametrize("mode", MODES)
def test_two_ranks_match_one_process(runs, mode):
    r0, r1 = (r["ranks"] for r in runs[mode])
    one = runs[mode][0]["one"]
    for k, v in one["samples"].items():
        assert torch.equal(torch.cat([r0["samples"][k], r1["samples"][k]]), v), k
    for r in (r0, r1):
        assert torch.equal(r["generator"], one["generator"])
        assert set(r["losses"]) == set(one["losses"])
        for k, v in one["losses"].items():
            assert r["losses"][k] == pytest.approx(v, rel=1e-6, abs=1e-12), k
        assert r["grad_norm"] == pytest.approx(one["grad_norm"], rel=1e-5)
        assert set(r["grads"]) == set(one["grads"])
        worst = _worst(r["grads"], one["grads"])
        assert max(worst.values()) < 1e-5, sorted(worst.items(), key=lambda x: -x[1])[:4]
        assert set(r["batch_stats"]) == set(one["batch_stats"])
        for k, v in one["batch_stats"].items():
            torch.testing.assert_close(r["batch_stats"][k], v, atol=1e-6, rtol=1e-6,
                                       msg=k)
    for n, p in r0["params"].items():
        assert torch.equal(p, r1["params"][n]), n
    assert (one["buffer"] is None) == (mode != "bgnn")
    if one["buffer"] is not None:
        for k, v in one["buffer"].items():
            got = torch.cat([r0["buffer"][k], r1["buffer"][k]])
            torch.testing.assert_close(got, v, atol=1e-6, rtol=0, msg=k)


@pytest.mark.parametrize("fault,moves", [
    ("per_rank_stats", "depth_backbone."),
    ("local_denominators", "relation."),
    ("averaged_grads", None),
])
def test_each_rule_of_the_step_is_needed(runs, fault, moves):
    """Without cross-rank BatchNorm the depth ResNet's gradients leave the
    step's tolerance, without global denominators the relation head's.
    DDP's averaged gradients are 1/W of the step's: the global norm (the
    clip's input, reported as ``grad_norm``) halves; the clipped update
    stays only while the norm exceeds ``solver.grad_clip_norm``."""
    one = runs["predcls"][0]["one"]
    got = runs[fault][0]
    if moves is None:
        assert got["grad_norm"] == pytest.approx(one["grad_norm"] / 2, rel=1e-5)
        return
    worst = _worst(got["grads"], {n: g for n, g in one["grads"].items()
                                  if n.startswith(moves)})
    assert max(worst.values()) > 1e-3, fault
