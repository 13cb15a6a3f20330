"""Port parity for the backward of the two kernel modules: the encoder layer
(the split backward, passes A and B) and ROIAlign.

The JAX side differentiates its own entry points: ``jax.grad`` through
``fused_encoder_layer`` reaches the Pallas split backward in the
interpreter; ``jax.grad`` through ``roi_align`` and ``multilevel_roi_align``
is autodiff of the separable pooler.  The port differentiates its
``torch.autograd.Function``s, whose backward on CPU tensors is the plain
version of each kernel.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import veto_tpu.ops.fused_encoder as jfe
from veto_tpu.ops.roi_align import multilevel_roi_align as j_multilevel
from veto_tpu.ops.roi_align import roi_align as j_roi_align

from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.ops import fused_encoder as tfe
from veto_tpu_torch.ops.roi_align_windowed import multilevel_roi_align_batched

SCALES = (0.25, 0.125, 0.0625, 0.03125)
P, T, D, F, H = 8, 19, 96, 192, 6


@pytest.fixture
def interpret():
    jfe.INTERPRET = True
    yield
    jfe.INTERPRET = False


# ------------------------------------------------------------- encoder layer
def _enc_params(rng, d=D, f=F):
    mk = lambda *s: (rng.randn(*s) * 0.1).astype(np.float32)  # noqa: E731
    return dict(ln1_scale=mk(d) + 1, ln1_bias=mk(d), w_qkv=mk(d, 3 * d),
                w_out=mk(d, d), b_out=mk(d), ln2_scale=mk(d) + 1,
                ln2_bias=mk(d), w1=mk(d, f), b1=mk(f), w2=mk(f, d), b2=mk(d))


def _grads_both(p, x, w, t_pad, mat_dtype):
    """(JAX grads, port grads) of sum(layer(x) * w) w.r.t. x and params,
    with x and the matrices in ``mat_dtype``, the vectors f32."""
    jdt = jnp.bfloat16 if mat_dtype == torch.bfloat16 else jnp.float32
    jp = jfe.EncoderLayerParams(**{
        k: jnp.asarray(v, jdt if v.ndim == 2 else jnp.float32)
        for k, v in p.items()})

    def jloss(x, params):
        y = jfe.fused_encoder_layer(x, params, H, t_pad, T, 4)
        return (y.astype(jnp.float32) * jnp.asarray(w)).sum()

    jdx, jdp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x, jdt), jp)

    tx = torch.from_numpy(x).to(mat_dtype).requires_grad_()
    tp = tfe.EncoderLayerParams(**{
        k: torch.from_numpy(v).to(mat_dtype if v.ndim == 2 else torch.float32)
        .requires_grad_() for k, v in p.items()})
    y = tfe.fused_encoder_layer(tx, tp, H, t_pad, T)
    (y.float() * torch.from_numpy(w)).sum().backward()
    ref = {"x": np.asarray(jdx.astype(jnp.float32))}
    ref.update({k: np.asarray(getattr(jdp, k).astype(jnp.float32))
                for k in p})
    got = {"x": tx.grad}
    got.update({k: getattr(tp, k).grad for k in p})
    return ref, got


@pytest.mark.parametrize("t_pad", [24, 19])
def test_encoder_backward_matches_jax_split_bwd_f32(interpret, t_pad):
    rng = np.random.RandomState(10)
    p = _enc_params(rng)
    x = rng.randn(P * t_pad, D).astype(np.float32)
    w = rng.randn(P * t_pad, D).astype(np.float32)
    ref, got = _grads_both(p, x, w, t_pad, torch.float32)
    # the JAX kernel test's own tolerances (tests/test_fused_encoder.py):
    # f32 sums in another order
    np.testing.assert_allclose(got["x"].numpy(), ref["x"], atol=2e-5, rtol=0)
    for k in p:
        assert got[k].dtype == torch.float32
        scale = max(1.0, float(np.abs(ref[k]).max()))
        np.testing.assert_allclose(got[k].numpy() / scale, ref[k] / scale,
                                   atol=3e-6, rtol=0, err_msg=k)


def test_encoder_backward_matches_jax_split_bwd_bf16(interpret):
    """bf16 activations and matrices: the same rounding points, so the
    grads differ by rounding flips and sum order; matrix grads come back in
    bf16, as ``_bwd_split`` casts them."""
    t_pad = 24
    rng = np.random.RandomState(11)
    p = _enc_params(rng)
    x = rng.randn(P * t_pad, D).astype(np.float32)
    w = rng.randn(P * t_pad, D).astype(np.float32)
    ref, got = _grads_both(p, x, w, t_pad, torch.bfloat16)
    assert got["x"].dtype == torch.bfloat16
    for k in p:
        assert got[k].dtype == (torch.bfloat16 if p[k].ndim == 2 else torch.float32)
    # a flipped bf16 rounding moves a value by one bf16 ulp (2^-8 relative,
    # 4e-3); measured: max 3.2e-3 and mean 3.8e-5 of each grad's scale
    for k in ["x"] + list(p):
        a, b = got[k].float().numpy(), ref[k]
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, atol=1e-2 * scale, rtol=0, err_msg=k)
        assert np.abs(a - b).mean() < 2e-4 * scale, k


def test_encoder_inference_keeps_no_graph():
    """Without a gradient the layer is a plain call: no autograd node."""
    rng = np.random.RandomState(12)
    p = tfe.EncoderLayerParams(**{k: torch.from_numpy(v)
                                  for k, v in _enc_params(rng).items()})
    x = torch.from_numpy(rng.randn(P * T, D).astype(np.float32))
    y = tfe.fused_encoder_layer(x, p, H, T, T)
    assert y.grad_fn is None
    np.testing.assert_array_equal(
        y.numpy(), tfe.reference_encoder_layer(x, p, H, T, T).numpy())


# ------------------------------------------------------------------ ROIAlign
def _rois(rng, b=2):
    """Rois on all four levels, partly off the map, off it entirely,
    degenerate (< 1 px) and a zero padding box."""
    base = np.array([
        [10, 20, 60, 70],        # P2
        [100, 80, 250, 230],     # P3
        [50, 40, 350, 340],      # P4
        [10, 5, 500, 495],       # P5
        [-30, -20, 40, 60],      # off the top-left corner
        [470, 480, 560, 590],    # off the bottom-right corner
        [600, 620, 700, 720],    # off the map
        [200.2, 100.7, 200.5, 100.9],  # degenerate
        [0, 0, 0, 0],            # padding
    ], np.float32)
    out = np.stack([base + rng.uniform(-3, 3, base.shape).astype(np.float32)
                    for _ in range(b)])
    out[:, -2:] = base[-2:]  # no jitter: it could invert the < 1 px box
    return out


def test_roi_align_backward_single_level_matches_jax():
    """The depth path: the gradient of one 1/16 map."""
    rng = np.random.RandomState(20)
    feat = rng.randn(2, 32, 32, 8).astype(np.float32)
    rois = _rois(rng)
    g = rng.randn(2, rois.shape[1], 8, 8, 8).astype(np.float32)

    def jloss(f):
        out = jax.vmap(lambda fi, ri: j_roi_align(fi, ri, 0.0625, 8, 2))(
            f, jnp.asarray(rois))
        return (out * jnp.asarray(g)).sum()

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(feat)))
    tf = torch.from_numpy(feat).requires_grad_()
    out = multilevel_roi_align_batched([tf], torch.from_numpy(rois), (0.0625,), 8, 2)
    (out * torch.from_numpy(g)).sum().backward()
    assert np.abs(ref).max() > 0.1
    # f32 sums of the same products in another order
    np.testing.assert_allclose(tf.grad.numpy(), ref, atol=1e-5, rtol=0)


def test_roi_align_backward_multilevel_matches_jax():
    rng = np.random.RandomState(21)
    feats = [rng.randn(2, 512 // s, 512 // s, 8).astype(np.float32)
             for s in (4, 8, 16, 32)]
    rois = _rois(rng)
    g = rng.randn(2, rois.shape[1], 8, 8, 8).astype(np.float32)

    def jloss(fs, i):
        out = j_multilevel(list(fs), jnp.asarray(rois[i]), SCALES, 8, 2)
        return (out * jnp.asarray(g[i])).sum()

    tfs = [torch.from_numpy(f).requires_grad_() for f in feats]
    out = multilevel_roi_align_batched(tfs, torch.from_numpy(rois), SCALES, 8, 2)
    (out * torch.from_numpy(g)).sum().backward()
    for i in range(2):
        ref = jax.grad(jloss)(tuple(jnp.asarray(f[i]) for f in feats), i)
        for lvl, (t, r) in enumerate(zip(tfs, ref)):
            r = np.asarray(r)
            assert np.abs(r).max() > 0.1, lvl  # every level pools something
            np.testing.assert_allclose(t.grad[i].numpy(), r, atol=1e-5, rtol=0,
                                       err_msg=f"image {i} level {lvl}")


def test_roi_align_backward_only_where_needed():
    """Maps that need no gradient get none, the rois never do, and a call
    without gradients records no graph."""
    rng = np.random.RandomState(22)
    feats = [torch.from_numpy(rng.randn(1, 128 // s, 128 // s, 4)
                              .astype(np.float32)) for s in (4, 8)]
    rois = torch.tensor([[[4.0, 4.0, 60.0, 60.0], [0.0, 0.0, 128.0, 128.0]]],
                        requires_grad=True)
    feats[1].requires_grad_()
    out = multilevel_roi_align_batched(feats, rois, SCALES[:2], 4, 2)
    out.sum().backward()
    assert feats[0].grad is None and rois.grad is None
    assert feats[1].grad.abs().sum() > 0
    with torch.no_grad():
        assert multilevel_roi_align_batched(
            feats, rois, SCALES[:2], 4, 2).grad_fn is None
