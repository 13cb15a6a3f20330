"""Port parity for the encoder layer's monolithic backward (B5): the
backward when ``FUSED_SPLIT`` is off, or when the forward kept no qkv/x1
stash (``FUSED_STASH`` off).

The JAX side differentiates ``fused_encoder_layer`` with its own
``FUSED_SPLIT`` off, so ``jax.grad`` reaches ``_bwd_kernel`` in the Pallas
interpreter, with and without the stash (``bwd_stash``).  The port
differentiates its ``torch.autograd.Function`` with its copies of the two
constants set the same way; on CPU tensors the backward is
``reference_mono_bwd``, B5's plain version.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import veto_tpu.ops.fused_encoder as jfe

from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.ops import fused_encoder as tfe

P, T, D, F, H = 8, 19, 96, 192, 6


@pytest.fixture
def mono():
    """Both packages' encoders with the split backward off (the JAX one in
    the Pallas interpreter); everything restored after."""
    saved = jfe.INTERPRET, jfe.FUSED_SPLIT, tfe.FUSED_SPLIT, tfe.FUSED_STASH
    jfe.INTERPRET, jfe.FUSED_SPLIT, tfe.FUSED_SPLIT = True, False, False
    yield
    jfe.INTERPRET, jfe.FUSED_SPLIT, tfe.FUSED_SPLIT, tfe.FUSED_STASH = saved


def _enc_params(rng, d=D, f=F):
    mk = lambda *s: (rng.randn(*s) * 0.1).astype(np.float32)  # noqa: E731
    return dict(ln1_scale=mk(d) + 1, ln1_bias=mk(d), w_qkv=mk(d, 3 * d),
                w_out=mk(d, d), b_out=mk(d), ln2_scale=mk(d) + 1,
                ln2_bias=mk(d), w1=mk(d, f), b1=mk(f), w2=mk(f, d), b2=mk(d))


def _port_grads(p, x, w, t_pad, dtype=torch.float32):
    """Port grads of sum(layer(x) * w) w.r.t. x and every parameter."""
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    tp = tfe.EncoderLayerParams(**{
        k: torch.from_numpy(v).to(dtype if v.ndim == 2 else torch.float32)
        .requires_grad_() for k, v in p.items()})
    y = tfe.fused_encoder_layer(tx, tp, H, t_pad, T)
    (y.float() * torch.from_numpy(w)).sum().backward()
    return {"x": tx.grad, **{k: getattr(tp, k).grad for k in p}}


def _jax_grads(p, x, w, t_pad, stash, dtype=jnp.float32):
    jp = jfe.EncoderLayerParams(**{
        k: jnp.asarray(v, dtype if v.ndim == 2 else jnp.float32)
        for k, v in p.items()})

    def jloss(x, params):
        y = jfe.fused_encoder_layer(x, params, H, t_pad, T, 4, None, None, stash)
        return (y.astype(jnp.float32) * jnp.asarray(w)).sum()

    jdx, jdp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x, dtype), jp)
    out = {"x": jdx, **{k: getattr(jdp, k) for k in p}}
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()}


def _inputs(seed, t_pad):
    rng = np.random.RandomState(seed)
    return (_enc_params(rng), rng.randn(P * t_pad, D).astype(np.float32),
            rng.randn(P * t_pad, D).astype(np.float32))


def _count_plain_calls():
    """Wrap the plain backward passes to count their calls."""
    calls = {"mono": 0, "split": 0}
    saved = tfe.reference_mono_bwd, tfe.reference_ffn_bwd

    def mono(*a):
        calls["mono"] += 1
        return saved[0](*a)

    def split(*a):
        calls["split"] += 1
        return saved[1](*a)

    tfe.reference_mono_bwd, tfe.reference_ffn_bwd = mono, split
    return calls, saved


@pytest.mark.parametrize("t_pad", [19, 24])
@pytest.mark.parametrize("stash", [True, False])
def test_mono_backward_matches_jax_f32(mono, stash, t_pad):
    p, x, w = _inputs(30, t_pad)
    ref = _jax_grads(p, x, w, t_pad, stash)
    tfe.FUSED_STASH = stash
    calls, saved = _count_plain_calls()
    try:
        got = _port_grads(p, x, w, t_pad)
    finally:
        tfe.reference_mono_bwd, tfe.reference_ffn_bwd = saved
    assert calls == {"mono": 1, "split": 0}
    # the JAX kernel test's own tolerances (tests/test_fused_encoder.py):
    # f32 sums in another order
    np.testing.assert_allclose(got["x"].numpy(), ref["x"], atol=2e-5, rtol=0)
    for k in p:
        assert got[k].dtype == torch.float32
        scale = max(1.0, float(np.abs(ref[k]).max()))
        np.testing.assert_allclose(got[k].numpy() / scale, ref[k] / scale,
                                   atol=3e-6, rtol=0, err_msg=k)


def test_mono_backward_matches_jax_bf16(mono):
    """bf16 activations and matrices through B5: the same rounding points,
    so the grads differ by rounding flips and sum order (the split
    backward's bf16 test argues the same tolerance)."""
    t_pad = 24
    p, x, w = _inputs(31, t_pad)
    ref = _jax_grads(p, x, w, t_pad, True, jnp.bfloat16)
    got = _port_grads(p, x, w, t_pad, torch.bfloat16)
    assert got["x"].dtype == torch.bfloat16
    for k in p:
        assert got[k].dtype == (torch.bfloat16 if p[k].ndim == 2 else torch.float32)
    for k in got:
        a, b = got[k].float().numpy(), ref[k]
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, atol=1e-2 * scale, rtol=0, err_msg=k)
        assert np.abs(a - b).mean() < 2e-4 * scale, k


@pytest.mark.parametrize("t_pad", [19, 24])
def test_mono_backward_stash_bit_identical(mono, t_pad):
    """B5 recomputes qkv and x1 bit for bit as the forward wrote them, so
    its gradients are the same with and without the stash (as the JAX
    package's ``test_stash_backward_bit_identical`` holds for its kernel)."""
    p, x, w = _inputs(32, t_pad)
    tfe.FUSED_STASH = True
    with_stash = _port_grads(p, x, w, t_pad)
    tfe.FUSED_STASH = False
    without = _port_grads(p, x, w, t_pad)
    for k in with_stash:
        assert torch.equal(with_stash[k], without[k]), k


def test_mono_backward_matches_split_backward(mono):
    """B5 and the split backward (B2a + B2b) compute the same gradients;
    only the order of the weight gradients' sums may differ."""
    t_pad = 24
    p, x, w = _inputs(33, t_pad)
    got = _port_grads(p, x, w, t_pad)
    tfe.FUSED_SPLIT = True
    split = _port_grads(p, x, w, t_pad)
    np.testing.assert_allclose(got["x"].numpy(), split["x"].numpy(), atol=2e-5,
                               rtol=0)
    for k in p:
        scale = max(1.0, float(split[k].abs().max()))
        np.testing.assert_allclose(got[k].numpy() / scale,
                                   split[k].numpy() / scale, atol=3e-6, rtol=0,
                                   err_msg=k)


def test_no_stash_takes_the_monolithic_backward(mono):
    """As in JAX's ``_bwd``: a forward that kept no stash gets B5 even with
    ``FUSED_SPLIT`` on; with the stash and the split on, B2a/B2b run."""
    p, x, w = _inputs(34, T)
    tfe.FUSED_SPLIT = True
    for stash, want in ((False, {"mono": 1, "split": 0}),
                        (True, {"mono": 0, "split": 1})):
        tfe.FUSED_STASH = stash
        calls, saved = _count_plain_calls()
        try:
            _port_grads(p, x, w, T)
        finally:
            tfe.reference_mono_bwd, tfe.reference_ffn_bwd = saved
        assert calls == want, stash


def test_mono_plain_outputs_are_the_kernels_outputs():
    """``reference_mono_bwd`` returns what B5's C entry point writes: dx,
    the dW1/dW2 factors h2, df1, g in x's dtype, the six vector grads in the
    JAX kernel's order, d b1, dWqkv and dWout; and h2ᵀ·df1, gᵀ·dy are the
    split backward's dW1, dW2."""
    rng = np.random.RandomState(35)
    p = tfe.EncoderLayerParams(**{k: torch.from_numpy(v)
                                  for k, v in _enc_params(rng).items()})
    x = torch.from_numpy(rng.randn(P * T, D).astype(np.float32))
    dy = torch.from_numpy(rng.randn(P * T, D).astype(np.float32))
    dx, h2, df1, g, vec, db1, dwqkv, dwout = tfe.reference_mono_bwd(
        x, None, None, dy, p, H, T, T)
    assert [tuple(t.shape) for t in (dx, h2, df1, g, vec, db1, dwqkv, dwout)] == [
        (P * T, D), (P * T, D), (P * T, F), (P * T, F), (6, D), (F,),
        (D, 3 * D), (D, D)]
    _, qkv, x1 = tfe._reference_forward(x, p, H, T, T)
    dx1, dw1, dw2, vec4, db1_a = tfe.reference_ffn_bwd(x1, dy, p)
    dx_b, dwqkv_b, dwout_b, vec2 = tfe.reference_att_bwd(x, qkv, dx1, p, H, T, T)
    for a, b in ((dx, dx_b), (vec, torch.cat([vec2, vec4])), (db1, db1_a),
                 (dwqkv, dwqkv_b), (dwout, dwout_b), (h2.t() @ df1, dw1),
                 (g.t() @ dy, dw2)):
        assert torch.equal(a, b)
