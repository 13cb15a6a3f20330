"""The oracle of the encoder backward's attention kernel, against the JAX
package.

``veto_tpu_torch.ops.fused_encoder._attention_bwd`` is the plain version
that ``chip_smoke.py`` holds the tensor-core attention backward of B2b and
B5 (``csrc/encoder_layer_bwd.cu``) to on the card: recomputed att, and dq,
dk, dv from d att.  Here it is held against ``jax.vjp`` of
``veto_tpu.ops.pair_attention.pair_attention`` run in the Pallas
interpreter, whose rounding points are the same (f32 scores and softmax,
bf16 probabilities into att and dv, bf16(ds * scale) into dq and dk, each
output rounded once), on the same numpy-seeded q, k, v and d att: f32 at
atol 2e-5, bf16 to 1% of each tensor's largest |value|, and padded tokens
(t_pad 24 > t_valid 19: the real rows equal JAX's on the 19 real tokens,
the padded keys get dk = dv = 0).  ``_attention``, the plain version of
the kernel's forward-only mode, is the backward's att bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import veto_tpu.ops.pair_attention as jpa

from veto_tpu_torch.ops import fused_encoder as fe

P, T, D, H = 8, 19, 96, 6


@pytest.fixture
def interpret():
    jpa.INTERPRET = True
    yield
    jpa.INTERPRET = False


def _inputs(seed, dtype):
    """q, k, v, d att (P, T, D), as float32 numpy holding ``dtype``'s
    values, so that both packages start from the same numbers."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(P, T, D).astype(np.float32)).to(dtype)
            .float().numpy() for _ in range(4)]


def _jax(q, k, v, do, dtype):
    """JAX's att, dq, dk, dv as float32 numpy."""
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    out, vjp = jax.vjp(lambda a, b, c: jpa.pair_attention(a, b, c, heads=H), *args)
    return [np.asarray(x.astype(jnp.float32))
            for x in (out, *vjp(jnp.asarray(do, dtype)))]


def _port(q, k, v, do, dtype, t_valid=T):
    """The port's att, dq, dk, dv (P, t_pad, D) from the packed qkv rows, as
    the kernel takes them."""
    t_pad = q.shape[1]
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1).reshape(-1, 3 * D)).to(dtype)
    datt = torch.from_numpy(do.reshape(-1, D)).to(dtype)
    att, dqkv = fe._attention_bwd(qkv, datt, H, t_pad, t_valid, dtype)
    assert att.dtype == dtype and dqkv.dtype == dtype
    assert att.shape == (P * t_pad, D) and dqkv.shape == (P * t_pad, 3 * D)
    return [att.reshape(P, t_pad, D).float().numpy(),
            *(g.float().numpy() for g in dqkv.reshape(P, t_pad, 3 * D).split(D, -1))]


NAMES = ("att", "dq", "dk", "dv")


def test_attention_bwd_matches_jax_f32(interpret):
    q, k, v, do = _inputs(0, torch.float32)
    ref = _jax(q, k, v, do, jnp.float32)
    for name, got, r in zip(NAMES, _port(q, k, v, do, torch.float32), ref):
        # f32 sums of the same products in another order
        np.testing.assert_allclose(got, r, atol=2e-5, rtol=0, err_msg=name)


def test_attention_bwd_matches_jax_bf16(interpret):
    """Both round the probabilities, bf16(ds * scale) and each output at the
    same points; an f32 sum in another order can flip one rounding, one bf16
    ulp (2^-8 relative) of that value."""
    q, k, v, do = _inputs(1, torch.bfloat16)
    ref = _jax(q, k, v, do, jnp.bfloat16)
    for name, got, r in zip(NAMES, _port(q, k, v, do, torch.bfloat16), ref):
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(got, r, atol=1e-2 * scale, rtol=0, err_msg=name)
        assert np.abs(got - r).mean() < 1e-3 * scale, name


def test_attention_bwd_masks_padded_keys(interpret):
    """t_pad 24 tokens of which 19 are real: the real rows are JAX's on the
    19 real tokens, the padded keys get no gradient.  The padded queries'
    d att is zero, as in the encoder, whose padded rows are never used."""
    q, k, v, do = _inputs(2, torch.float32)
    ref = _jax(q, k, v, do, jnp.float32)
    rng = np.random.RandomState(3)
    pad = [np.concatenate([a, rng.randn(P, 5, D).astype(np.float32)], 1)
           for a in (q, k, v)]
    got = _port(*pad, np.concatenate([do, np.zeros((P, 5, D), np.float32)], 1),
                torch.float32)
    for name, g, r in zip(NAMES, got, ref):
        np.testing.assert_allclose(g[:, :T], r, atol=2e-5, rtol=0, err_msg=name)
    for name, g in zip(("dk", "dv"), got[2:]):
        assert float(np.abs(g[:, T:]).max()) == 0.0, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_forward_only_is_the_backward_att(dtype):
    """The kernel's mode without d att writes only att: its plain version
    ``_attention`` gives the backward's att bit for bit."""
    q, k, v, do = _inputs(4, dtype)
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1).reshape(-1, 3 * D)).to(dtype)
    datt = torch.from_numpy(do.reshape(-1, D)).to(dtype)
    att, _ = fe._attention_bwd(qkv, datt, H, T, T, dtype)
    assert torch.equal(fe._attention(qkv, H, T, T, dtype), att)
