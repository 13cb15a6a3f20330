"""Host-side rules of the pair-attention kernels (B4a, B4b), on the CPU.

On the card B4a and B4b run on one of two routes, chosen from (T, D, heads)
alone before any launch: the tensor-core attention that B2b and B5 share
(``csrc/pair_attention_sm90.cuh``: T up to 32, head dims in whole 8-column
slices) or the CUDA-core kernels for every other shape.  No kernel runs
here; these tests hold what the wrappers decide on the host:

- the route of the main path's and ``veto.patch_size`` 1's shapes, and the
  Python mirrors of both routes' shared memory against the C formulas'
  values; an edit to the shared attention header rebuilds both libraries
  that include it;
- the wrappers' refusals (ValueError / TypeError before any library is
  loaded) of every layout the kernels do not read: q, k, v that are not
  the thirds of one packed bf16 (P, T, 3D) buffer, a misaligned base, f32,
  a dO that is not contiguous, dq, dk, dv that are not packed, a forced
  route the shape does not take;
- the plain backward's exact zeros for masked keys, which the tensor-core
  kernel gives too (its masked probabilities are 0 exactly);
- ``pair_attention`` and ``pair_attention_qkv`` against the JAX package's
  ``pair_attention`` (Pallas in interpret mode) in f32, at the main path's
  19 tokens and at 67 (``veto.patch_size`` 1: 64 patch tokens + 3).
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import veto_tpu.ops.pair_attention as jpa

from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.ops import cuda_lib
from veto_tpu_torch.ops import fused_encoder as tfe
from veto_tpu_torch.ops import pair_attention as tpa

D, H = 96, 6


@pytest.fixture
def no_library(monkeypatch):
    """Loading a kernel library fails the test: refusals come first."""
    def library(name):
        raise AssertionError(f"library {name} loaded before the refusal")
    monkeypatch.setattr(cuda_lib, "library", library)


@pytest.fixture
def interpret():
    jpa.INTERPRET = True
    yield
    jpa.INTERPRET = False


# ------------------------------------------------------------------ route
@pytest.mark.parametrize("t,d,heads,route", [
    (19, 576, 6, "tensor_cores"),   # the main path's pairs, dh 96
    (24, 576, 6, "tensor_cores"),   # padded tokens
    (32, 576, 6, "tensor_cores"),   # two full m16 tiles
    (33, 576, 6, "cuda_cores"),     # past ATT_TMAX
    (67, 576, 6, "cuda_cores"),     # veto.patch_size 1
    (19, 72, 6, "cuda_cores"),      # dh 12: not whole 8-column slices
    (32, 1024, 8, "cuda_cores"),    # a pair's rows past ATT_SMEM_MAX
])
def test_route_follows_the_shape(t, d, heads, route):
    assert tpa.kernel_route(t, d, heads) == route


def test_shared_memory_mirrors_match_the_c_formulas():
    """The tensor-core kernel's block at T 19, D 576 is the 112,864 B the
    card reported (two blocks an SM); the CUDA-core kernels' blocks at the
    main shape and at 67 tokens, from the C formula by hand, fit their
    200 KB."""
    assert tfe.attention_bwd_smem_bytes(19, 576) == 112864
    assert tfe.attention_bwd_smem_bytes(32, 576) == 128 + 24576 + 32 * (3472 + 1168)
    # (tiles t (dh + 1) + scores t (t + 1)) floats
    assert tpa.cuda_core_smem_bytes(19, 96, False) == (3 * 19 * 97 + 19 * 20) * 4
    assert tpa.cuda_core_smem_bytes(67, 96, True) == 140432
    assert tpa.cuda_core_smem_bytes(67, 96, True) <= tpa.CUDA_CORE_SMEM_MAX
    assert tpa.cuda_core_smem_bytes(100, 96, True) > tpa.CUDA_CORE_SMEM_MAX


def test_the_shared_attention_header_rebuilds_both_users(tmp_path, monkeypatch):
    """pair_attention.cu and encoder_layer_bwd.cu include
    pair_attention_sm90.cuh: an edit to it renames both libraries, so
    neither loads a stale build."""
    src = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC, src)
    monkeypatch.setattr(cuda_lib, "CSRC", src)
    names = ("pair_attention", "encoder_layer_bwd")
    before = {n: cuda_lib._lib_path(n) for n in names}
    header = src / "pair_attention_sm90.cuh"
    assert '#include "pair_attention_sm90.cuh"' in (src / "pair_attention.cu").read_text()
    assert '#include "pair_attention_sm90.cuh"' in (src / "encoder_layer_bwd.cu").read_text()
    header.write_text(header.read_text() + "\n// edited\n")
    assert all(cuda_lib._lib_path(n) != before[n] for n in names)


# --------------------------------------------------------------- refusals
def _packed(p=2, t=19, dtype=torch.bfloat16):
    return torch.zeros(p, t, 3 * D, dtype=dtype)


def _raises(exc, match, fn):
    with pytest.raises(exc, match=match):
        fn()


@pytest.mark.parametrize("which", ("forward", "backward"))
def test_wrappers_refuse_qkv_that_is_not_one_packed_buffer(no_library, which):
    q, k, v = _packed().chunk(3, dim=-1)
    other = _packed()
    apart = torch.zeros(2, 19, D, dtype=torch.bfloat16)
    do = torch.zeros(2, 19, D, dtype=torch.bfloat16)
    out = _packed().chunk(3, dim=-1)
    for qkv in ((apart, apart.clone(), apart.clone()),   # three tensors
                (q, other.chunk(3, dim=-1)[1], v),        # thirds of two buffers
                (q, v, k)):                               # out of order
        if which == "forward":
            _raises(ValueError, "thirds of one", lambda: tpa._launch_forward(*qkv, H, 19))
        else:
            _raises(ValueError, "thirds of one",
                    lambda: tpa._launch_backward(*qkv, do, H, 19, out))


def test_wrappers_refuse_a_misaligned_base(no_library):
    """The bulk copies need 16-byte addresses: a packed qkv two bytes into
    its storage is refused, not copied."""
    n = 2 * 19 * 3 * D
    buf = torch.zeros(n + 8, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    qkv = buf[1:1 + n].view(2, 19, 3 * D)
    _raises(ValueError, "16-byte aligned",
            lambda: tpa._launch_forward(*qkv.chunk(3, dim=-1), H, 19))
    do = torch.zeros(2, 19, D, dtype=torch.bfloat16)
    grad = buf[1:1 + n].view(2, 19, 3 * D).chunk(3, dim=-1)
    _raises(ValueError, "16-byte aligned", lambda: tpa._launch_backward(
        *_packed().chunk(3, dim=-1), do, H, 19, grad))
    dbuf = torch.zeros(2 * 19 * D + 8, dtype=torch.bfloat16)
    _raises(ValueError, "aligned", lambda: tpa._launch_backward(
        *_packed().chunk(3, dim=-1), dbuf[1:1 + 2 * 19 * D].view(2, 19, D), H, 19,
        _packed().chunk(3, dim=-1)))


def test_wrappers_refuse_f32(no_library):
    _raises(TypeError, "bf16", lambda: tpa._launch_forward(
        *_packed(dtype=torch.float32).chunk(3, dim=-1), H, 19))
    _raises(TypeError, "bf16", lambda: tpa._launch_backward(
        *_packed().chunk(3, dim=-1), torch.zeros(2, 19, D), H, 19,
        _packed().chunk(3, dim=-1)))


def test_backward_refuses_a_strided_do_and_unpacked_grads(no_library):
    qkv = _packed().chunk(3, dim=-1)
    strided = torch.zeros(19, 2, D, dtype=torch.bfloat16).transpose(0, 1)
    _raises(ValueError, "contiguous", lambda: tpa._launch_backward(
        *qkv, strided, H, 19, _packed().chunk(3, dim=-1)))
    do = torch.zeros(2, 19, D, dtype=torch.bfloat16)
    apart = [torch.zeros(2, 19, D, dtype=torch.bfloat16) for _ in range(3)]
    _raises(ValueError, "dq, dk, dv", lambda: tpa._launch_backward(
        *qkv, do, H, 19, apart))


def test_a_forced_route_the_shape_does_not_take_is_refused(no_library):
    """The tensor-core route is never forced onto 67 tokens, and no route
    takes a CUDA-core block past its shared memory; the right layout on the
    CPU then stops at the device check, still before any library load."""
    _raises(ValueError, "route", lambda: tpa._launch_forward(
        *_packed(t=67).chunk(3, dim=-1), H, 67, route="tensor_cores"))
    _raises(ValueError, "route", lambda: tpa._launch_forward(
        *_packed().chunk(3, dim=-1), H, 19, route="wgmma"))
    _raises(ValueError, "shared memory", lambda: tpa._launch_forward(
        *torch.zeros(1, 100, 3 * 576, dtype=torch.bfloat16).chunk(3, dim=-1), H, 100))
    for route in (None, "cuda_cores"):
        _raises(TypeError, "CUDA", lambda: tpa._launch_forward(
            *_packed().chunk(3, dim=-1), H, 19, route=route))


# ------------------------------------------------- masked keys, and JAX
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_plain_backward_gives_masked_keys_exact_zeros(dtype):
    """At t_valid < T the masked keys' dk and dv rows are exactly 0 (their
    probabilities are exp(-1e9 - m) = 0), as the tensor-core kernel, whose
    masked scores are -inf, gives them."""
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((3, 24, D))
                                    .astype(np.float32)).to(dtype) for _ in range(4))
    dq, dk, dv = tpa.reference_pair_attention_backward(q, k, v, do, H, 19)
    assert torch.all(dk[:, 19:] == 0) and torch.all(dv[:, 19:] == 0)
    assert float(dk[:, :19].abs().min(-1).values.max()) > 0
    assert float(dv[:, :19].abs().max()) > 0 and float(dq.abs().max()) > 0


def _jax_attention_and_grads(q, k, v, w):
    args = [jnp.asarray(a) for a in (q, k, v)]

    def loss(a, b, c):
        return (jpa.pair_attention(a, b, c, heads=H) * jnp.asarray(w)).sum()

    out = jpa.pair_attention(*args, heads=H)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return [np.asarray(a) for a in (out, *grads)]


@pytest.mark.parametrize("t", (19, 67))
@pytest.mark.parametrize("packed", (False, True))
def test_pair_attention_matches_jax_at_both_routes_shapes(interpret, t, packed):
    """``pair_attention`` (q, k, v apart) and ``pair_attention_qkv`` (one
    packed qkv) against JAX's Pallas kernel in f32, output and gradients,
    at the tolerance of tests/test_torch_port_pair_attn.py (f32 sums in
    another order)."""
    rng = np.random.RandomState(11 + t)
    q, k, v, w = [rng.randn(4, t, D).astype(np.float32) for _ in range(4)]
    ref = _jax_attention_and_grads(q, k, v, w)
    if packed:
        qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).requires_grad_()
        out = tpa.pair_attention_qkv(qkv, H)
        (out * torch.from_numpy(w)).sum().backward()
        grads = qkv.grad.chunk(3, dim=-1)
    else:
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        out = tpa.pair_attention(tq, tk, tv, H)
        (out * torch.from_numpy(w)).sum().backward()
        grads = (tq.grad, tk.grad, tv.grad)
    for name, got, r in zip(("out", "dq", "dk", "dv"), (out, *grads), ref):
        np.testing.assert_allclose(got.detach().numpy(), r, atol=2e-6, rtol=0,
                                   err_msg=name)
