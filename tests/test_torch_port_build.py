"""Host-side rules of the port's CUDA kernels, on the CPU.

No kernel is built or launched here: these tests hold the parts that run on
the host before any launch.

- ``cuda_lib._lib_path`` names each library by a hash of its source and of
  every shared header in ``csrc/``, so an edit to the GEMM core
  (``gemm_sm90.cuh``) rebuilds every library that includes it instead of
  loading a stale one from ``build/``.
- The wrappers of ``ops/fused_encoder.py`` refuse, with CPU tensors and
  before loading any library, every shape, dtype and alignment the GEMM
  core cannot take (TMA reads 16-byte aligned rows whose strides are
  multiples of 16 bytes; whole 64-deep k-tiles; at most 65,535 row tiles).
- The backward wrappers and the attention kernel alone refuse, before
  loading any library, a t_pad over ``ATT_TMAX`` and a head dim that is not
  a multiple of 8 (the tensor-core attention's tiles), and the LayerNorm
  backward a row wider than ``LN_BWD_MAX_D``; the mirror of the
  attention's shared memory lets two blocks share an SM at 19 tokens.
- ``fused_encoder.splitk_count`` mirrors the C code's split count of the
  weight-gradient products; at the main path's shapes on a 132-SM H100 it
  gives the counts the card reported.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.ops import cuda_lib
from veto_tpu_torch.ops import fused_encoder as fe


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of csrc/ that cuda_lib reads instead of the repo's."""
    src = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC, src)
    monkeypatch.setattr(cuda_lib, "CSRC", src)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    return src


def test_library_path_follows_shared_headers(csrc_copy):
    names = ("encoder_layer", "encoder_layer_bwd")
    before = {n: cuda_lib._lib_path(n) for n in names}
    assert all(p.parent == cuda_lib.BUILD_DIR for p in before.values())
    assert {n: cuda_lib._lib_path(n) for n in names} == before  # stable
    header = csrc_copy / "gemm_sm90.cuh"
    assert header.exists(), "the GEMM core is a shared header of csrc/"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: cuda_lib._lib_path(n) for n in names}
    for n in names:  # both sources include the header: both rebuild
        assert after[n] != before[n]
    # an edit to one source renames that library only
    src = csrc_copy / "encoder_layer.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert cuda_lib._lib_path("encoder_layer") != after["encoder_layer"]
    assert cuda_lib._lib_path("encoder_layer_bwd") == after["encoder_layer_bwd"]


def test_library_path_counts_a_new_header(csrc_copy):
    before = cuda_lib._lib_path("encoder_layer_bwd")
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert cuda_lib._lib_path("encoder_layer_bwd") != before


def _params(d, f, dtype=torch.bfloat16):
    rng = np.random.default_rng(0)

    def t(*shape, mat=False):
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return a.to(dtype) if mat else a

    return fe.EncoderLayerParams(
        ln1_scale=t(d), ln1_bias=t(d), w_qkv=t(d, 3 * d, mat=True),
        w_out=t(d, d, mat=True), b_out=t(d), ln2_scale=t(d), ln2_bias=t(d),
        w1=t(d, f, mat=True), b1=t(f), w2=t(f, d, mat=True), b2=t(d))


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """The same values, contiguous, starting 2 bytes past a 16-byte line."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype)
    out = flat[1:t.numel() + 1].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


def _bad_layer(case):
    """(x, params, heads) that the CUDA layer must refuse, by case."""
    d, f, heads, rows = 64, 128, 2, 6
    x = torch.zeros(rows, d, dtype=torch.bfloat16)
    p = _params(d, f)
    if case == "d_not_64":
        return torch.zeros(rows, 96, dtype=torch.bfloat16), _params(96, 192), 2
    if case == "f_not_64":
        return x, _params(d, 160), heads
    if case == "f_over_3d":
        return x, _params(d, 256), heads
    if case == "heads_not_dividing_d":
        return x, p, 3
    if case == "x_f32":
        return x.float(), p, heads
    if case == "x_misaligned":
        return _misaligned(x), p, heads
    if case == "x_strided":
        return torch.zeros(rows, 2 * d, dtype=torch.bfloat16)[:, :d], p, heads
    if case == "w1_misaligned":
        return x, p._replace(w1=_misaligned(p.w1)), heads
    if case == "w2_transposed":
        return x, p._replace(w2=p.w2.t().contiguous().t()), heads
    if case == "b1_bf16":
        return x, p._replace(b1=p.b1.bfloat16()), heads
    if case == "too_many_rows":
        # one row tile past the GEMM grid's 65,535; meta tensors hold no data
        meta = torch.empty(fe.MAX_ROWS + 1, d, dtype=torch.bfloat16, device="meta")
        return meta, fe.EncoderLayerParams(*[t.to("meta") for t in p]), heads
    raise AssertionError(case)


BAD_LAYERS = ("d_not_64", "f_not_64", "f_over_3d", "heads_not_dividing_d",
              "x_f32", "x_misaligned", "x_strided", "w1_misaligned",
              "w2_transposed", "b1_bf16", "too_many_rows")


@pytest.mark.parametrize("case", BAD_LAYERS)
def test_check_refuses_what_the_gemm_core_cannot_take(case):
    x, p, heads = _bad_layer(case)
    with pytest.raises((TypeError, ValueError)):
        fe._check(x, p, heads, 1)


def test_check_takes_the_main_path_shapes():
    # D 576, F 1152, 6 heads at 311,296 rows (16,384 pairs x 19), on meta
    p = fe.EncoderLayerParams(*[t.to("meta") for t in _params(576, 1152)])
    x = torch.empty(16384 * 19, 576, dtype=torch.bfloat16, device="meta")
    assert fe._check(x, p, 6, 19) == (16384 * 19, 576, 1152)


@pytest.mark.parametrize("which", ("ffn", "att", "mono"))
def test_backward_wrappers_refuse_a_misaligned_operand(which):
    """dy, qkv, x1 and dx1b are TMA operands of the backward's GEMMs: a
    misaligned one is refused before any library is loaded."""
    d, f, heads, t = 64, 128, 2, 3
    rows = 2 * t
    p = _params(d, f)
    x = torch.zeros(rows, d, dtype=torch.bfloat16)
    dy = torch.zeros(rows, d, dtype=torch.bfloat16)
    qkv = torch.zeros(rows, 3 * d, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        if which == "ffn":
            fe._launch_ffn_bwd(x, _misaligned(dy), p)
        elif which == "att":
            fe._launch_att_bwd(x, _misaligned(qkv), torch.zeros(rows, d),
                               _misaligned(dy), p, heads, t, t)
        else:
            fe._launch_mono_bwd(x, qkv, _misaligned(x), dy, p, heads, t, t)


def _attention_case(case):
    """(d, f, heads, t_pad) that the attention backward kernel refuses."""
    if case == "t_pad_over_limit":
        return 64, 128, 2, fe.ATT_TMAX + 1
    if case == "head_dim_not_8":
        return 192, 128, 16, 3  # head dim 12
    raise AssertionError(case)


@pytest.fixture
def no_library(monkeypatch):
    """Loading a kernel library fails the test: refusals come first."""
    def library(name):
        raise AssertionError(f"library {name} loaded before the refusal")
    monkeypatch.setattr(cuda_lib, "library", library)


@pytest.mark.parametrize("case", ("t_pad_over_limit", "head_dim_not_8"))
@pytest.mark.parametrize("which", ("att", "mono", "attention"))
def test_attention_backward_wrappers_refuse_what_the_kernel_cannot_take(
        no_library, which, case):
    """B2b, B5 and the attention kernel alone take t_pad up to ATT_TMAX (two
    16-row tiles) and head dims in whole 8-column slices: anything else is
    a ValueError before any library is loaded, with no fallback."""
    d, f, heads, t_pad = _attention_case(case)
    rows, t_valid = 2 * t_pad, min(t_pad, 3)
    p = _params(d, f)
    x = torch.zeros(rows, d, dtype=torch.bfloat16)
    qkv = torch.zeros(rows, 3 * d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="t_pad|head dim"):
        if which == "att":
            fe._launch_att_bwd(x, qkv, torch.zeros(rows, d), x, p, heads, t_pad,
                               t_valid)
        elif which == "mono":
            fe._launch_mono_bwd(x, qkv, x, x, p, heads, t_pad, t_valid)
        else:
            fe._launch_attention_bwd(qkv, x, heads, t_pad, t_valid)


def test_attention_backward_takes_the_main_path_shapes(no_library):
    """At D 576 and 6 heads every t_pad up to ATT_TMAX fits a block, and at
    the main path's 19 tokens two blocks share an SM (228 KB, 1 KB of it
    reserved per block); the mirror of the C code's shared memory gives
    the bytes the card reported."""
    assert fe.attention_bwd_smem_bytes(19, 576) == 112864
    assert 2 * (fe.attention_bwd_smem_bytes(19, 576) + 1024) <= 228 * 1024
    assert fe.attention_bwd_smem_bytes(24, 576) == 136064
    for t_pad in range(1, fe.ATT_TMAX + 1):
        fe._check_attention(576, 6, t_pad)


def test_attention_kernel_alone_refuses_cpu_tensors(no_library):
    """The raw launch has no plain fallback: a CPU tensor is a TypeError."""
    qkv = torch.zeros(2 * 19, 3 * 96, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="CUDA"):
        fe._launch_attention_bwd(qkv, None, 6, 19, 19)


def test_ln_backward_refuses_a_row_wider_than_its_registers(no_library):
    """The LayerNorm backward keeps a row's columns in a warp's registers:
    D over LN_BWD_MAX_D is refused by both passes before any launch."""
    d, f, heads, t = fe.LN_BWD_MAX_D + 64, 128, 2, 3
    p = fe.EncoderLayerParams(*[t_.to("meta") for t_ in _params(d, f)])
    x = torch.empty(2 * t, d, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="LayerNorm"):
        fe._launch_ffn_bwd(x, x, p)
    with pytest.raises(ValueError, match="LayerNorm"):
        fe._launch_att_bwd(x, torch.empty(2 * t, 3 * d, dtype=torch.bfloat16,
                                          device="meta"),
                           torch.empty(2 * t, d, device="meta"), x, p, heads, t, t)


# (M, N, K): the weight gradients of the main train step (233,472 rows) and
# dW1 at 12,216 rows, with the split counts that encoder_splitk_count gave
# on the H100's 132 SMs (chip_smoke.py's GEMM-core phase)
SPLITS_132 = (
    ((576, 1152, 233472), 17),   # dW1 = h2^T df1: 30 tiles, 4 * 132 // 30
    ((1152, 576, 233472), 19),   # dW2 = g^T dy: 27 tiles
    ((576, 1728, 233472), 11),   # dWqkv: 45 tiles
    ((576, 576, 233472), 35),    # dWout: 15 tiles
    ((576, 1152, 12216), 17),    # at most ceil(12216 / 512) = 24 splits
    ((576, 1152, 1000), 2),      # at least 8 k-tiles of 64 a split
    ((8192, 1728, 233472), 1),   # 576 tiles, more than four waves: one split
)


@pytest.mark.parametrize("shape,splits", SPLITS_132)
def test_splitk_count_mirrors_the_c_formula(shape, splits):
    assert fe.splitk_count(*shape, sms=132) == splits


def test_gemm_product_plain_version_on_the_cpu():
    """gemm_product's three forms on CPU tensors: its plain version, in the
    operand layouts the encoder hands the core (b as it lies)."""
    rng = np.random.default_rng(1)

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()

    a, w, wt, g = bf(8, 64), bf(64, 128), bf(128, 64), bf(8, 128)
    torch.testing.assert_close(fe.gemm_product(a, w, 0), a.float() @ w.float())
    torch.testing.assert_close(fe.gemm_product(a, wt, 1), a.float() @ wt.float().t())
    got = fe.gemm_product(a, g, 2)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, (a.float().t() @ g.float()).bfloat16())
    with pytest.raises(ValueError):
        fe.gemm_product(a, w, 3)
    with pytest.raises(ValueError):
        fe.gemm_product(a, wt, 0)
