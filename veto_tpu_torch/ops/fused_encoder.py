"""Fused VETO encoder layer: the CUDA kernels and their plain versions.

Forward: replaces the Pallas kernel ``veto_tpu/ops/fused_encoder.py``
``_fwd_kernel`` (``_fwd``, called by ``fused_encoder_layer``): one PreNorm
transformer layer over relation pairs of ``t_pad`` tokens,

    x1 = x + (MHA(LN1 x) Wout + b_out)
    y  = x1 + (gelu(LN2 x1 W1 + b1) W2 + b2)

with each query attending to the ``t_valid`` real keys of its own pair.
The layout is the JAX package's: x is (pairs * t_pad, D), weights are
(in, out).  The rounding points are the TPU kernel's (see
``csrc/encoder_layer.cu``); LN is f32 with eps 1e-6 and GELU uses the
rational erf ``_erf`` (``torch.erf`` differs by up to 1.5e-7).

Backward: replaces the two passes of ``_bwd_split`` (the JAX package's
default backward with the qkv/x1 stash): ``_ffn_bwd_kernel`` (pass A, the
FFN sub-block, emits dx1 in f32) and ``_att_bwd_kernel`` (pass B, the
attention sub-block, emits dx).  :func:`fused_encoder_layer` is a
``torch.autograd.Function`` when a gradient is needed: its forward keeps
the layer's qkv and x1 as the stash, as ``_fwd`` does with
``FUSED_STASH``, and its backward runs pass A, then pass B
(``csrc/encoder_layer_bwd.cu`` on the card, :func:`reference_ffn_bwd` and
:func:`reference_att_bwd` on the CPU).  Matrix gradients come back in the
matrices' dtype, as ``_bwd_split`` casts them.

The monolithic backward B5 (``_bwd`` → ``_bwd_kernel``, the JAX package's
backward when ``FUSED_SPLIT`` is False or a call kept no stash) is one C
entry point that recomputes qkv and x1 when they were not stashed, then
runs both sub-blocks' backward; it returns dx, the vector grads, dWqkv and
dWout, and the factors h2, df1 and g, from which the Function takes dW1 and
dW2 with ``torch.matmul``, as ``_bwd`` leaves them to XLA.
``FUSED_STASH`` and ``FUSED_SPLIT`` are the JAX module constants, read
when the layer runs; :func:`reference_mono_bwd` is B5's plain version.

Bound on the H100: compute.  At the PredCls eval shapes (16,384 pairs x 19
tokens, D = 576) a forward layer is 1.67 TFLOP of bf16 products, ~1.7 ms
at 989 TFLOP/s, against ~0.2 ms for its 0.7 GB of activations; at the
train shapes (12,288 pairs) the backward is 2.8 TFLOP a layer.  Each
kernel is a fixed sequence of hand-written launches (LN, GEMMs with fused
epilogues, attention: per (pair, head) in the forward, per pair on the
tensor cores in the backward); it needs no token padding (19 tokens, where
the TPU padded to 20) but honours ``t_pad > t_valid`` (masked keys); the
backward takes ``t_pad`` up to ``ATT_TMAX`` and head dims that are
multiples of 8.  Every GEMM runs on one core, ``csrc/gemm_sm90.cuh``
(wgmma fed by TMA through an mbarrier ring); :func:`gemm_product` calls it
alone, and :func:`_launch_attention_bwd` the backward's attention alone,
for holding them against their plain versions on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_lib

_NEG = -1e9
# Read when the layer runs, as in the JAX package: FUSED_STASH by the
# forward (keep qkv and x1 for the backward), FUSED_SPLIT by the backward
# (two passes, B2a and B2b, when the stash is there; else B5, one pass that
# recomputes what is not stashed)
FUSED_STASH = True
FUSED_SPLIT = True
# CUDA kernel launches since the last reset: the forward (B1), the two
# passes of the split backward (B2a: FFN, B2b: attention) and the
# monolithic backward (B5)
KERNEL_LAUNCHES = 0
FFN_BWD_LAUNCHES = 0
ATT_BWD_LAUNCHES = 0
MONO_BWD_LAUNCHES = 0
# The GEMM core's tile (csrc/gemm_sm90.cuh: GEMM_BM, GEMM_BN, GEMM_BK) and
# the most rows its grid takes (65,535 row tiles)
GEMM_BM, GEMM_BN, GEMM_BK = 128, 192, 64
MAX_ROWS = 65535 * GEMM_BM
# The attention backward (csrc/pair_attention_sm90.cuh: ATT_TMAX, ATT_SMEM_MAX):
# tokens padded to two 16-row tiles, a pair's rows staged in one block's
# shared memory; and the widest row the LayerNorm backward keeps in a
# warp's registers (LNB_MAX_D)
ATT_TMAX = 32
ATT_SMEM_MAX = 232448
LN_BWD_MAX_D = 768


class EncoderLayerParams(NamedTuple):
    """One layer's parameters: LN and bias vectors f32, matrices (in, out)."""

    ln1_scale: torch.Tensor  # (D,)
    ln1_bias: torch.Tensor   # (D,)
    w_qkv: torch.Tensor      # (D, 3D)
    w_out: torch.Tensor      # (D, D)
    b_out: torch.Tensor      # (D,)
    ln2_scale: torch.Tensor  # (D,)
    ln2_bias: torch.Tensor   # (D,)
    w1: torch.Tensor         # (D, F)
    b1: torch.Tensor         # (F,)
    w2: torch.Tensor         # (F, D)
    b2: torch.Tensor         # (D,)


def _erf(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 rational erf (|err| <= 1.5e-7), the TPU
    kernel's."""
    sign = torch.sign(x)
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return sign * (1.0 - poly * torch.exp(-ax * ax))


def _gelu_exact(z: torch.Tensor) -> torch.Tensor:
    """0.5 z (1 + erf(z / sqrt(2))) with the rational erf."""
    return 0.5 * z * (1.0 + _erf(z * 0.7071067811865476))


def _gelu_grad(z: torch.Tensor) -> torch.Tensor:
    """d gelu / dz = Phi(z) + z phi(z), with the rational erf."""
    phi = torch.exp(-0.5 * z * z) * 0.3989422804014327
    cdf = 0.5 * (1.0 + _erf(z * 0.7071067811865476))
    return cdf + z * phi


def _ln_parts(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6):
    """LN in f32: (normalized, x - mean, rsqrt(var + eps))."""
    xf = x.float()
    c = xf - xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((c * c).mean(-1, keepdim=True) + eps)
    return c * inv * scale + bias, c, inv


def _ln(x, scale, bias, eps: float = 1e-6) -> torch.Tensor:
    return _ln_parts(x, scale, bias, eps)[0]


def _ln_bwd(dout, c, inv, scale) -> torch.Tensor:
    """LayerNorm backward with respect to its input (f32)."""
    xhat = c * inv
    dxhat = dout * scale
    return inv * (dxhat - dxhat.mean(-1, keepdim=True)
                  - xhat * (dxhat * xhat).mean(-1, keepdim=True))


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product with f32 accumulation of (possibly bf16) operands."""
    return a.float() @ b.float()


def _heads(qkv: torch.Tensor, heads: int, t_pad: int):
    """qkv (P*t_pad, 3D) → q, k, v as f32 (P, heads, t_pad, dh)."""
    rows, d3 = qkv.shape
    dh = d3 // 3 // heads
    return (qkv.reshape(rows // t_pad, t_pad, 3, heads, dh)
            .permute(2, 0, 3, 1, 4).float().unbind(0))


def _probs(q, k, t_pad: int, t_valid: int) -> torch.Tensor:
    s = (q @ k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    key_ok = torch.arange(t_pad, device=q.device) < t_valid
    return torch.softmax(torch.where(key_ok, s, _NEG), dim=-1)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(P, heads, t, dh) → (P*t, heads*dh)."""
    p, h, t, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(p * t, h * dh)


def _attention(qkv: torch.Tensor, heads: int, t_pad: int, t_valid: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Per-pair masked attention: qkv (P*t_pad, 3D) → (P*t_pad, D)."""
    q, k, v = _heads(qkv, heads, t_pad)
    p = _probs(q, k, t_pad, t_valid).to(dtype)
    return _merge((p.float() @ v).to(dtype))


def _reference_stash(x, params: EncoderLayerParams, heads, t_pad, t_valid):
    """The attention sub-block → (qkv, x1), the stash."""
    dtype = x.dtype
    p = params
    h1 = _ln(x, p.ln1_scale, p.ln1_bias).to(dtype)
    qkv = _mm(h1, p.w_qkv).to(dtype)
    att = _attention(qkv, heads, t_pad, t_valid, dtype)
    return qkv, x + (_mm(att, p.w_out) + p.b_out).to(dtype)


def _reference_forward(x, params: EncoderLayerParams, heads, t_pad, t_valid):
    """The plain layer → (y, qkv, x1): the output and the stash."""
    dtype = x.dtype
    p = params
    qkv, x1 = _reference_stash(x, p, heads, t_pad, t_valid)
    h2 = _ln(x1, p.ln2_scale, p.ln2_bias).to(dtype)
    g = _gelu_exact(_mm(h2, p.w1) + p.b1).to(dtype)
    return x1 + (_mm(g, p.w2) + p.b2).to(dtype), qkv, x1


def reference_encoder_layer(x: torch.Tensor, params: EncoderLayerParams,
                            heads: int, t_pad: int, t_valid: int) -> torch.Tensor:
    """Plain version with the kernel's math and rounding points."""
    return _reference_forward(x, params, heads, t_pad, t_valid)[0]


def _ffn_bwd(x1, dy, params: EncoderLayerParams):
    """The FFN sub-block's backward → dx1 (f32), the dW factors h2, df1,
    g (x1's dtype), the vector grads (4, D) = [d ln2_scale, d ln2_bias,
    d b_out, d b2] and d b1 (F,), f32."""
    dtype = x1.dtype
    p = params
    h2, c2, inv2 = _ln_parts(x1, p.ln2_scale, p.ln2_bias)
    h2 = h2.to(dtype)
    f1 = _mm(h2, p.w1) + p.b1
    gb = _gelu_exact(f1).to(dtype)
    dyf = dy.float()
    df1 = _mm(dy.to(dtype), p.w2.t()) * _gelu_grad(f1)
    df1b = df1.to(dtype)
    dh2 = _mm(df1b, p.w1.t())
    dx1 = dyf + _ln_bwd(dh2, c2, inv2, p.ln2_scale)
    vd = torch.stack([(dh2 * c2 * inv2).sum(0), dh2.sum(0), dx1.sum(0),
                      dyf.sum(0)])
    return dx1, h2, df1b, gb, vd, df1.sum(0)


def reference_ffn_bwd(x1: torch.Tensor, dy: torch.Tensor,
                      params: EncoderLayerParams):
    """Plain pass A (``_ffn_bwd_kernel``) at the kernel's rounding points.

    Returns dx1 (f32), dW1, dW2 (f32 sums), the vector grads (4, D) =
    [d ln2_scale, d ln2_bias, d b_out, d b2] and d b1 (F,), all f32.
    """
    dx1, h2, df1b, gb, vd, db1 = _ffn_bwd(x1, dy, params)
    return dx1, _mm(h2.t(), df1b), _mm(gb.t(), dy.to(x1.dtype)), vd, db1


def _attention_bwd(qkv, dattb, heads, t_pad, t_valid, dtype):
    """Recomputed head outputs and bf16-rounded dqkv from d att."""
    q, k, v = _heads(qkv, heads, t_pad)
    pairs, dh = q.shape[0], q.shape[-1]
    do = dattb.reshape(pairs, t_pad, heads, dh).permute(0, 2, 1, 3).float()
    p = _probs(q, k, t_pad, t_valid)
    pb = p.to(dtype).float()
    att = _merge((pb @ v).to(dtype))
    dv = pb.transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dsb = (ds * dh ** -0.5).to(dtype).float()
    dq, dk = dsb @ k, dsb.transpose(-1, -2) @ q
    dqkv = torch.stack([dq, dk, dv], 2)                 # (P, h, 3, t, dh)
    dqkv = dqkv.permute(0, 3, 2, 1, 4).reshape(pairs * t_pad, 3 * heads * dh)
    return att, dqkv.to(dtype)


def reference_att_bwd(x: torch.Tensor, qkv: torch.Tensor, dx1: torch.Tensor,
                      params: EncoderLayerParams, heads: int, t_pad: int,
                      t_valid: int):
    """Plain pass B (``_att_bwd_kernel``) at the kernel's rounding points.

    Returns dx (x's dtype), dWqkv, dWout (f32 sums) and the vector grads
    (2, D) = [d ln1_scale, d ln1_bias].
    """
    dtype = x.dtype
    p = params
    h1, c1, inv1 = _ln_parts(x, p.ln1_scale, p.ln1_bias)
    h1 = h1.to(dtype)
    dx1b = dx1.to(dtype)
    dattb = _mm(dx1b, p.w_out.t()).to(dtype)
    att, dqkvb = _attention_bwd(qkv, dattb, heads, t_pad, t_valid, dtype)
    dh1 = _mm(dqkvb, p.w_qkv.t())
    dx = (dx1 + _ln_bwd(dh1, c1, inv1, p.ln1_scale)).to(dtype)
    vd = torch.stack([(dh1 * c1 * inv1).sum(0), dh1.sum(0)])
    return dx, _mm(h1.t(), dqkvb), _mm(att.t(), dx1b), vd


def reference_mono_bwd(x: torch.Tensor, qkv, x1, dy: torch.Tensor,
                       params: EncoderLayerParams, heads: int, t_pad: int,
                       t_valid: int):
    """Plain B5 (``_bwd_kernel``) at the kernel's rounding points; without
    the stash (``qkv`` and ``x1`` None) it recomputes them first, as
    ``_bwd_kernel`` does when ``qkv_ref is None``.

    Returns dx (x's dtype); h2, df1 and g (x's dtype), the factors of the
    external dW1 and dW2; the vector grads (6, D) = [d ln1_scale,
    d ln1_bias, d ln2_scale, d ln2_bias, d b_out, d b2] and d b1 (F,),
    f32; dWqkv and dWout (f32 sums).
    """
    if qkv is None:
        qkv, x1 = _reference_stash(x, params, heads, t_pad, t_valid)
    dx1, h2, df1b, gb, vd_a, db1 = _ffn_bwd(x1, dy, params)
    dx, dwqkv, dwout, vd_b = reference_att_bwd(x, qkv, dx1, params, heads,
                                               t_pad, t_valid)
    return dx, h2, df1b, gb, torch.cat([vd_b, vd_a]), db1, dwqkv, dwout


def _param_grads(params: EncoderLayerParams, vd_a, db1, dw1, dw2, vd_b,
                 dwqkv, dwout) -> EncoderLayerParams:
    """Assemble the per-parameter grads, each in its parameter's dtype."""
    g = EncoderLayerParams(
        ln1_scale=vd_b[0], ln1_bias=vd_b[1], w_qkv=dwqkv, w_out=dwout,
        b_out=vd_a[2], ln2_scale=vd_a[0], ln2_bias=vd_a[1], w1=dw1, b1=db1,
        w2=dw2, b2=vd_a[3])
    return EncoderLayerParams(*[t.to(p.dtype) for t, p in zip(g, params)])


class _EncoderLayer(torch.autograd.Function):
    """The differentiable layer: forward with the qkv/x1 stash when
    ``FUSED_STASH``; backward in two passes (FFN, then attention) when
    ``FUSED_SPLIT`` and the stash is there, else in one (B5) with dW1 and
    dW2 taken outside it."""

    @staticmethod
    def forward(ctx, x, heads, t_pad, t_valid, *params):
        p = EncoderLayerParams(*params)
        stash = FUSED_STASH
        if cuda_lib.use_kernel(x):
            y, qkv, x1 = _launch(x, p, heads, t_pad, t_valid, stash=stash)
        else:
            y, qkv, x1 = _reference_forward(x, p, heads, t_pad, t_valid)
        if not stash:
            qkv = x1 = None
        ctx.save_for_backward(x, qkv, x1, *params)
        ctx.shape = (heads, t_pad, t_valid)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, qkv, x1, *params = ctx.saved_tensors
        p = EncoderLayerParams(*params)
        heads, t_pad, t_valid = ctx.shape
        dy = dy.contiguous()
        kernel = cuda_lib.use_kernel(dy)
        if FUSED_SPLIT and qkv is not None:
            if kernel:
                dx1, dx1b, dw1, dw2, vd_a, db1 = _launch_ffn_bwd(x1, dy, p)
                dx, dwqkv, dwout, vd_b = _launch_att_bwd(
                    x, qkv, dx1, dx1b, p, heads, t_pad, t_valid)
            else:
                dx1, dw1, dw2, vd_a, db1 = reference_ffn_bwd(x1, dy, p)
                dx, dwqkv, dwout, vd_b = reference_att_bwd(
                    x, qkv, dx1, p, heads, t_pad, t_valid)
        else:
            mono = _launch_mono_bwd if kernel else reference_mono_bwd
            dx, h2, df1b, gb, vd, db1, dwqkv, dwout = mono(
                x, qkv, x1, dy, p, heads, t_pad, t_valid)
            # JAX takes these two outside the kernel too (``_bwd``); a
            # bf16 product accumulates in f32 and rounds once
            dw1 = torch.matmul(h2.t(), df1b)
            dw2 = torch.matmul(gb.t(), dy.to(x.dtype))
            vd_a, vd_b = vd[2:], vd[:2]
        grads = _param_grads(p, vd_a, db1, dw1, dw2, vd_b, dwqkv, dwout)
        return (dx, None, None, None, *grads)


def fused_encoder_layer(x: torch.Tensor, params: EncoderLayerParams,
                        heads: int, t_pad: int, t_valid: int) -> torch.Tensor:
    """x (P*t_pad, D) → one encoder layer, same shape and dtype.

    CUDA tensors launch the kernels (bf16 activations and matrices, f32
    vectors); CPU tensors run the plain versions.  Differentiable: when a
    gradient is needed the call keeps the qkv/x1 stash for the backward
    kernels; otherwise it keeps nothing.
    """
    if not 1 <= t_valid <= t_pad or x.shape[0] % t_pad:
        raise ValueError("rows must be pairs * t_pad with 1 <= t_valid <= t_pad")
    if torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad for t in params)):
        return _EncoderLayer.apply(x, heads, t_pad, t_valid, *params)
    if not cuda_lib.use_kernel(x):
        return reference_encoder_layer(x, params, heads, t_pad, t_valid)
    return _launch(x, params, heads, t_pad, t_valid, stash=False)[0]


def splitk_count(m: int, n: int, k: int, sms: int) -> int:
    """Split count of a weight-gradient product (M x N, summed over K rows)
    on a card with ``sms`` SMs: ``splitk_count`` of
    ``csrc/encoder_layer_bwd.cu`` (about four waves of one block an SM,
    rounded down; at least 8 k-tiles a split)."""
    tiles = -(-n // GEMM_BN) * -(-m // GEMM_BM)
    most = -(-k // (8 * GEMM_BK))
    return max(1, min(4 * sms // tiles, most))


def attention_bwd_smem_bytes(t_pad: int, d: int) -> int:
    """Shared memory of the attention backward kernel for ``t_pad`` tokens of
    width ``d``: ``att_smem_bytes`` of ``csrc/pair_attention_sm90.cuh`` (the
    zero block and mbarrier, six pairs of 32 x 32 bf16 tiles, and the pair's
    qkv and datt rows, each padded to an odd number of 16-byte units)."""
    def row(cols):
        return ((cols * 2 // 16) | 1) * 16
    return 128 + 2 * 6 * 32 * 32 * 2 + t_pad * (row(3 * d) + row(d))


def _check_attention(d, heads, t_pad):
    """Refuse what the attention backward kernel does not take, before any
    library is loaded."""
    dh = d // heads
    if t_pad > ATT_TMAX:
        raise ValueError(f"t_pad={t_pad}: the attention backward kernel takes "
                         f"at most {ATT_TMAX} tokens a pair")
    if dh % 8:
        raise ValueError(f"head dim {dh}: the attention backward kernel takes "
                         "multiples of 8")
    if attention_bwd_smem_bytes(t_pad, d) > ATT_SMEM_MAX:
        raise ValueError(f"t_pad={t_pad}, D={d}: a pair's rows exceed "
                         f"{ATT_SMEM_MAX} bytes of shared memory")


def _check_ln_bwd(d):
    if d > LN_BWD_MAX_D:
        raise ValueError(f"D={d}: the LayerNorm backward takes D <= {LN_BWD_MAX_D}")


def _aligned(t: torch.Tensor) -> bool:
    """Contiguous with a 16-byte aligned start, as TMA reads it."""
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def _need_rows(name, t, dtype, rows, cols):
    if (t.dtype != dtype or tuple(t.shape) != (rows, cols) or not _aligned(t)):
        raise TypeError(f"{name}: need aligned contiguous {dtype} ({rows}, {cols}), "
                        f"got {t.dtype} {tuple(t.shape)}")


def _check(x, params, heads, t_pad):
    rows, d = x.shape
    f = params.w1.shape[1]
    dev = x.device
    shapes = dict(ln1_scale=(d,), ln1_bias=(d,), w_qkv=(d, 3 * d),
                  w_out=(d, d), b_out=(d,), ln2_scale=(d,), ln2_bias=(d,),
                  w1=(d, f), b1=(f,), w2=(f, d), b2=(d,))
    if x.dtype != torch.bfloat16 or not _aligned(x):
        raise TypeError("the CUDA encoder layer takes contiguous, 16-byte "
                        "aligned bf16 x")
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} rows: the GEMM grid takes at most {MAX_ROWS}")
    for name, t in params._asdict().items():
        want = torch.bfloat16 if t.dim() == 2 else torch.float32
        if (tuple(t.shape) != shapes[name] or t.dtype != want
                or t.device != dev or not _aligned(t)):
            raise ValueError(f"{name}: need aligned {want} {shapes[name]} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)}")
    if d % 64 or f % 64 or d % heads or f > 3 * d:
        raise ValueError("the GEMM core needs D and F multiples of 64 (16-byte "
                         "TMA strides, whole 64-deep k-tiles) and F <= 3D; D "
                         "must split into heads")
    return rows, d, f


def _launch(x, params, heads, t_pad, t_valid, stash: bool):
    """B1 → (y, qkv, x1); qkv and x1 are the stash only when ``stash``."""
    global KERNEL_LAUNCHES
    rows, d, f = _check(x, params, heads, t_pad)
    dev = x.device
    lib = cuda_lib.library("encoder_layer")
    dh = d // heads
    if lib.encoder_attention_smem_bytes(t_pad, dh) > 48 * 1024:
        raise ValueError(f"t_pad={t_pad}, head dim {dh}: attention tile "
                         "exceeds 48 KB of shared memory")
    y = torch.empty_like(x)
    h = torch.empty_like(x)
    qkv = torch.empty((rows, 3 * d), dtype=x.dtype, device=dev)
    x1 = torch.empty_like(x)
    if rows == 0:
        return y, qkv, x1
    # without the stash the GELU activations reuse the qkv buffer
    g = torch.empty((rows, f), dtype=x.dtype, device=dev) if stash else qkv
    fn = lib.encoder_layer_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    status = fn(x.data_ptr(), y.data_ptr(), h.data_ptr(), qkv.data_ptr(),
                x1.data_ptr(), g.data_ptr(), *[t.data_ptr() for t in params],
                rows, d, f, heads, t_pad, t_valid, float(dh ** -0.5),
                cuda_lib.stream_ptr(dev))
    cuda_lib.check(lib, status, "encoder_layer_forward")
    KERNEL_LAUNCHES += 1
    return y, qkv, x1


def _bwd_lib():
    lib = cuda_lib.library("encoder_layer_bwd")
    lib.encoder_ffn_backward_workspace.restype = ctypes.c_size_t
    lib.encoder_ffn_backward_workspace.argtypes = [ctypes.c_int] * 3
    lib.encoder_att_backward_workspace.restype = ctypes.c_size_t
    lib.encoder_att_backward_workspace.argtypes = [ctypes.c_int] * 2
    lib.encoder_mono_backward_workspace.restype = ctypes.c_size_t
    lib.encoder_mono_backward_workspace.argtypes = [ctypes.c_int] * 4
    lib.encoder_attention_bwd_smem_bytes.restype = ctypes.c_int
    lib.encoder_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.encoder_gemm_workspace.restype = ctypes.c_size_t
    lib.encoder_gemm_workspace.argtypes = [ctypes.c_int] * 3
    lib.encoder_splitk_count.restype = ctypes.c_int
    lib.encoder_splitk_count.argtypes = [ctypes.c_int] * 3
    return lib


def _rows_like(x, dtype, cols=None):
    return torch.empty((x.shape[0], cols or x.shape[1]), dtype=dtype,
                       device=x.device)


def _launch_ffn_bwd(x1, dy, params):
    """B2a → dx1 (f32), dx1 in bf16, dW1, dW2 (bf16), vec (4, D), d b1."""
    global FFN_BWD_LAUNCHES
    rows, d, f = _check(x1, params, 1, 1)
    _check_ln_bwd(d)
    _need_rows("dy", dy, torch.bfloat16, rows, d)
    dev = x1.device
    lib = _bwd_lib()
    dx1, dx1b = _rows_like(x1, torch.float32), _rows_like(x1, torch.bfloat16)
    dw1 = torch.empty((d, f), dtype=torch.bfloat16, device=dev)
    dw2 = torch.empty((f, d), dtype=torch.bfloat16, device=dev)
    vec = torch.empty((4, d), dtype=torch.float32, device=dev)
    db1 = torch.empty((f,), dtype=torch.float32, device=dev)
    if rows == 0:
        return (dx1, dx1b, dw1.zero_(), dw2.zero_(), vec.zero_(), db1.zero_())
    work = torch.empty(lib.encoder_ffn_backward_workspace(rows, d, f),
                       dtype=torch.uint8, device=dev)
    fn = lib.encoder_ffn_backward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    p = params
    status = fn(x1.data_ptr(), dy.data_ptr(), p.ln2_scale.data_ptr(),
                p.ln2_bias.data_ptr(), p.w1.data_ptr(), p.b1.data_ptr(),
                p.w2.data_ptr(), dx1.data_ptr(), dx1b.data_ptr(), dw1.data_ptr(),
                dw2.data_ptr(), vec.data_ptr(), db1.data_ptr(), work.data_ptr(),
                rows, d, f, cuda_lib.stream_ptr(dev))
    cuda_lib.check(lib, status, "encoder_ffn_backward")
    FFN_BWD_LAUNCHES += 1
    return dx1, dx1b, dw1, dw2, vec, db1


def _launch_att_bwd(x, qkv, dx1, dx1b, params, heads, t_pad, t_valid):
    """B2b → dx (bf16), dWqkv, dWout (bf16), vec (2, D)."""
    global ATT_BWD_LAUNCHES
    rows, d, _ = _check(x, params, heads, t_pad)
    _check_attention(d, heads, t_pad)
    _check_ln_bwd(d)
    _need_rows("qkv", qkv, torch.bfloat16, rows, 3 * d)
    _need_rows("dx1", dx1, torch.float32, rows, d)
    _need_rows("dx1b", dx1b, torch.bfloat16, rows, d)
    dev = x.device
    lib = _bwd_lib()
    dh = d // heads
    dx = torch.empty_like(x)
    dwqkv = torch.empty((d, 3 * d), dtype=torch.bfloat16, device=dev)
    dwout = torch.empty((d, d), dtype=torch.bfloat16, device=dev)
    vec = torch.empty((2, d), dtype=torch.float32, device=dev)
    if rows == 0:
        return dx, dwqkv.zero_(), dwout.zero_(), vec.zero_()
    work = torch.empty(lib.encoder_att_backward_workspace(rows, d),
                       dtype=torch.uint8, device=dev)
    fn = lib.encoder_att_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    p = params
    status = fn(x.data_ptr(), qkv.data_ptr(), dx1.data_ptr(), dx1b.data_ptr(),
                p.ln1_scale.data_ptr(), p.ln1_bias.data_ptr(), p.w_qkv.data_ptr(),
                p.w_out.data_ptr(), dx.data_ptr(), dwqkv.data_ptr(),
                dwout.data_ptr(), vec.data_ptr(), work.data_ptr(), rows, d, heads,
                t_pad, t_valid, float(dh ** -0.5), cuda_lib.stream_ptr(dev))
    cuda_lib.check(lib, status, "encoder_att_backward")
    ATT_BWD_LAUNCHES += 1
    return dx, dwqkv, dwout, vec


def _launch_mono_bwd(x, qkv, x1, dy, params, heads, t_pad, t_valid):
    """B5 → dx, h2, df1, g (bf16), vec (6, D), d b1 (f32), dWqkv, dWout
    (bf16); ``qkv`` and ``x1`` None: recomputed inside (no stash)."""
    global MONO_BWD_LAUNCHES
    rows, d, f = _check(x, params, heads, t_pad)
    _check_attention(d, heads, t_pad)
    _check_ln_bwd(d)
    stash = qkv is not None
    given = {"dy": (dy, d), **({"qkv": (qkv, 3 * d), "x1": (x1, d)} if stash else {})}
    for name, (t, cols) in given.items():
        _need_rows(name, t, torch.bfloat16, rows, cols)
    dev = x.device
    lib = _bwd_lib()
    dh = d // heads
    dx, h2 = torch.empty_like(x), torch.empty_like(x)
    df1, g = _rows_like(x, x.dtype, f), _rows_like(x, x.dtype, f)
    vec = torch.empty((6, d), dtype=torch.float32, device=dev)
    db1 = torch.empty((f,), dtype=torch.float32, device=dev)
    dwqkv = torch.empty((d, 3 * d), dtype=torch.bfloat16, device=dev)
    dwout = torch.empty((d, d), dtype=torch.bfloat16, device=dev)
    if rows == 0:
        return (dx, h2, df1, g, vec.zero_(), db1.zero_(), dwqkv.zero_(),
                dwout.zero_())
    work = torch.empty(lib.encoder_mono_backward_workspace(rows, d, f, int(stash)),
                       dtype=torch.uint8, device=dev)
    fn = lib.encoder_mono_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 24 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    p = params
    status = fn(x.data_ptr(), qkv.data_ptr() if stash else None,
                x1.data_ptr() if stash else None, dy.data_ptr(),
                *[t.data_ptr() for t in p], dx.data_ptr(), h2.data_ptr(),
                df1.data_ptr(), g.data_ptr(), vec.data_ptr(), db1.data_ptr(),
                dwqkv.data_ptr(), dwout.data_ptr(), work.data_ptr(), rows, d, f,
                heads, t_pad, t_valid, float(dh ** -0.5), cuda_lib.stream_ptr(dev))
    cuda_lib.check(lib, status, "encoder_mono_backward")
    MONO_BWD_LAUNCHES += 1
    return dx, h2, df1, g, vec, db1, dwqkv, dwout


def _launch_attention_bwd(qkv, datt, heads, t_pad, t_valid):
    """The attention backward kernel alone, as B2b and B5 run it inside
    their launches → (att, dqkv) bf16, the card's counterpart of
    :func:`_attention_bwd`; ``datt`` None: the forward only → (att, None),
    of :func:`_attention`.  Only for holding the kernel against those and
    timing it (``chip_smoke.py``); not counted, since the main path never
    calls it."""
    rows, d3 = qkv.shape
    d = d3 // 3
    if d3 % 3 or d % heads or rows % t_pad or not 1 <= t_valid <= t_pad:
        raise ValueError("qkv must be (pairs * t_pad, 3D) with 1 <= t_valid "
                         "<= t_pad and heads dividing D")
    _check_attention(d, heads, t_pad)
    _need_rows("qkv", qkv, torch.bfloat16, rows, 3 * d)
    if datt is not None:
        _need_rows("datt", datt, torch.bfloat16, rows, d)
    if not qkv.is_cuda or (datt is not None and datt.device != qkv.device):
        raise TypeError("the attention backward kernel takes CUDA tensors on "
                        "one device")
    lib = _bwd_lib()
    att = _rows_like(qkv, torch.bfloat16, d)
    dqkv = None if datt is None else torch.empty_like(qkv)
    if rows == 0:
        return att, dqkv
    fn = lib.encoder_attention_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    status = fn(qkv.data_ptr(), None if datt is None else datt.data_ptr(),
                att.data_ptr(), None if dqkv is None else dqkv.data_ptr(),
                rows // t_pad, heads, t_pad, t_valid, d, float((d // heads) ** -0.5),
                cuda_lib.stream_ptr(qkv.device))
    cuda_lib.check(lib, status, "encoder_attention_backward")
    return att, dqkv


def gemm_product(a: torch.Tensor, b: torch.Tensor, mode: int) -> torch.Tensor:
    """The GEMM core alone, in the operand majors the encoder uses: mode 0
    ``a @ b`` and mode 1 ``a @ b.T`` in f32 (``b`` a weight as it lies),
    mode 2 ``a.T @ b`` in bf16 (the split-K weight gradient).  bf16
    operands.  Only for holding the core against a plain product and
    timing it (``chip_smoke.py``); the encoder's launches call it inside
    their C entry points."""
    if mode not in (0, 1, 2) or a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError("mode 0, 1 or 2 with bf16 operands")
    m, k = a.shape[::-1] if mode == 2 else a.shape
    n = b.shape[0] if mode == 1 else b.shape[1]
    if (b.shape[1] if mode == 1 else b.shape[0]) != k:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} in mode {mode}")
    if not cuda_lib.use_kernel(a):
        return (_mm(a.t(), b).to(torch.bfloat16) if mode == 2
                else _mm(a, b.t() if mode == 1 else b))
    if (n % 64 or k % 8 or (mode == 2 and m % 8)
            or not (_aligned(a) and _aligned(b))):
        raise ValueError("the GEMM core needs 16-byte aligned contiguous "
                         "operands (rows of a multiple of 16 bytes) and N a "
                         "multiple of 64")
    lib = _bwd_lib()
    out = torch.empty((m, n), dtype=torch.bfloat16 if mode == 2 else torch.float32,
                      device=a.device)
    work = torch.empty(lib.encoder_gemm_workspace(m, n, k) if mode == 2 else 0,
                       dtype=torch.uint8, device=a.device)
    fn = lib.encoder_gemm_product
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    status = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), work.data_ptr(), m, n,
                k, mode, cuda_lib.stream_ptr(a.device))
    cuda_lib.check(lib, status, "encoder_gemm_product")
    return out
