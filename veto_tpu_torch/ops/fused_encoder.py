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

Bound on the H100: compute.  At the PredCls eval shapes (16,384 pairs x 19
tokens, D = 576) a forward layer is 1.67 TFLOP of bf16 products, ~1.7 ms
at 989 TFLOP/s, against ~0.2 ms for its 0.7 GB of activations; at the
train shapes (12,288 pairs) the backward is 2.8 TFLOP a layer.  Each
kernel is a fixed sequence of hand-written launches (LN, tensor-core GEMMs
with fused epilogues, per-(pair, head) attention); it needs no token
padding (19 tokens, where the TPU padded to 20) but honours
``t_pad > t_valid`` (masked keys).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_lib

_NEG = -1e9
# CUDA kernel launches since the last reset: the forward (B1) and the two
# backward passes (B2a: FFN, B2b: attention)
KERNEL_LAUNCHES = 0
FFN_BWD_LAUNCHES = 0
ATT_BWD_LAUNCHES = 0


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


def _reference_forward(x, params: EncoderLayerParams, heads, t_pad, t_valid):
    """The plain layer → (y, qkv, x1): the output and the stash."""
    dtype = x.dtype
    p = params
    h1 = _ln(x, p.ln1_scale, p.ln1_bias).to(dtype)
    qkv = _mm(h1, p.w_qkv).to(dtype)
    att = _attention(qkv, heads, t_pad, t_valid, dtype)
    x1 = x + (_mm(att, p.w_out) + p.b_out).to(dtype)
    h2 = _ln(x1, p.ln2_scale, p.ln2_bias).to(dtype)
    g = _gelu_exact(_mm(h2, p.w1) + p.b1).to(dtype)
    return x1 + (_mm(g, p.w2) + p.b2).to(dtype), qkv, x1


def reference_encoder_layer(x: torch.Tensor, params: EncoderLayerParams,
                            heads: int, t_pad: int, t_valid: int) -> torch.Tensor:
    """Plain version with the kernel's math and rounding points."""
    return _reference_forward(x, params, heads, t_pad, t_valid)[0]


def reference_ffn_bwd(x1: torch.Tensor, dy: torch.Tensor,
                      params: EncoderLayerParams):
    """Plain pass A (``_ffn_bwd_kernel``) at the kernel's rounding points.

    Returns dx1 (f32), dW1, dW2 (f32 sums), the vector grads (4, D) =
    [d ln2_scale, d ln2_bias, d b_out, d b2] and d b1 (F,), all f32.
    """
    dtype = x1.dtype
    p = params
    h2, c2, inv2 = _ln_parts(x1, p.ln2_scale, p.ln2_bias)
    h2 = h2.to(dtype)
    f1 = _mm(h2, p.w1) + p.b1
    gb = _gelu_exact(f1).to(dtype)
    dyf, dyb = dy.float(), dy.to(dtype)
    df1 = _mm(dyb, p.w2.t()) * _gelu_grad(f1)
    df1b = df1.to(dtype)
    dh2 = _mm(df1b, p.w1.t())
    dx1 = dyf + _ln_bwd(dh2, c2, inv2, p.ln2_scale)
    vd = torch.stack([(dh2 * c2 * inv2).sum(0), dh2.sum(0), dx1.sum(0),
                      dyf.sum(0)])
    return dx1, _mm(h2.t(), df1b), _mm(gb.t(), dyb), vd, df1.sum(0)


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


def _param_grads(params: EncoderLayerParams, vd_a, db1, dw1, dw2, vd_b,
                 dwqkv, dwout) -> EncoderLayerParams:
    """Assemble the per-parameter grads, each in its parameter's dtype."""
    g = EncoderLayerParams(
        ln1_scale=vd_b[0], ln1_bias=vd_b[1], w_qkv=dwqkv, w_out=dwout,
        b_out=vd_a[2], ln2_scale=vd_a[0], ln2_bias=vd_a[1], w1=dw1, b1=db1,
        w2=dw2, b2=vd_a[3])
    return EncoderLayerParams(*[t.to(p.dtype) for t, p in zip(g, params)])


class _EncoderLayer(torch.autograd.Function):
    """The differentiable layer: forward with the qkv/x1 stash, backward in
    two passes (FFN, then attention)."""

    @staticmethod
    def forward(ctx, x, heads, t_pad, t_valid, *params):
        p = EncoderLayerParams(*params)
        if cuda_lib.use_kernel(x):
            y, qkv, x1 = _launch(x, p, heads, t_pad, t_valid, stash=True)
        else:
            y, qkv, x1 = _reference_forward(x, p, heads, t_pad, t_valid)
        ctx.save_for_backward(x, qkv, x1, *params)
        ctx.shape = (heads, t_pad, t_valid)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, qkv, x1, *params = ctx.saved_tensors
        p = EncoderLayerParams(*params)
        heads, t_pad, t_valid = ctx.shape
        dy = dy.contiguous()
        if cuda_lib.use_kernel(dy):
            dx1, dx1b, dw1, dw2, vd_a, db1 = _launch_ffn_bwd(x1, dy, p)
            dx, dwqkv, dwout, vd_b = _launch_att_bwd(x, qkv, dx1, dx1b, p, heads,
                                                     t_pad, t_valid)
        else:
            dx1, dw1, dw2, vd_a, db1 = reference_ffn_bwd(x1, dy, p)
            dx, dwqkv, dwout, vd_b = reference_att_bwd(x, qkv, dx1, p, heads,
                                                       t_pad, t_valid)
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


def _check(x, params, heads, t_pad):
    rows, d = x.shape
    f = params.w1.shape[1]
    dev = x.device
    shapes = dict(ln1_scale=(d,), ln1_bias=(d,), w_qkv=(d, 3 * d),
                  w_out=(d, d), b_out=(d,), ln2_scale=(d,), ln2_bias=(d,),
                  w1=(d, f), b1=(f,), w2=(f, d), b2=(d,))
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise TypeError("the CUDA encoder layer takes contiguous, 16-byte "
                        "aligned bf16 x")
    for name, t in params._asdict().items():
        want = torch.bfloat16 if t.dim() == 2 else torch.float32
        if (tuple(t.shape) != shapes[name] or t.dtype != want
                or t.device != dev or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: need aligned {want} {shapes[name]} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)}")
    if d % 64 or f % 64 or d % heads or f > 3 * d:
        raise ValueError("the kernel's GEMM tiles need D and F multiples of 64 "
                         "and F <= 3D; D must split into heads")
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
    lib.encoder_attention_bwd_smem_bytes.restype = ctypes.c_int
    lib.encoder_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 2
    return lib


def _rows_like(x, dtype, cols=None):
    return torch.empty((x.shape[0], cols or x.shape[1]), dtype=dtype,
                       device=x.device)


def _launch_ffn_bwd(x1, dy, params):
    """B2a → dx1 (f32), dx1 in bf16, dW1, dW2 (bf16), vec (4, D), d b1."""
    global FFN_BWD_LAUNCHES
    rows, d, f = _check(x1, params, 1, 1)
    if dy.shape != x1.shape or dy.dtype != torch.bfloat16 or not dy.is_contiguous():
        raise TypeError("dy must be contiguous bf16 shaped like x1")
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
    for name, t, want in (("qkv", qkv, (torch.bfloat16, 3 * d)),
                          ("dx1", dx1, (torch.float32, d)),
                          ("dx1b", dx1b, (torch.bfloat16, d))):
        if (t.dtype, t.shape[-1]) != want or t.shape[0] != rows or not t.is_contiguous():
            raise TypeError(f"{name}: need contiguous {want[0]} ({rows}, {want[1]})")
    dev = x.device
    lib = _bwd_lib()
    dh = d // heads
    if lib.encoder_attention_bwd_smem_bytes(t_pad, dh) > 200 * 1024:
        raise ValueError(f"t_pad={t_pad}, head dim {dh}: attention backward "
                         "tile exceeds 200 KB of shared memory")
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
