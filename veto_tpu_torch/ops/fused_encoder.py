"""Fused VETO encoder layer: the CUDA kernel and its plain version.

Replaces the Pallas kernel ``veto_tpu/ops/fused_encoder.py`` ``_fwd_kernel``
(``_fwd``, called by ``fused_encoder_layer``): one PreNorm transformer
layer over relation pairs of ``t_pad`` tokens,

    x1 = x + (MHA(LN1 x) Wout + b_out)
    y  = x1 + (gelu(LN2 x1 W1 + b1) W2 + b2)

with each query attending to the ``t_valid`` real keys of its own pair.
The layout is the JAX package's: x is (pairs * t_pad, D), weights are
(in, out).  The rounding points are the TPU kernel's (see
``csrc/encoder_layer.cu``); LN is f32 with eps 1e-6 and GELU uses the
rational erf ``_erf`` (``torch.erf`` differs by up to 1.5e-7).

Bound on the H100: compute.  At the PredCls eval shapes (16,384 pairs x 19
tokens, D = 576) a layer is 1.67 TFLOP of bf16 products, ~1.7 ms at
989 TFLOP/s, against ~0.2 ms for its 0.7 GB of activations.  The kernel is
a fixed sequence of hand-written launches (LN, tensor-core GEMMs with
bias/GELU/residual epilogues, per-(pair, head) attention); it needs no token
padding (19 tokens, where the TPU padded to 20) but honours
``t_pad > t_valid`` (masked keys).

This slice ports the forward only: a CUDA call that would need gradients
raises.  The backward kernels (``_ffn_bwd_kernel``/``_att_bwd_kernel``)
come with the training slice.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_lib

_NEG = -1e9
KERNEL_LAUNCHES = 0  # CUDA kernel launches since the last reset


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


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    c = xf - xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((c * c).mean(-1, keepdim=True) + eps)
    return c * inv * scale + bias


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product with f32 accumulation of (possibly bf16) operands."""
    return a.float() @ b.float()


def _attention(qkv: torch.Tensor, heads: int, t_pad: int, t_valid: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Per-pair masked attention: qkv (P*t_pad, 3D) → (P*t_pad, D)."""
    rows, d3 = qkv.shape
    d = d3 // 3
    dh = d // heads
    q, k, v = (qkv.reshape(rows // t_pad, t_pad, 3, heads, dh)
               .permute(2, 0, 3, 1, 4).float().unbind(0))    # (P, h, t, dh)
    s = (q @ k.transpose(-1, -2)) * (dh ** -0.5)
    key_ok = torch.arange(t_pad, device=qkv.device) < t_valid
    p = torch.softmax(torch.where(key_ok, s, _NEG), dim=-1).to(dtype)
    out = (p.float() @ v).to(dtype)                           # (P, h, t, dh)
    return out.permute(0, 2, 1, 3).reshape(rows, d)


def reference_encoder_layer(x: torch.Tensor, params: EncoderLayerParams,
                            heads: int, t_pad: int, t_valid: int) -> torch.Tensor:
    """Plain version with the kernel's math and rounding points."""
    dtype = x.dtype
    p = params
    h1 = _ln(x, p.ln1_scale, p.ln1_bias).to(dtype)
    qkv = _mm(h1, p.w_qkv).to(dtype)
    att = _attention(qkv, heads, t_pad, t_valid, dtype)
    x1 = x + (_mm(att, p.w_out) + p.b_out).to(dtype)
    h2 = _ln(x1, p.ln2_scale, p.ln2_bias).to(dtype)
    g = _gelu_exact(_mm(h2, p.w1) + p.b1).to(dtype)
    return x1 + (_mm(g, p.w2) + p.b2).to(dtype)


def fused_encoder_layer(x: torch.Tensor, params: EncoderLayerParams,
                        heads: int, t_pad: int, t_valid: int) -> torch.Tensor:
    """x (P*t_pad, D) → one encoder layer, same shape and dtype.

    CUDA tensors launch the kernel (bf16 activations and matrices, f32
    vectors); CPU tensors run :func:`reference_encoder_layer`.
    """
    if not 1 <= t_valid <= t_pad or x.shape[0] % t_pad:
        raise ValueError("rows must be pairs * t_pad with 1 <= t_valid <= t_pad")
    if not cuda_lib.use_kernel(x):
        return reference_encoder_layer(x, params, heads, t_pad, t_valid)
    if torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad for t in params)):
        raise NotImplementedError(
            "the CUDA encoder layer is forward-only in this slice; run it "
            "under torch.no_grad()/inference_mode (the backward kernels come "
            "with the training slice)")
    return _launch(x, params, heads, t_pad, t_valid)


def _launch(x, params, heads, t_pad, t_valid):
    global KERNEL_LAUNCHES
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
    lib = cuda_lib.library("encoder_layer")
    dh = d // heads
    if lib.encoder_attention_smem_bytes(t_pad, dh) > 48 * 1024:
        raise ValueError(f"t_pad={t_pad}, head dim {dh}: attention tile "
                         "exceeds 48 KB of shared memory")
    y = torch.empty_like(x)
    if rows == 0:
        return y
    h = torch.empty_like(x)
    qkv = torch.empty((rows, 3 * d), dtype=x.dtype, device=dev)
    x1 = torch.empty_like(x)
    fn = lib.encoder_layer_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    status = fn(x.data_ptr(), y.data_ptr(), h.data_ptr(), qkv.data_ptr(),
                x1.data_ptr(), *[t.data_ptr() for t in params],
                rows, d, f, heads, t_pad, t_valid, float(dh ** -0.5),
                cuda_lib.stream_ptr(dev))
    cuda_lib.check(lib, status, "encoder_layer_forward")
    KERNEL_LAUNCHES += 1
    return y
