"""Per-pair multi-head attention: the CUDA kernels and their plain versions.

Replaces the Pallas kernels of ``veto_tpu/ops/pair_attention.py``: B4a
(``_fwd``, ``softmax(q kᵀ / sqrt(dh)) v`` over each pair's tokens) and
B4b (``_bwd``, dq, dk and dv with the probabilities recomputed).  They are
the attention core of the encoder's ``pair_attn`` implementation
(``VetoEncoder._xla_layer`` with ``fused_attn``), where everything else of
the layer is plain PyTorch.

Shapes are the JAX package's: q, k, v (P, T, D) with D = heads * dh, the
output (P, T, D) in q's dtype.  Keys at index >= ``t_valid`` (default T) are
masked; the TPU kernels padded T to a multiple of 4 only for Mosaic's sake,
the port needs no padding.  The rounding points are the TPU kernels' (see
``csrc/pair_attention.cu``): f32 scores and softmax, the probabilities
rounded to v's dtype before P.V, bf16(ds * scale) for dq and dk.

:func:`pair_attention_qkv` is a ``torch.autograd.Function`` whose forward
is B4a and whose backward is B4b on the card (bf16), and the plain versions
:func:`reference_pair_attention_forward` /
:func:`reference_pair_attention_backward` on the CPU.  It is the form the
encoder uses: q, k, v are the thirds of one packed (P, T, 3D) qkv, which
the kernels read in place with a row stride of 3D, and whose gradient B4b
writes packed, so autograd takes it without a copy.  :func:`pair_attention`
keeps the JAX package's signature (q, k, v apart).

Bound on the H100: memory.  At the PredCls train shape (12,288 pairs x 19
tokens x 576) B4a moves 1.08 GB (~0.32 ms at 3.35 TB/s) and B4b 1.88 GB
(~0.56 ms), against ~10 and ~30 GFLOP.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib

_NEG = -1e9
# CUDA kernel launches since the last reset: B4a (forward), B4b (backward)
KERNEL_LAUNCHES = 0
BWD_LAUNCHES = 0


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(P, T, D) → f32 (P, heads, T, dh)."""
    p, t, d = x.shape
    return x.reshape(p, t, heads, d // heads).transpose(1, 2).float()


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(P, heads, T, dh) → (P, T, heads * dh)."""
    p, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(p, t, h * dh)


def _probs(qh: torch.Tensor, kh: torch.Tensor, t_valid: int) -> torch.Tensor:
    """f32 softmax of the scaled scores over the t_valid real keys."""
    s = (qh @ kh.transpose(-1, -2)) * (qh.shape[-1] ** -0.5)
    key_ok = torch.arange(s.shape[-1], device=s.device) < t_valid
    return torch.softmax(torch.where(key_ok, s, _NEG), dim=-1)


def reference_pair_attention_forward(q, k, v, heads: int, t_valid: int):
    """Plain B4a at the kernel's rounding points → (P, T, D) in q's dtype."""
    qh, kh, vh = (_split_heads(a, heads) for a in (q, k, v))
    p = _probs(qh, kh, t_valid).to(v.dtype).float()
    return _merge_heads(p @ vh).to(q.dtype)


def reference_pair_attention_backward(q, k, v, do, heads: int, t_valid: int):
    """Plain B4b at the kernel's rounding points → dq, dk, dv in q's dtype."""
    qh, kh, vh, doh = (_split_heads(a, heads) for a in (q, k, v, do))
    p = _probs(qh, kh, t_valid)
    pb = p.to(q.dtype).float()
    dv = pb.transpose(-1, -2) @ doh
    dp = doh @ vh.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dsb = (ds * qh.shape[-1] ** -0.5).to(q.dtype).float()
    dq, dk = dsb @ kh, dsb.transpose(-1, -2) @ qh
    return tuple(_merge_heads(g).to(q.dtype) for g in (dq, dk, dv))


def pair_attention_reference(q, k, v, heads: int = 6) -> torch.Tensor:
    """The f32 oracle (JAX ``pair_attention_reference``): no rounding
    inside, no mask, the result in q's dtype."""
    qh, kh, vh = (_split_heads(a, heads) for a in (q, k, v))
    pr = torch.softmax((qh @ kh.transpose(-1, -2)) * (qh.shape[-1] ** -0.5), -1)
    return _merge_heads(pr @ vh).to(q.dtype)


def _forward(q, k, v, heads, t_valid):
    if cuda_lib.use_kernel(q):
        return _launch_forward(q, k, v, heads, t_valid)
    return reference_pair_attention_forward(q, k, v, heads, t_valid)


def _backward(q, k, v, do, heads, t_valid, out):
    """dq, dk, dv into the three (P, T, D) tensors of ``out``."""
    if cuda_lib.use_kernel(do):
        _launch_backward(q, k, v, do, heads, t_valid, out)
    else:
        for o, g in zip(out, reference_pair_attention_backward(
                q, k, v, do, heads, t_valid)):
            o.copy_(g)


class _PackedPairAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, t_valid):
        ctx.save_for_backward(qkv)
        ctx.shape = (heads, t_valid)
        return _forward(*qkv.chunk(3, dim=-1), heads, t_valid)

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        dqkv = torch.empty_like(qkv)
        _backward(*qkv.chunk(3, dim=-1), do.contiguous(), *ctx.shape,
                  dqkv.chunk(3, dim=-1))
        return dqkv, None, None


def _t_valid(t: int, t_valid) -> int:
    t_valid = t if t_valid is None else t_valid
    if not 1 <= t_valid <= t:
        raise ValueError(f"t_valid={t_valid} outside 1..{t}")
    return t_valid


def pair_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   heads: int = 6, *, t_valid: int = None) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(dh)) v over (P, T, D) per-pair sequences, keys
    at index >= ``t_valid`` (default T) masked; differentiable.  The JAX
    signature: q, k and v are copied into one packed qkv for
    :func:`pair_attention_qkv`."""
    return pair_attention_qkv(torch.cat([q, k, v], dim=-1), heads,
                              t_valid=t_valid)


def pair_attention_qkv(qkv: torch.Tensor, heads: int = 6, *,
                       t_valid: int = None) -> torch.Tensor:
    """:func:`pair_attention` of the thirds of a packed (P, T, 3D) qkv,
    read in place; the gradient comes back packed, (P, T, 3D)."""
    return _PackedPairAttention.apply(qkv, heads,
                                      _t_valid(qkv.shape[1], t_valid))


# ------------------------------------------------------------------ kernels
def _row_stride(name: str, a: torch.Tensor, like: torch.Tensor) -> int:
    """The row stride of a (P, T, D) operand whose rows are pairs * T
    evenly spaced rows of contiguous D; raises on anything else."""
    p, t, d = like.shape
    if a.dim() != 3 or tuple(a.shape) != (p, t, d):
        raise ValueError(f"{name}: need shape {(p, t, d)}, got {tuple(a.shape)}")
    if a.dtype != torch.bfloat16 or a.device != like.device:
        raise TypeError(f"{name}: the kernel takes bf16 on {like.device}, "
                        f"got {a.dtype} on {a.device}")
    ld = a.stride(1)
    if a.stride(2) != 1 or a.stride(0) != t * ld or ld < d:
        raise ValueError(f"{name}: need rows of contiguous D spaced evenly over "
                         f"pairs and tokens, got strides {a.stride()}")
    return ld


def _check(q, k, v, heads):
    ld = _row_stride("q", q, q)
    if _row_stride("k", k, q) != ld or _row_stride("v", v, q) != ld:
        raise ValueError("q, k and v must share one row stride")
    d = q.shape[-1]
    if d % heads:
        raise ValueError(f"D={d} does not split into {heads} heads")
    if not q.is_cuda:
        raise TypeError("the pair-attention kernels take CUDA tensors")
    lib = cuda_lib.library("pair_attention")
    lib.pair_attention_smem_bytes.restype = ctypes.c_int
    lib.pair_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
    if lib.pair_attention_smem_bytes(q.shape[1], d // heads, 1) > 200 * 1024:
        raise ValueError(f"T={q.shape[1]}, head dim {d // heads}: the tile "
                         "exceeds 200 KB of shared memory")
    return lib, ld


def _launch_forward(q, k, v, heads, t_valid):
    """B4a → (P, T, D) bf16."""
    global KERNEL_LAUNCHES
    lib, ld = _check(q, k, v, heads)
    p, t, d = q.shape
    out = torch.empty((p, t, d), dtype=q.dtype, device=q.device)
    if p == 0:
        return out
    fn = lib.pair_attention_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, out.data_ptr(), d,
                p, t, t_valid, heads, d // heads, float((d // heads) ** -0.5),
                cuda_lib.stream_ptr(q.device))
    cuda_lib.check(lib, status, "pair_attention_forward")
    KERNEL_LAUNCHES += 1
    return out


def _launch_backward(q, k, v, do, heads, t_valid, out):
    """B4b: dq, dk, dv (bf16, one row stride) into ``out``."""
    global BWD_LAUNCHES
    lib, ld = _check(q, k, v, heads)
    ld_do = _row_stride("do", do, q)
    dq, dk, dv = out
    ld_out = _row_stride("dq", dq, q)
    if _row_stride("dk", dk, q) != ld_out or _row_stride("dv", dv, q) != ld_out:
        raise ValueError("dq, dk and dv must share one row stride")
    p, t, d = q.shape
    if p == 0:
        return
    fn = lib.pair_attention_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                            ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, do.data_ptr(),
                ld_do, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ld_out, p, t,
                t_valid, heads, d // heads, float((d // heads) ** -0.5),
                cuda_lib.stream_ptr(q.device))
    cuda_lib.check(lib, status, "pair_attention_backward")
    BWD_LAUNCHES += 1
