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
the kernels read in place, and whose gradient B4b writes packed, so
autograd takes it without a copy.  :func:`pair_attention` keeps the JAX
package's signature (q, k, v apart) and packs them with one copy.

On the card two routes, chosen by :func:`kernel_route` from (T, D, heads)
alone before any launch (``pair_attention_route`` of the C code holds the
same rule):

- ``"tensor_cores"`` for T <= 32 with head dims in whole 8-column slices:
  the tensor-core attention of ``csrc/pair_attention_sm90.cuh`` that B2b and
  B5 run, a block per pair whose rows are staged by bulk copies, every
  product on ``mma.sync``; B4a is its forward mode, B4b its backward mode
  without the att write.  Counted in ``KERNEL_LAUNCHES`` / ``BWD_LAUNCHES``.
- ``"cuda_cores"`` for every other shape (``veto.patch_size`` 1 gives 67
  tokens): a block per (pair, head), f32 tiles and serial products on the
  CUDA cores.  Counted in ``CUDA_CORE_LAUNCHES`` /
  ``CUDA_CORE_BWD_LAUNCHES``.

No route is taken because another failed to build or launch: a launch
error raises.  Both take the layout above only: the thirds of one
contiguous bf16 (P, T, 3D) qkv, a contiguous dO and the thirds of one
(P, T, 3D) dqkv, each 16-byte aligned (the bulk copies'); anything else is
a ``ValueError`` or ``TypeError`` before any library is loaded.

Bound on the H100: bytes.  B4a reads qkv and writes att: 1.43 GB at the
PredCls eval shape (16,384 pairs x 19 tokens x 576), 0.428 ms at 3.35
TB/s, and 1.08 GB (0.321 ms) at the train shape (12,288 pairs).  B4b reads
qkv and dO and writes dqkv: 1.88 GB, 0.562 ms at the train shape.  Their
operations (~0.02 and ~0.05 TFLOP) are far below either.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .fused_encoder import ATT_SMEM_MAX, ATT_TMAX, attention_bwd_smem_bytes

_NEG = -1e9
# CUDA kernel launches since the last reset: B4a (forward) and B4b
# (backward) on the tensor cores, and on the CUDA cores
KERNEL_LAUNCHES = 0
BWD_LAUNCHES = 0
CUDA_CORE_LAUNCHES = 0
CUDA_CORE_BWD_LAUNCHES = 0
# the most shared memory a block of the CUDA-core kernels may take
# (csrc/pair_attention.cu: CC_SMEM_MAX)
CUDA_CORE_SMEM_MAX = 200 * 1024


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
def cuda_core_smem_bytes(t: int, dh: int, backward: bool) -> int:
    """Shared memory of a block of the CUDA-core kernels: the head's q, k, v
    (and dO) as f32 tiles of t x (dh + 1) and one (two) t x (t + 1) score
    tiles (``pair_attention_cuda_core_smem_bytes`` of the C code)."""
    tiles, scores = (4, 2) if backward else (3, 1)
    return (tiles * t * (dh + 1) + scores * t * (t + 1)) * 4


def kernel_route(t: int, d: int, heads: int) -> str:
    """The kernel that takes pairs of ``t`` tokens of width ``d`` in
    ``heads`` heads on the card: ``"tensor_cores"`` for t up to
    ``ATT_TMAX`` (32) with head dims in whole 8-column slices and a pair's
    rows within ``ATT_SMEM_MAX`` of shared memory, else ``"cuda_cores"``.
    A function of the shape alone, so a path takes one route on every
    call."""
    dh = d // heads
    if t <= ATT_TMAX and dh % 8 == 0 and attention_bwd_smem_bytes(t, d) <= ATT_SMEM_MAX:
        return "tensor_cores"
    return "cuda_cores"


def _packed(name: str, thirds, p: int, t: int, d: int) -> torch.Tensor:
    """The first third of ``thirds`` when they are the three (P, T, D)
    thirds of one contiguous bf16 (P, T, 3D) buffer, 16-byte aligned;
    raises on anything else."""
    for a in thirds:
        if a.dim() != 3 or tuple(a.shape) != (p, t, d):
            raise ValueError(f"{name}: need thirds of shape {(p, t, d)}, got "
                             f"{tuple(a.shape)}")
        if a.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernels take bf16, got {a.dtype}")
    base = thirds[0]
    want = (t * 3 * d, 3 * d, 1)
    for i, a in enumerate(thirds):
        strides_ok = all(n == 1 or s == w for n, s, w in zip(a.shape, a.stride(), want))
        if (not strides_ok or a.device != base.device
                or a.untyped_storage().data_ptr() != base.untyped_storage().data_ptr()
                or a.data_ptr() != base.data_ptr() + 2 * d * i):
            raise ValueError(
                f"{name}: need the thirds of one contiguous (P, T, 3D) buffer "
                f"(row stride 3D = {3 * d}), got strides "
                f"{[tuple(x.stride()) for x in thirds]} at offsets "
                f"{[x.data_ptr() - base.data_ptr() for x in thirds]} bytes")
    if base.data_ptr() % 16:
        raise ValueError(f"{name}: the base must be 16-byte aligned (the bulk "
                         "copies'), got an address of "
                         f"{base.data_ptr() % 16} mod 16")
    return base


def _check(q, k, v, heads, t_valid, route):
    """Refuse a layout or shape the kernels do not take, before any library
    is loaded; returns (qkv base, route).  A CUDA-core shape must fit both
    directions' blocks, so that a path that trains never meets a refusal in
    its backward only."""
    if q.dim() != 3:
        raise ValueError(f"q: need (P, T, D), got {tuple(q.shape)}")
    p, t, d = q.shape
    if d % heads:
        raise ValueError(f"D={d} does not split into {heads} heads")
    base = _packed("q, k, v", (q, k, v), p, t, d)
    if not 1 <= t_valid <= t:
        raise ValueError(f"t_valid={t_valid} outside 1..{t}")
    best = kernel_route(t, d, heads)
    route = best if route is None else route
    if route not in ("tensor_cores", "cuda_cores") or (
            route == "tensor_cores" and best != route):
        raise ValueError(f"route {route!r}: T={t}, D={d}, {heads} heads take "
                         f"{best!r}")
    if route == "cuda_cores" and cuda_core_smem_bytes(
            t, d // heads, True) > CUDA_CORE_SMEM_MAX:
        raise ValueError(f"T={t}, head dim {d // heads}: the CUDA-core kernels' "
                         f"tiles exceed {CUDA_CORE_SMEM_MAX} bytes of shared memory")
    return base, route


def _need_cuda(q):
    """Last of the checks, so that the CPU tests reach every other one."""
    if not q.is_cuda:
        raise TypeError("the pair-attention kernels take CUDA tensors")


def _entry(route: str, which: str):
    """The C entry point of ``which`` ("forward" or "backward") on
    ``route``, with its argument types."""
    lib = cuda_lib.library("pair_attention")
    fn = getattr(lib, f"pair_attention_{which}"
                 + ("_cuda_cores" if route == "cuda_cores" else ""))
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * (2 if which == "forward" else 3)
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    return lib, fn


def _launch_forward(q, k, v, heads, t_valid, route=None):
    """B4a on ``route`` (default :func:`kernel_route`'s) → (P, T, D) bf16."""
    global KERNEL_LAUNCHES, CUDA_CORE_LAUNCHES
    base, route = _check(q, k, v, heads, t_valid, route)
    _need_cuda(q)
    p, t, d = q.shape
    out = torch.empty((p, t, d), dtype=q.dtype, device=q.device)
    if p == 0:
        return out
    lib, fn = _entry(route, "forward")
    status = fn(base.data_ptr(), out.data_ptr(), p, t, t_valid, heads, d,
                float((d // heads) ** -0.5), cuda_lib.stream_ptr(q.device))
    cuda_lib.check(lib, status, f"pair_attention_forward ({route})")
    if route == "tensor_cores":
        KERNEL_LAUNCHES += 1
    else:
        CUDA_CORE_LAUNCHES += 1
    return out


def _launch_backward(q, k, v, do, heads, t_valid, out, route=None):
    """B4b on ``route`` (default :func:`kernel_route`'s): dq, dk, dv into
    ``out``, the thirds of one (P, T, 3D) bf16 buffer."""
    global BWD_LAUNCHES, CUDA_CORE_BWD_LAUNCHES
    base, route = _check(q, k, v, heads, t_valid, route)
    p, t, d = q.shape
    if do.dtype != torch.bfloat16:
        raise TypeError(f"do: the kernels take bf16, got {do.dtype}")
    if tuple(do.shape) != (p, t, d) or do.device != q.device:
        raise ValueError(f"do: need {(p, t, d)} on {q.device}, got "
                         f"{tuple(do.shape)} on {do.device}")
    if not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError("do: need a contiguous (P, T, D) tensor, 16-byte "
                         f"aligned, got strides {do.stride()}")
    grad = _packed("dq, dk, dv", out, p, t, d)
    if grad.device != q.device:
        raise ValueError(f"dq, dk, dv on {grad.device}, q on {q.device}")
    _need_cuda(q)
    if p == 0:
        return
    lib, fn = _entry(route, "backward")
    status = fn(base.data_ptr(), do.data_ptr(), grad.data_ptr(), p, t, t_valid,
                heads, d, float((d // heads) ** -0.5),
                cuda_lib.stream_ptr(q.device))
    cuda_lib.check(lib, status, f"pair_attention_backward ({route})")
    if route == "tensor_cores":
        BWD_LAUNCHES += 1
    else:
        CUDA_CORE_BWD_LAUNCHES += 1
