// Per-pair multi-head attention for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernels of veto_tpu/ops/pair_attention.py:
//
//   B4a, _fwd -> _attn_fwd_kernel (pair_attention_forward below):
//     o = softmax(q k^T * dh**-0.5) v per pair and head;
//   B4b, _bwd -> _attn_bwd_kernel (pair_attention_backward below):
//     dq, dk, dv, with the probabilities recomputed.
//
// They serve the encoder's 'pair_attn' implementation, where the
// projections, LayerNorms and FFN are plain PyTorch and only the attention
// core is a kernel.  q, k, v are (pairs * t_pad, D) row blocks with a row
// stride of their own (3D when they are the thirds of a packed qkv, so the
// slices are read in place), D = heads * dh.  Keys at index >= t_valid of
// a pair are masked; the TPU kernels padded 19 tokens to 20 and packed
// 4-pair blocks under a block-diagonal mask only for Mosaic's sake, so
// here a block holds one (pair, head) and never mixes pairs.
//
// Rounding points are the TPU kernels': scores and softmax in f32, the
// probabilities rounded to bf16 before P.V, o rounded to bf16; in the
// backward p recomputed in f32, bf16(p) for dv = bf16(p)^T do, f32 p for
// ds = p (dp - rowsum(dp p)), bf16(ds * scale) for dq = ds k and
// dk = ds^T q; every gradient rounded to bf16 once.  Every sum stays inside
// one (pair, head): no atomics, deterministic.
//
// Bound: memory.  At the PredCls train shape (12,288 pairs x 19 tokens,
// D = 576) the forward reads q, k, v and writes o, 1.08 GB, ~0.32 ms at
// 3.35 TB/s, for ~10 GFLOP; the backward moves 7 such tensors, ~0.56 ms.
// This first version is one 128-thread block per (pair, head) with q, k, v
// (and do) of the head in shared memory as f32 and the scores next to them:
// the operands are read once from device memory, coalesced along the head
// dimension; the products run on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

constexpr int PA_THREADS = 128;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Loads rows [row0, row0 + t_pad) of columns [col0, col0 + dh) of a
// (rows, ld) bf16 matrix into a t_pad x (dh + 1) f32 tile.
__device__ __forceinline__ void load_head(float* dst, const bf16* __restrict__ src,
                                          size_t row0, int ld, int col0,
                                          int t_pad, int dh) {
  const int ldt = dh + 1;  // skew: rows of dh floats would share banks
  for (int e = threadIdx.x; e < t_pad * dh; e += PA_THREADS) {
    const int t = e / dh, c = e % dh;
    dst[t * ldt + c] = __bfloat162float(src[(row0 + t) * (size_t)ld + col0 + c]);
  }
}

// Scores times scale for the t_valid real keys, then an f32 softmax over
// them in place: p is t_pad x (t_pad + 1); masked keys are left unset and
// never read (their probability is exactly 0, as exp(-1e9 - m) is).
__device__ __forceinline__ void softmax_rows(float* p, const float* q,
                                             const float* k, int t_pad,
                                             int t_valid, int dh, float scale) {
  const int ldt = dh + 1, lds = t_pad + 1;
  for (int e = threadIdx.x; e < t_pad * t_valid; e += PA_THREADS) {
    const int i = e / t_valid, j = e % t_valid;
    float acc = 0.f;
    for (int c = 0; c < dh; ++c) acc += q[i * ldt + c] * k[j * ldt + c];
    p[i * lds + j] = acc * scale;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < t_pad; i += PA_THREADS) {
    float m = p[i * lds];  // t_valid >= 1
    for (int j = 1; j < t_valid; ++j) m = fmaxf(m, p[i * lds + j]);
    float sum = 0.f;
    for (int j = 0; j < t_valid; ++j) {
      const float e = expf(p[i * lds + j] - m);
      p[i * lds + j] = e;
      sum += e;
    }
    for (int j = 0; j < t_valid; ++j) p[i * lds + j] = p[i * lds + j] / sum;
  }
  __syncthreads();
}

// B4a.  grid (pairs, heads).
__global__ void __launch_bounds__(PA_THREADS)
    pair_attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, int ld_in,
                         bf16* __restrict__ out, int ld_out, int t_pad,
                         int t_valid, int dh, float scale) {
  extern __shared__ float sm[];
  const int pair = blockIdx.x, h = blockIdx.y;
  const int ldt = dh + 1, lds = t_pad + 1;
  float* qs = sm;
  float* ks = qs + t_pad * ldt;
  float* vs = ks + t_pad * ldt;
  float* p = vs + t_pad * ldt;  // t_pad x lds
  const size_t row0 = (size_t)pair * t_pad;
  load_head(qs, q, row0, ld_in, h * dh, t_pad, dh);
  load_head(ks, k, row0, ld_in, h * dh, t_pad, dh);
  load_head(vs, v, row0, ld_in, h * dh, t_pad, dh);
  __syncthreads();
  softmax_rows(p, qs, ks, t_pad, t_valid, dh, scale);
  for (int e = threadIdx.x; e < t_pad * dh; e += PA_THREADS) {
    const int i = e / dh, c = e % dh;
    float acc = 0.f;
    for (int j = 0; j < t_valid; ++j) acc += round_bf16(p[i * lds + j]) * vs[j * ldt + c];
    out[(row0 + i) * (size_t)ld_out + h * dh + c] = __float2bfloat16(acc);
  }
}

// B4b.  grid (pairs, heads).
__global__ void __launch_bounds__(PA_THREADS)
    pair_attn_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, int ld_in,
                         const bf16* __restrict__ dout, int ld_do,
                         bf16* __restrict__ dq, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int ld_out, int t_pad,
                         int t_valid, int dh, float scale) {
  extern __shared__ float sm[];
  const int pair = blockIdx.x, h = blockIdx.y;
  const int ldt = dh + 1, lds = t_pad + 1;
  float* qs = sm;
  float* ks = qs + t_pad * ldt;
  float* vs = ks + t_pad * ldt;
  float* go = vs + t_pad * ldt;  // d o of this head
  float* p = go + t_pad * ldt;   // t_pad x lds probabilities (f32)
  float* ds = p + t_pad * lds;   // t_pad x lds dp, then bf16(ds * scale)
  const size_t row0 = (size_t)pair * t_pad;
  load_head(qs, q, row0, ld_in, h * dh, t_pad, dh);
  load_head(ks, k, row0, ld_in, h * dh, t_pad, dh);
  load_head(vs, v, row0, ld_in, h * dh, t_pad, dh);
  load_head(go, dout, row0, ld_do, h * dh, t_pad, dh);
  __syncthreads();
  softmax_rows(p, qs, ks, t_pad, t_valid, dh, scale);
  // dp = do v^T
  for (int e = threadIdx.x; e < t_pad * t_valid; e += PA_THREADS) {
    const int i = e / t_valid, j = e % t_valid;
    float acc = 0.f;
    for (int c = 0; c < dh; ++c) acc += go[i * ldt + c] * vs[j * ldt + c];
    ds[i * lds + j] = acc;
  }
  __syncthreads();
  // ds = p (dp - sum_j dp p), rounded to bf16 after the scale
  for (int i = threadIdx.x; i < t_pad; i += PA_THREADS) {
    float rd = 0.f;
    for (int j = 0; j < t_valid; ++j) rd += ds[i * lds + j] * p[i * lds + j];
    for (int j = 0; j < t_valid; ++j)
      ds[i * lds + j] = round_bf16(p[i * lds + j] * (ds[i * lds + j] - rd) * scale);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < t_pad * dh; e += PA_THREADS) {
    const int i = e / dh, c = e % dh;
    float gq = 0.f;
    for (int j = 0; j < t_valid; ++j) gq += ds[i * lds + j] * ks[j * ldt + c];
    float gk = 0.f, gv = 0.f;
    if (i < t_valid) {  // masked keys get no gradient
      for (int r = 0; r < t_pad; ++r) {
        gk += ds[r * lds + i] * qs[r * ldt + c];
        gv += round_bf16(p[r * lds + i]) * go[r * ldt + c];
      }
    }
    const size_t o = (row0 + i) * (size_t)ld_out + h * dh + c;
    dq[o] = __float2bfloat16(gq);
    dk[o] = __float2bfloat16(gk);
    dv[o] = __float2bfloat16(gv);
  }
}

// ----------------------------------------------------------------------------
// C interface
// ----------------------------------------------------------------------------
extern "C" const char* veto_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Shared memory of one block for (t_pad, dh), in bytes.
extern "C" int pair_attention_smem_bytes(int t_pad, int dh, int backward) {
  const int tiles = backward ? 4 : 3, scores = backward ? 2 : 1;
  return (tiles * t_pad * (dh + 1) + scores * t_pad * (t_pad + 1)) *
         (int)sizeof(float);
}

static int launch_smem(const void* kern, int smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kern,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     smem);
  return 0;
}

// B4a.  q, k, v: (pairs * t_pad) rows of ld_in bf16 each, the head block at
// columns [h dh, (h + 1) dh); out: rows of ld_out.  scale = dh**-0.5 rounded
// once to f32.  Returns cudaGetLastError() after the launch.
extern "C" int pair_attention_forward(const void* q, const void* k,
                                      const void* v, int ld_in, void* out,
                                      int ld_out, int pairs, int t_pad,
                                      int t_valid, int heads, int dh,
                                      float scale, void* stream) {
  const int smem = pair_attention_smem_bytes(t_pad, dh, 0);
  int err = launch_smem((const void*)pair_attn_fwd_kernel, smem);
  if (err) return err;
  pair_attn_fwd_kernel<<<dim3(pairs, heads), PA_THREADS, smem,
                         (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, ld_in, (bf16*)out,
      ld_out, t_pad, t_valid, dh, scale);
  return (int)cudaGetLastError();
}

// B4b.  As above, with dout (rows of ld_do) in and dq, dk, dv (rows of
// ld_out each; the thirds of one packed buffer when ld_out = 3 D) out.
extern "C" int pair_attention_backward(const void* q, const void* k,
                                       const void* v, int ld_in,
                                       const void* dout, int ld_do, void* dq,
                                       void* dk, void* dv, int ld_out,
                                       int pairs, int t_pad, int t_valid,
                                       int heads, int dh, float scale,
                                       void* stream) {
  const int smem = pair_attention_smem_bytes(t_pad, dh, 1);
  int err = launch_smem((const void*)pair_attn_bwd_kernel, smem);
  if (err) return err;
  pair_attn_bwd_kernel<<<dim3(pairs, heads), PA_THREADS, smem,
                         (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, ld_in,
      (const bf16*)dout, ld_do, (bf16*)dq, (bf16*)dk, (bf16*)dv, ld_out,
      t_pad, t_valid, dh, scale);
  return (int)cudaGetLastError();
}
