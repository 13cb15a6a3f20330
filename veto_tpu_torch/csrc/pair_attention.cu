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
// core is a kernel.  The layout is the one the encoder has: one packed
// (pairs * T, 3D) qkv whose thirds are q, k and v, D = heads * dh; the
// forward writes att (pairs * T, D), the backward reads dO (pairs * T, D)
// and writes dq, dk, dv packed as dqkv (pairs * T, 3D), which autograd
// takes as qkv's gradient without a copy.  Keys at index >= t_valid of a
// pair are masked; the TPU kernels padded 19 tokens to 20 and packed
// 4-pair blocks under a block-diagonal mask only for Mosaic's sake, so
// here a block never mixes pairs.
//
// Rounding points are the TPU kernels': scores and softmax in f32, the
// probabilities rounded to bf16 before P.V, o rounded to bf16; in the
// backward p recomputed in f32, bf16(p) for dv = bf16(p)^T do, f32 p for
// ds = p (dp - rowsum(dp p)), bf16(ds * scale) for dq = ds k and
// dk = ds^T q; every gradient rounded to bf16 once; a masked key has p = 0
// exactly, so its dk and dv are 0.  Every sum stays inside one (pair,
// head): no atomics, two runs give the same bits.
//
// Bound: bytes.  At the PredCls eval shape (16,384 pairs x 19 tokens,
// D = 576) B4a reads qkv (1.08 GB) and writes att (0.36 GB), 1.43 GB, 0.428
// ms at 3.35 TB/s, for 0.02 TFLOP; at the train shape (12,288 pairs) 1.08
// GB, 0.321 ms.  B4b at the train shape reads qkv (0.81 GB) and dO (0.27
// GB) and writes dqkv (0.81 GB), 1.88 GB, 0.562 ms, for 0.05 TFLOP.
//
// Two routes, chosen by the shape alone (pair_attention_route below; the
// wrappers' Python mirror, ops/pair_attention.py kernel_route, chooses
// before any launch, and no route is taken because another failed):
//
//   the tensor cores, for T <= ATT_TMAX (32), head dims in whole 8-column
//     slices and a pair's rows within ATT_SMEM_MAX: attention_bwd_mma_kernel
//     of pair_attention_sm90.cuh, the kernel that B2b and B5 run, a block
//     per pair with its rows staged by bulk copies and every product on
//     mma.sync.  B4a is its forward mode (datt null); B4b its backward mode
//     with att null, which skips the P V product and the att write;
//   the CUDA cores, for every other shape (veto.patch_size 1 gives 67
//     tokens): pair_attn_fwd_kernel and pair_attn_bwd_kernel below, one
//     128-thread block per (pair, head) with q, k, v (and dO) of the head
//     in shared memory as f32 and the scores next to them; the operands are
//     read once from device memory, the products run serially in f32.

#include "pair_attention_sm90.cuh"

// ----------------------------------------------------------------------------
// The CUDA-core route: B4a's and B4b's first kernels, kept for the shapes
// the tensor-core kernel does not take.
// ----------------------------------------------------------------------------
constexpr int PA_THREADS = 128;

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

// 1 if the tensor-core kernel takes pairs of t tokens of width d in `heads`
// heads, else 0 (the CUDA-core route): ops/pair_attention.py kernel_route
// mirrors it.
extern "C" int pair_attention_route(int t, int d, int heads) {
  return attention_takes(t, d, heads) ? 1 : 0;
}

// Shared memory of one block of the tensor-core kernel (att_smem_bytes).
extern "C" int pair_attention_smem_bytes(int t, int d) {
  return att_smem_bytes(t, d);
}

// Shared memory of one block of the CUDA-core kernels for (t, dh), in bytes
// (ops/pair_attention.py cuda_core_smem_bytes mirrors it).
extern "C" int pair_attention_cuda_core_smem_bytes(int t, int dh, int backward) {
  const int tiles = backward ? 4 : 3, scores = backward ? 2 : 1;
  return (tiles * t * (dh + 1) + scores * t * (t + 1)) * (int)sizeof(float);
}
constexpr int CC_SMEM_MAX = 200 * 1024;

static int cuda_core_args(int t, int t_valid, int heads, int d, int backward,
                          const void* kern, int* smem) {
  if (heads < 1 || d % heads || t_valid < 1 || t_valid > t)
    return (int)cudaErrorInvalidValue;
  *smem = pair_attention_cuda_core_smem_bytes(t, d / heads, backward);
  if (*smem > CC_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (*smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kern,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     *smem);
  return 0;
}

// B4a on the tensor cores.  qkv (pairs t, 3d) bf16 in, att (pairs t, d)
// bf16 out, both 16-byte aligned; scale = dh**-0.5 rounded once to f32.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape that pair_attention_route gives to the CUDA cores.
extern "C" int pair_attention_forward(const void* qkv, void* att, int pairs,
                                      int t, int t_valid, int heads, int d,
                                      float scale, void* stream) {
  return launch_attention((const bf16*)qkv, nullptr, (bf16*)att, nullptr, pairs,
                          heads, t, t_valid, d, scale, (cudaStream_t)stream);
}

// B4b on the tensor cores.  As above, with dout (pairs t, d) in and dqkv
// (pairs t, 3d: dq, dk, dv) out; no att is written.
extern "C" int pair_attention_backward(const void* qkv, const void* dout,
                                       void* dqkv, int pairs, int t,
                                       int t_valid, int heads, int d,
                                       float scale, void* stream) {
  return launch_attention((const bf16*)qkv, (const bf16*)dout, nullptr,
                          (bf16*)dqkv, pairs, heads, t, t_valid, d, scale,
                          (cudaStream_t)stream);
}

// B4a on the CUDA cores: the arguments of pair_attention_forward, for any
// t whose block fits CC_SMEM_MAX.
extern "C" int pair_attention_forward_cuda_cores(const void* qkv, void* att,
                                                 int pairs, int t, int t_valid,
                                                 int heads, int d, float scale,
                                                 void* stream) {
  int smem, err;
  if ((err = cuda_core_args(t, t_valid, heads, d, 0,
                            (const void*)pair_attn_fwd_kernel, &smem)))
    return err;
  const bf16* q = (const bf16*)qkv;
  pair_attn_fwd_kernel<<<dim3(pairs, heads), PA_THREADS, smem,
                         (cudaStream_t)stream>>>(q, q + d, q + 2 * d, 3 * d,
                                                 (bf16*)att, d, t, t_valid,
                                                 d / heads, scale);
  return (int)cudaGetLastError();
}

// B4b on the CUDA cores: the arguments of pair_attention_backward.
extern "C" int pair_attention_backward_cuda_cores(const void* qkv,
                                                  const void* dout, void* dqkv,
                                                  int pairs, int t, int t_valid,
                                                  int heads, int d, float scale,
                                                  void* stream) {
  int smem, err;
  if ((err = cuda_core_args(t, t_valid, heads, d, 1,
                            (const void*)pair_attn_bwd_kernel, &smem)))
    return err;
  const bf16* q = (const bf16*)qkv;
  bf16* g = (bf16*)dqkv;
  pair_attn_bwd_kernel<<<dim3(pairs, heads), PA_THREADS, smem,
                         (cudaStream_t)stream>>>(
      q, q + d, q + 2 * d, 3 * d, (const bf16*)dout, d, g, g + d, g + 2 * d,
      3 * d, t, t_valid, d / heads, scale);
  return (int)cudaGetLastError();
}
