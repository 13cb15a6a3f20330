// Fused VETO encoder layer forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel veto_tpu/ops/fused_encoder.py _fwd_kernel
// (called by _fwd from fused_encoder_layer): one PreNorm transformer layer
// over pairs of t_pad tokens,
//
//   x1 = x + (MHA(LN1 x) Wout + b_out)        attention sub-block
//   y  = x1 + (gelu(LN2(x1) W1 + b1) W2 + b2)  FFN sub-block
//
// with attention confined to the t_valid real keys of each pair.  It keeps
// the TPU kernel's rounding points exactly: LN in f32 (eps 1e-6) rounded to
// bf16; qkv rounded to bf16; softmax in f32, probabilities rounded to bf16
// before P.V; each head's output rounded to bf16; a = (att Wout + b_out)
// rounded to bf16, x1 = x + a in bf16; f1 = h2 W1 + b1 stays f32 through the
// rational-erf GELU, then bf16; f2 rounded to bf16; y = x1 + f2 in bf16.
//
// Bound: compute.  At the PredCls eval shapes (16,384 pairs x 19 tokens,
// D = 576, F = 1152) a layer is 1.67 TFLOP of bf16 products and moves
// ~0.7 GB of activations in and out, so its floor is ~1.7 ms at 989 TFLOP/s.
// This first version is a fixed sequence of seven launches:
//   LN1 -> GEMM(qkv) -> per-(pair, head) attention -> GEMM(out-proj + bias +
//   residual) -> LN2 -> GEMM(FFN1 + bias + GELU) -> GEMM(FFN2 + bias +
//   residual)
// The GEMMs are hand-written 128x64x32 tiles on the tensor cores (WMMA bf16,
// f32 accumulators), double-buffered with cp.async; their epilogues apply
// bias, GELU and the residual before the single bf16 rounding.  Attention
// (13.6 GFLOP per layer, 1% of the work) runs on the CUDA cores from shared
// memory.  Weights are kept (in, out) row-major, the JAX package's layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

// ----------------------------------------------------------------------------
// helpers
// ----------------------------------------------------------------------------
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Abramowitz-Stegun 7.1.26 rational erf, the TPU kernel's _erf.
__device__ __forceinline__ float erf_rational(float x) {
  const float sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = 1.f / (1.f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return sign * (1.f - poly * expf(-ax * ax));
}

__device__ __forceinline__ float gelu_exact(float z) {
  return 0.5f * z * (1.f + erf_rational(z * 0.7071067811865476f));
}

// ----------------------------------------------------------------------------
// LayerNorm: one warp per row, f32 statistics, bf16 out
// ----------------------------------------------------------------------------
__global__ void layernorm_kernel(const bf16* __restrict__ x,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ bias,
                                 bf16* __restrict__ out, int rows, int d,
                                 float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const __nv_bfloat162* xr =
      reinterpret_cast<const __nv_bfloat162*>(x + (size_t)row * d);
  const int d2 = d >> 1;
  float s = 0.f;
  for (int c = lane; c < d2; c += 32) {
    const float2 v = __bfloat1622float2(xr[c]);
    s += v.x + v.y;
  }
  const float mean = warp_sum(s) / (float)d;
  float var = 0.f;
  for (int c = lane; c < d2; c += 32) {
    const float2 v = __bfloat1622float2(xr[c]);
    const float a = v.x - mean, b = v.y - mean;
    var += a * a + b * b;
  }
  const float inv = rsqrtf(warp_sum(var) / (float)d + eps);
  __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * d);
  for (int c = lane; c < d2; c += 32) {
    const float2 v = __bfloat1622float2(xr[c]);
    const float a = (v.x - mean) * inv * scale[2 * c] + bias[2 * c];
    const float b = (v.y - mean) * inv * scale[2 * c + 1] + bias[2 * c + 1];
    orow[c] = __floats2bfloat162_rn(a, b);
  }
}

// ----------------------------------------------------------------------------
// GEMM C[M,N] = epilogue(A[M,K] B[K,N]); A, B, C bf16 row-major
// ----------------------------------------------------------------------------
enum { EPI_ROUND = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RESIDUAL = 2 };

constexpr int BM = 128, BN = 64, BK = 32, GEMM_THREADS = 256;
constexpr int A_LD = BK + 8;  // bf16 elements; +8 skews shared-memory banks
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;  // f32 elements

struct GemmPipe {
  bf16 a[2][BM][A_LD];
  bf16 b[2][BK][B_LD];
};
union GemmSmem {
  GemmPipe pipe;
  float c[BM][C_LD];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void gemm_load_tile(GemmPipe& s, int buf,
                                               const bf16* __restrict__ A,
                                               const bf16* __restrict__ B,
                                               int M, int N, int K, int m0,
                                               int n0, int k0, int tid) {
  // A tile: BM rows x BK cols = BM x 4 chunks of 8 bf16
  for (int c = tid; c < BM * (BK / 8); c += GEMM_THREADS) {
    const int r = c >> 2, kc = (c & 3) * 8;
    const int gr = m0 + r;
    const bool ok = gr < M;
    const bf16* src = A + (size_t)(ok ? gr : M - 1) * K + k0 + kc;
    cp_async16(&s.a[buf][r][kc], src, ok);
  }
  // B tile: BK rows x BN cols = BK x 8 chunks
  for (int c = tid; c < BK * (BN / 8); c += GEMM_THREADS) {
    const int r = c >> 3, nc = (c & 7) * 8;
    cp_async16(&s.b[buf][r][nc], B + (size_t)(k0 + r) * N + n0 + nc, true);
  }
}

template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                     const float* __restrict__ bias,
                     const bf16* __restrict__ resid, bf16* __restrict__ C,
                     int M, int N, int K) {
  __shared__ __align__(128) GemmSmem smem;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps, 32 x 32 each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int k_tiles = K / BK;
  gemm_load_tile(smem.pipe, 0, A, B, M, N, K, m0, n0, 0, tid);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < k_tiles)
      gemm_load_tile(smem.pipe, buf ^ 1, A, B, M, N, K, m0, n0, (kt + 1) * BK,
                     tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &smem.pipe.a[buf][wm * 32 + i * 16][kk],
                               A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &smem.pipe.b[buf][kk][wn * 32 + j * 16],
                               B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&smem.c[wm * 32 + i * 16][wn * 32 + j * 16],
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();

  // epilogue: each warp writes whole 128-byte row segments
  const int col = (tid & 31) * 2;
  const int gc = n0 + col;
  float b0 = 0.f, b1 = 0.f;
  if (EPI != EPI_ROUND) {
    b0 = bias[gc];
    b1 = bias[gc + 1];
  }
  for (int r = tid >> 5; r < BM; r += GEMM_THREADS / 32) {
    const int gr = m0 + r;
    if (gr >= M) break;
    float v0 = smem.c[r][col], v1 = smem.c[r][col + 1];
    if (EPI == EPI_BIAS_GELU) {
      v0 = gelu_exact(v0 + b0);
      v1 = gelu_exact(v1 + b1);
    } else if (EPI == EPI_BIAS_RESIDUAL) {
      const float2 res = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(resid + (size_t)gr * N + gc));
      v0 = res.x + round_bf16(v0 + b0);
      v1 = res.y + round_bf16(v1 + b1);
    }
    *reinterpret_cast<__nv_bfloat162*>(C + (size_t)gr * N + gc) =
        __floats2bfloat162_rn(v0, v1);
  }
}

// ----------------------------------------------------------------------------
// Attention: one block per (pair, head), q/k/v of the head in shared memory
// ----------------------------------------------------------------------------
constexpr int ATT_THREADS = 128;

__global__ void __launch_bounds__(ATT_THREADS)
    pair_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                          int t_pad, int t_valid, int d, int dh, float scale) {
  extern __shared__ float sm[];
  const int pair = blockIdx.x, h = blockIdx.y;
  const int ld = dh + 1;       // skew: rows of dh floats would share banks
  const int lds = t_pad + 1;
  float* q = sm;
  float* k = q + t_pad * ld;
  float* v = k + t_pad * ld;
  float* s = v + t_pad * ld;   // t_pad x lds scores / probabilities
  const size_t row0 = (size_t)pair * t_pad;

  for (int e = threadIdx.x; e < t_pad * dh; e += ATT_THREADS) {
    const int t = e / dh, c = e % dh;
    const bf16* r = qkv + (row0 + t) * (size_t)(3 * d) + h * dh + c;
    q[t * ld + c] = __bfloat162float(r[0]);
    k[t * ld + c] = __bfloat162float(r[d]);
    v[t * ld + c] = __bfloat162float(r[2 * d]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < t_pad * t_valid; e += ATT_THREADS) {
    const int i = e / t_valid, j = e % t_valid;
    float acc = 0.f;
    for (int c = 0; c < dh; ++c) acc += q[i * ld + c] * k[j * ld + c];
    s[i * lds + j] = acc * scale;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < t_pad; i += ATT_THREADS) {
    float m = s[i * lds];  // t_valid >= 1
    for (int j = 1; j < t_valid; ++j) m = fmaxf(m, s[i * lds + j]);
    float sum = 0.f;
    for (int j = 0; j < t_valid; ++j) {
      const float e = expf(s[i * lds + j] - m);
      s[i * lds + j] = e;
      sum += e;
    }
    for (int j = 0; j < t_valid; ++j) s[i * lds + j] = round_bf16(s[i * lds + j] / sum);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < t_pad * dh; e += ATT_THREADS) {
    const int i = e / dh, c = e % dh;
    float acc = 0.f;
    for (int j = 0; j < t_valid; ++j) acc += s[i * lds + j] * v[j * ld + c];
    out[(row0 + i) * (size_t)d + h * dh + c] = __float2bfloat16(acc);
  }
}

// ----------------------------------------------------------------------------
// C interface
// ----------------------------------------------------------------------------
extern "C" const char* veto_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

template <int EPI>
static int launch_gemm(const bf16* A, const bf16* B, const float* bias,
                       const bf16* resid, bf16* C, int M, int N, int K,
                       cudaStream_t s) {
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<EPI><<<grid, GEMM_THREADS, 0, s>>>(A, B, bias, resid, C, M,
                                                       N, K);
  return (int)cudaGetLastError();
}

static int launch_layernorm(const bf16* x, const float* scale, const float* bias,
                            bf16* out, int rows, int d, cudaStream_t s) {
  const int rows_per_block = 8;
  layernorm_kernel<<<(rows + rows_per_block - 1) / rows_per_block,
                     rows_per_block * 32, 0, s>>>(x, scale, bias, out, rows, d,
                                                  1e-6f);
  return (int)cudaGetLastError();
}

// Shared memory of the attention kernel for (t_pad, dh), in bytes.
extern "C" int encoder_attention_smem_bytes(int t_pad, int dh) {
  return (3 * t_pad * (dh + 1) + t_pad * (t_pad + 1)) * (int)sizeof(float);
}

// One encoder layer.  x, y: (rows, d) bf16 with rows = pairs * t_pad;
// scratch: h (rows, d), qkv (rows, 3d), x1 (rows, d), all bf16.  Weights
// (in, out) row-major bf16, LN scale/bias and biases f32.  Requires d, 3d
// and f multiples of 64, d and f multiples of 32 (the GEMM tiles), d a
// multiple of heads, and 16-byte aligned pointers; the caller checks.
// att_scale is dh**-0.5 rounded once to f32, as the TPU kernel has it.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int encoder_layer_forward(
    const void* x, void* y, void* h, void* qkv, void* x1, const void* ln1_s,
    const void* ln1_b, const void* w_qkv, const void* w_out, const void* b_out,
    const void* ln2_s, const void* ln2_b, const void* w1, const void* b1,
    const void* w2, const void* b2, int rows, int d, int f, int heads,
    int t_pad, int t_valid, float att_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* X = (const bf16*)x;
  bf16* H = (bf16*)h;
  bf16* QKV = (bf16*)qkv;
  bf16* X1 = (bf16*)x1;
  const int dh = d / heads;
  const int pairs = rows / t_pad;
  int err;
  if ((err = launch_layernorm(X, (const float*)ln1_s, (const float*)ln1_b, H,
                              rows, d, s)))
    return err;
  if ((err = launch_gemm<EPI_ROUND>(H, (const bf16*)w_qkv, nullptr, nullptr,
                                    QKV, rows, 3 * d, d, s)))
    return err;
  // attention output overwrites h: LN1's output is consumed by the qkv GEMM
  pair_attention_kernel<<<dim3(pairs, heads), ATT_THREADS,
                          encoder_attention_smem_bytes(t_pad, dh), s>>>(
      QKV, H, t_pad, t_valid, d, dh, att_scale);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = launch_gemm<EPI_BIAS_RESIDUAL>(H, (const bf16*)w_out,
                                            (const float*)b_out, X, X1, rows,
                                            d, d, s)))
    return err;
  if ((err = launch_layernorm(X1, (const float*)ln2_s, (const float*)ln2_b, H,
                              rows, d, s)))
    return err;
  // the GELU activations reuse the qkv buffer (f <= 3d)
  if ((err = launch_gemm<EPI_BIAS_GELU>(H, (const bf16*)w1, (const float*)b1,
                                        nullptr, QKV, rows, f, d, s)))
    return err;
  return launch_gemm<EPI_BIAS_RESIDUAL>(QKV, (const bf16*)w2, (const float*)b2,
                                        X1, (bf16*)y, rows, d, f, s);
}
