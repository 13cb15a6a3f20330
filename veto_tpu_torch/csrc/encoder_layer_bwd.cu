// Fused VETO encoder layer backward for Hopper (sm_90a): the two passes of
// the split backward.
//
// Replaces the Pallas TPU kernels of veto_tpu/ops/fused_encoder.py driven by
// _bwd_split (the default backward, FUSED_SPLIT with the qkv/x1 stash):
//
//   pass A, _ffn_bwd_kernel (encoder_ffn_backward below): the FFN sub-block
//     y = x1 + (gelu(LN2(x1) W1 + b1) W2 + b2).  Recomputes LN2, f1 and GELU
//     from the stashed x1; emits dx1 in f32 (and its bf16 rounding for
//     pass B); dW1, dW2, d ln2 scale/bias, d b_out, d b2, d b1.
//   pass B, _att_bwd_kernel (encoder_att_backward below): the attention
//     sub-block x1 = x + (MHA(LN1 x) Wout + b_out).  Recomputes LN1 and the
//     attention probabilities from the stashed qkv; emits dx; dWqkv, dWout,
//     d ln1 scale/bias.
//
// Rounding points are the TPU kernels': dy rounded to bf16 before dy W2^T
// and g^T dy; df1 rounded to bf16 before df1 W1^T and h2^T df1; dx1 f32;
// datt = bf16(dx1) Wout^T rounded to bf16; inside attention the bf16
// probabilities feed att and dv, the f32 ones ds, and bf16(ds * scale)
// feeds dq and dk; dqkv rounded to bf16 before dqkv Wqkv^T and h1^T dqkv;
// dx rounded to bf16.  Matrix gradients are f32 sums rounded once to bf16,
// the dtype of the matrices the layer ran with.
//
// Bound: compute.  At the PredCls train shapes (12,288 pairs x 19 tokens,
// D = 576, F = 1152) pass A is 5 GEMMs of 2 R D F (1.55 TFLOP) and pass B 4
// GEMMs (1.26 TFLOP) plus 0.03 TFLOP of attention, so ~2.8 ms per layer at
// 989 TFLOP/s against ~4.5 GB of activations read and written (~1.3 ms).
// Each pass is a fixed sequence of launches: LayerNorm recompute, the
// hand-written WMMA tensor-core GEMM of the forward (128x64x32 tiles,
// cp.async double buffering) with either operand read transposed from its
// row-major storage, the per-(pair, head) attention backward from shared
// memory, and a row-wise LayerNorm backward.
//
// Determinism: the weight gradients are contractions over all rows and the
// vector gradients column sums over all rows.  Where the TPU kernel
// accumulated across its sequential grid, here a split-K GEMM writes one
// f32 partial per row range and a second kernel sums the partials in a fixed
// order; column sums are per-block partials summed in a fixed order.  No
// atomics, so two runs give bit-equal gradients.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

// ----------------------------------------------------------------------------
// helpers (as in encoder_layer.cu)
// ----------------------------------------------------------------------------
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

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

// d gelu / dz = Phi(z) + z phi(z), with the rational erf
__device__ __forceinline__ float gelu_grad(float z) {
  const float phi = expf(-0.5f * z * z) * 0.3989422804014327f;
  const float cdf = 0.5f * (1.f + erf_rational(z * 0.7071067811865476f));
  return cdf + z * phi;
}

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

// ----------------------------------------------------------------------------
// LayerNorm forward recompute: one warp per row, f32 statistics, bf16 out
// (the forward's layernorm_kernel, so h1/h2 are bit-equal to the forward's)
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
// GEMM C[M,N] = A[M,K] B[K,N] on the tensor cores, bf16 in, f32 accumulate.
// TA: A is stored transposed, as K x M row-major (A[m][k] = S[k * lda + m]);
// TB: B is stored transposed, as N x K row-major (B[k][n] = S[n * ldb + k]).
// blockIdx.z is the split of the K range [z * k_chunk, (z + 1) * k_chunk).
// ----------------------------------------------------------------------------
enum {
  EPI_F32 = 0,             // out_f32 = acc
  EPI_BF16 = 1,            // out_bf16 = bf16(acc)
  EPI_BIAS_GELU_SAVE = 2,  // f = acc + bias: out_f32 = f, out_bf16 = bf16(gelu f)
  EPI_GELU_BWD = 3,        // df = acc * gelu'(aux): out_bf16 = bf16(df),
                           // colsum[blockIdx.y][n] = sum of the tile's df
  EPI_SPLITK = 4,          // out_f32[z] = acc (partial of split z)
};

constexpr int BM = 128, BN = 64, BK = 32, GEMM_THREADS = 256;
constexpr int LDA_N = BK + 8;  // A tile [BM][BK]; +8 skews shared-memory banks
constexpr int LDA_T = BM + 8;  // A tile [BK][BM]
constexpr int LDB_N = BN + 8;  // B tile [BK][BN]
constexpr int LDB_T = BK + 8;  // B tile [BN][BK]
constexpr int C_LD = BN + 4;   // f32 elements

template <bool TA, bool TB>
struct GemmPipe {
  bf16 a[2][TA ? BK : BM][TA ? LDA_T : LDA_N];
  bf16 b[2][TB ? BN : BK][TB ? LDB_T : LDB_N];
};
template <bool TA, bool TB>
union GemmSmem {
  GemmPipe<TA, TB> pipe;
  float c[BM][C_LD];
};

struct Epi {
  const float* bias;  // (N,)
  const float* aux;   // (M, N) f32
  float* out_f32;     // (M, N), or (splits, M, N) for EPI_SPLITK
  bf16* out_bf16;     // (M, N)
  float* colsum;      // (gridDim.y, N)
};

// Loads the k-tile at k0; rows or columns past M, N or k_end are zero-filled.
// M and N are multiples of 8 where a 16-byte chunk runs along them; K is a
// multiple of 8 where a chunk runs along it (the host checks).
template <bool TA, bool TB>
__device__ __forceinline__ void gemm_load_tile(
    GemmPipe<TA, TB>& s, int buf, const bf16* __restrict__ A,
    const bf16* __restrict__ B, int M, int N, int k_end, int lda, int ldb,
    int m0, int n0, int k0, int tid) {
  if constexpr (!TA) {
    for (int c = tid; c < BM * (BK / 8); c += GEMM_THREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + kc;
      const bool ok = gm < M && gk < k_end;
      cp_async16(&s.a[buf][r][kc], ok ? A + (size_t)gm * lda + gk : A, ok);
    }
  } else {
    for (int c = tid; c < BK * (BM / 8); c += GEMM_THREADS) {
      const int r = c / (BM / 8), mc = (c % (BM / 8)) * 8;
      const int gk = k0 + r, gm = m0 + mc;
      const bool ok = gk < k_end && gm < M;
      cp_async16(&s.a[buf][r][mc], ok ? A + (size_t)gk * lda + gm : A, ok);
    }
  }
  if constexpr (!TB) {
    for (int c = tid; c < BK * (BN / 8); c += GEMM_THREADS) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      const bool ok = gk < k_end && gn < N;
      cp_async16(&s.b[buf][r][nc], ok ? B + (size_t)gk * ldb + gn : B, ok);
    }
  } else {
    for (int c = tid; c < BN * (BK / 8); c += GEMM_THREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int gn = n0 + r, gk = k0 + kc;
      const bool ok = gn < N && gk < k_end;
      cp_async16(&s.b[buf][r][kc], ok ? B + (size_t)gn * ldb + gk : B, ok);
    }
  }
}

template <bool TA, bool TB, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                int M, int N, int K, int lda, int ldb, int k_chunk, Epi epi) {
  __shared__ __align__(128) GemmSmem<TA, TB> smem;
  using LayA = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
  using LayB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps, 32 x 32 each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int k_tiles = (k_end - k_begin + BK - 1) / BK;
  if (k_tiles > 0) {
    gemm_load_tile<TA, TB>(smem.pipe, 0, A, B, M, N, k_end, lda, ldb, m0, n0,
                           k_begin, tid);
  }
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < k_tiles)
      gemm_load_tile<TA, TB>(smem.pipe, buf ^ 1, A, B, M, N, k_end, lda, ldb,
                             m0, n0, k_begin + (kt + 1) * BK, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayA> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayB> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (TA)
          wmma::load_matrix_sync(a[i], &smem.pipe.a[buf][kk][wm * 32 + i * 16],
                                 LDA_T);
        else
          wmma::load_matrix_sync(a[i], &smem.pipe.a[buf][wm * 32 + i * 16][kk],
                                 LDA_N);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (TB)
          wmma::load_matrix_sync(b[j], &smem.pipe.b[buf][wn * 32 + j * 16][kk],
                                 LDB_T);
        else
          wmma::load_matrix_sync(b[j], &smem.pipe.b[buf][kk][wn * 32 + j * 16],
                                 LDB_N);
      }
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

  // epilogue: each warp writes whole row segments, two columns a thread
  const int col = (tid & 31) * 2;
  const int gc = n0 + col;
  float* out_f32 = epi.out_f32;
  if (EPI == EPI_SPLITK) out_f32 += (size_t)blockIdx.z * M * N;
  for (int r = tid >> 5; r < BM; r += GEMM_THREADS / 32) {
    const int gr = m0 + r;
    if (gr >= M) break;
    const size_t o = (size_t)gr * N + gc;
    float v0 = smem.c[r][col], v1 = smem.c[r][col + 1];
    if (EPI == EPI_F32 || EPI == EPI_SPLITK) {
      *reinterpret_cast<float2*>(out_f32 + o) = make_float2(v0, v1);
    } else if (EPI == EPI_BF16) {
      *reinterpret_cast<__nv_bfloat162*>(epi.out_bf16 + o) =
          __floats2bfloat162_rn(v0, v1);
    } else if (EPI == EPI_BIAS_GELU_SAVE) {
      v0 += epi.bias[gc];
      v1 += epi.bias[gc + 1];
      *reinterpret_cast<float2*>(out_f32 + o) = make_float2(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(epi.out_bf16 + o) =
          __floats2bfloat162_rn(gelu_exact(v0), gelu_exact(v1));
    } else if (EPI == EPI_GELU_BWD) {
      const float2 z = *reinterpret_cast<const float2*>(epi.aux + o);
      v0 *= gelu_grad(z.x);
      v1 *= gelu_grad(z.y);
      *reinterpret_cast<__nv_bfloat162*>(epi.out_bf16 + o) =
          __floats2bfloat162_rn(v0, v1);
      smem.c[r][col] = v0;  // kept for the column sums below
      smem.c[r][col + 1] = v1;
    }
  }
  if (EPI == EPI_GELU_BWD) {
    __syncthreads();
    if (tid < BN) {
      const int rows = min(BM, M - m0);
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += smem.c[r][tid];
      epi.colsum[(size_t)blockIdx.y * N + n0 + tid] = s;
    }
  }
}

// out[i] = sum over z of part[z][i], in order of z, rounded to bf16
__global__ void splitk_reduce_kernel(const float* __restrict__ part, int splits,
                                     size_t mn, bf16* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(size_t)z * mn + i];
  out[i] = __float2bfloat16(s);
}

// out[c] = sum over b of part[b][c]: 8 interleaved running sums per column,
// then those 8 in order (a fixed order either way)
__global__ void colsum_reduce_kernel(const float* __restrict__ part, int nblk,
                                     int ncols, float* __restrict__ out) {
  __shared__ float sm[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < ncols)
    for (int b = threadIdx.y; b < nblk; b += 8) s += part[(size_t)b * ncols + col];
  sm[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < ncols) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < 8; ++y) t += sm[y][threadIdx.x];
    out[col] = t;
  }
}

// ----------------------------------------------------------------------------
// LayerNorm backward: one warp per row, 4 warps and LNB_ROWS rows a block.
//   out = resid + inv (dxhat - mean(dxhat) - xhat mean(dxhat xhat)),
//   dxhat = dh * scale,
// with the block's column sums of dh * xhat, dh (and, NQ = 4, of out and
// resid) written to part[blockIdx.x] for colsum_reduce_kernel.
// ----------------------------------------------------------------------------
constexpr int LNB_WARPS = 4, LNB_ROWS = 256;

template <int NQ, typename RES>
__global__ void __launch_bounds__(LNB_WARPS * 32)
    ln_backward_kernel(const bf16* __restrict__ x, const float* __restrict__ dh,
                       const RES* __restrict__ resid,
                       const float* __restrict__ scale, float* __restrict__ out_f32,
                       bf16* __restrict__ out_bf16, float* __restrict__ part,
                       int rows, int d, float eps) {
  extern __shared__ float acc[];  // [LNB_WARPS][NQ][d]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < LNB_WARPS * NQ * d; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  float* my = acc + (size_t)warp * NQ * d;
  const int r0 = blockIdx.x * LNB_ROWS;
  const int r1 = min(rows, r0 + LNB_ROWS);
  const int d2 = d >> 1;
  for (int row = r0 + warp; row < r1; row += LNB_WARPS) {
    const __nv_bfloat162* xr =
        reinterpret_cast<const __nv_bfloat162*>(x + (size_t)row * d);
    const float* dr = dh + (size_t)row * d;
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
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < d2; c += 32) {
      const float2 v = __bfloat1622float2(xr[c]);
      const float xa = (v.x - mean) * inv, xb = (v.y - mean) * inv;
      const float ga = dr[2 * c] * scale[2 * c], gb = dr[2 * c + 1] * scale[2 * c + 1];
      s1 += ga + gb;
      s2 += ga * xa + gb * xb;
    }
    const float m1 = warp_sum(s1) / (float)d, m2 = warp_sum(s2) / (float)d;
    for (int c = lane; c < d2; c += 32) {
      const float2 v = __bfloat1622float2(xr[c]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = 2 * c + e;
        const float xh = ((e ? v.y : v.x) - mean) * inv;
        const float g = dr[cc];
        const float res = to_f32(resid[(size_t)row * d + cc]);
        const float o = res + inv * (g * scale[cc] - m1 - xh * m2);
        if (out_f32) out_f32[(size_t)row * d + cc] = o;
        if (out_bf16) out_bf16[(size_t)row * d + cc] = __float2bfloat16(o);
        my[cc] += g * xh;
        my[d + cc] += g;
        if (NQ == 4) {
          my[2 * d + cc] += o;
          my[3 * d + cc] += res;
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NQ * d; i += blockDim.x) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < LNB_WARPS; ++w) t += acc[(size_t)w * NQ * d + i];
    part[(size_t)blockIdx.x * NQ * d + i] = t;
  }
}

// ----------------------------------------------------------------------------
// Attention backward: one block per (pair, head).  Recomputes the scores and
// probabilities from the stashed qkv, writes the recomputed head output att
// (the forward's, bit for bit) and dq, dk, dv.
// ----------------------------------------------------------------------------
constexpr int ATT_THREADS = 128;

__global__ void __launch_bounds__(ATT_THREADS)
    pair_attention_bwd_kernel(const bf16* __restrict__ qkv,
                              const bf16* __restrict__ datt,
                              bf16* __restrict__ att, bf16* __restrict__ dqkv,
                              int t_pad, int t_valid, int d, int dh, float scale) {
  extern __shared__ float sm[];
  const int pair = blockIdx.x, h = blockIdx.y;
  const int ld = dh + 1;  // skew: rows of dh floats would share banks
  const int lds = t_pad + 1;
  float* q = sm;
  float* k = q + t_pad * ld;
  float* v = k + t_pad * ld;
  float* go = v + t_pad * ld;   // d att of this head
  float* p = go + t_pad * ld;   // t_pad x lds probabilities (f32)
  float* ds = p + t_pad * lds;  // t_pad x lds dp, then bf16(ds * scale)
  const size_t row0 = (size_t)pair * t_pad;

  for (int e = threadIdx.x; e < t_pad * dh; e += ATT_THREADS) {
    const int t = e / dh, c = e % dh;
    const bf16* r = qkv + (row0 + t) * (size_t)(3 * d) + h * dh + c;
    q[t * ld + c] = __bfloat162float(r[0]);
    k[t * ld + c] = __bfloat162float(r[d]);
    v[t * ld + c] = __bfloat162float(r[2 * d]);
    go[t * ld + c] = __bfloat162float(datt[(row0 + t) * (size_t)d + h * dh + c]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < t_pad * t_valid; e += ATT_THREADS) {
    const int i = e / t_valid, j = e % t_valid;
    float acc = 0.f;
    for (int c = 0; c < dh; ++c) acc += q[i * ld + c] * k[j * ld + c];
    p[i * lds + j] = acc * scale;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < t_pad; i += ATT_THREADS) {
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
  // att = bf16(p) v, rounded; dp = g v^T
  for (int e = threadIdx.x; e < t_pad * dh; e += ATT_THREADS) {
    const int i = e / dh, c = e % dh;
    float acc = 0.f;
    for (int j = 0; j < t_valid; ++j) acc += round_bf16(p[i * lds + j]) * v[j * ld + c];
    att[(row0 + i) * (size_t)d + h * dh + c] = __float2bfloat16(acc);
  }
  for (int e = threadIdx.x; e < t_pad * t_valid; e += ATT_THREADS) {
    const int i = e / t_valid, j = e % t_valid;
    float acc = 0.f;
    for (int c = 0; c < dh; ++c) acc += go[i * ld + c] * v[j * ld + c];
    ds[i * lds + j] = acc;
  }
  __syncthreads();
  // ds = p (dp - sum_j dp p), rounded to bf16 after the scale
  for (int i = threadIdx.x; i < t_pad; i += ATT_THREADS) {
    float rd = 0.f;
    for (int j = 0; j < t_valid; ++j) rd += ds[i * lds + j] * p[i * lds + j];
    for (int j = 0; j < t_valid; ++j)
      ds[i * lds + j] = round_bf16(p[i * lds + j] * (ds[i * lds + j] - rd) * scale);
  }
  __syncthreads();
  bf16* out = dqkv + h * dh;
  for (int e = threadIdx.x; e < t_pad * dh; e += ATT_THREADS) {
    const int i = e / dh, c = e % dh;
    float dq = 0.f;
    for (int j = 0; j < t_valid; ++j) dq += ds[i * lds + j] * k[j * ld + c];
    float dk = 0.f, dv = 0.f;
    if (i < t_valid) {  // masked keys get no gradient
      for (int r = 0; r < t_pad; ++r) {
        dk += ds[r * lds + i] * q[r * ld + c];
        dv += round_bf16(p[r * lds + i]) * go[r * ld + c];
      }
    }
    bf16* row = out + (row0 + i) * (size_t)(3 * d) + c;
    row[0] = __float2bfloat16(dq);
    row[d] = __float2bfloat16(dk);
    row[2 * d] = __float2bfloat16(dv);
  }
}

// ----------------------------------------------------------------------------
// host side
// ----------------------------------------------------------------------------
extern "C" const char* veto_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

static int num_sms() {
  int dev = 0, n = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// Split count of a (M x N, K over rows) weight-gradient GEMM: about four
// blocks per SM, and at least 8 k-tiles a split.  Depends on the shapes and
// the card only, so a run's partial sums always have the same ranges.
static int splitk_count(int M, int N, int K) {
  const int tiles = (N / BN) * ((M + BM - 1) / BM);
  const int want = (4 * num_sms() + tiles - 1) / tiles;
  const int most = (K + 8 * BK - 1) / (8 * BK);
  const int s = want < most ? want : most;
  return s < 1 ? 1 : s;
}
static int splitk_chunk(int K, int splits) {
  return ((K + splits - 1) / splits + BK - 1) / BK * BK;
}

template <bool TA, bool TB, int EPI>
static int launch_gemm(const bf16* A, const bf16* B, int M, int N, int K,
                       int lda, int ldb, Epi epi, cudaStream_t s) {
  const dim3 grid(N / BN, (M + BM - 1) / BM, 1);
  gemm_kernel<TA, TB, EPI><<<grid, GEMM_THREADS, 0, s>>>(A, B, M, N, K, lda,
                                                           ldb, K, epi);
  return (int)cudaGetLastError();
}

// C (M x N, bf16) = A^T B over K rows: A stored K x M, B stored K x N, both
// row-major.  part holds splitk_count(M, N, K) x M x N floats.
static int weight_grad(const bf16* A, const bf16* B, int M, int N, int K,
                       float* part, bf16* out, cudaStream_t s) {
  const int chunk = splitk_chunk(K, splitk_count(M, N, K));
  const int splits = (K + chunk - 1) / chunk;
  Epi epi = {nullptr, nullptr, part, nullptr, nullptr};
  gemm_kernel<true, false, EPI_SPLITK>
      <<<dim3(N / BN, (M + BM - 1) / BM, splits), GEMM_THREADS, 0, s>>>(
          A, B, M, N, K, M, N, chunk, epi);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t mn = (size_t)M * N;
  splitk_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(part, splits,
                                                                    mn, out);
  return (int)cudaGetLastError();
}

static int colsum(const float* part, int nblk, int ncols, float* out,
                  cudaStream_t s) {
  colsum_reduce_kernel<<<(ncols + 31) / 32, dim3(32, 8), 0, s>>>(part, nblk,
                                                                 ncols, out);
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

template <int NQ, typename RES>
static int launch_ln_backward(const bf16* x, const float* dh, const RES* resid,
                              const float* scale, float* out_f32, bf16* out_bf16,
                              float* part, int rows, int d, cudaStream_t s) {
  const int smem = LNB_WARPS * NQ * d * (int)sizeof(float);
  auto kern = ln_backward_kernel<NQ, RES>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kern<<<(rows + LNB_ROWS - 1) / LNB_ROWS, LNB_WARPS * 32, smem, s>>>(
      x, dh, resid, scale, out_f32, out_bf16, part, rows, d, 1e-6f);
  return (int)cudaGetLastError();
}

// workspace carving: 256-byte aligned sub-buffers
struct Carve {
  char* base;
  size_t used;
  template <typename T>
  T* take(size_t n) {
    T* p = (T*)(base ? base + used : nullptr);
    used += (n * sizeof(T) + 255) / 256 * 256;
    return p;
  }
};

static size_t ln_blocks(int rows) { return (rows + LNB_ROWS - 1) / LNB_ROWS; }
static size_t row_tiles(int rows) { return (rows + BM - 1) / BM; }

// Pass A's workspace, carved from `base` (nullptr: just count the bytes).
struct FfnWork {
  bf16 *h2, *gb, *df1b;
  float *f1, *dh2, *part_b1, *part_ln, *part_w;
};
static size_t ffn_work(char* base, int rows, int d, int f, FfnWork* w) {
  Carve c{base, 0};
  w->h2 = c.take<bf16>((size_t)rows * d);
  w->f1 = c.take<float>((size_t)rows * f);
  w->gb = c.take<bf16>((size_t)rows * f);
  w->df1b = c.take<bf16>((size_t)rows * f);
  w->dh2 = c.take<float>((size_t)rows * d);
  w->part_b1 = c.take<float>(row_tiles(rows) * f);
  w->part_ln = c.take<float>(ln_blocks(rows) * 4 * d);
  const size_t s1 = (size_t)splitk_count(d, f, rows) * d * f;
  const size_t s2 = (size_t)splitk_count(f, d, rows) * f * d;
  w->part_w = c.take<float>(s1 > s2 ? s1 : s2);
  return c.used;
}

struct AttWork {
  bf16 *h1, *datt, *att, *dqkv;
  float *dh1, *part_ln, *part_w;
};
static size_t att_work(char* base, int rows, int d, AttWork* w) {
  Carve c{base, 0};
  w->h1 = c.take<bf16>((size_t)rows * d);
  w->datt = c.take<bf16>((size_t)rows * d);
  w->att = c.take<bf16>((size_t)rows * d);
  w->dqkv = c.take<bf16>((size_t)rows * 3 * d);
  w->dh1 = c.take<float>((size_t)rows * d);
  w->part_ln = c.take<float>(ln_blocks(rows) * 2 * d);
  const size_t s1 = (size_t)splitk_count(d, 3 * d, rows) * d * 3 * d;
  const size_t s2 = (size_t)splitk_count(d, d, rows) * d * d;
  w->part_w = c.take<float>(s1 > s2 ? s1 : s2);
  return c.used;
}

extern "C" size_t encoder_ffn_backward_workspace(int rows, int d, int f) {
  FfnWork w;
  return ffn_work(nullptr, rows, d, f, &w);
}
extern "C" size_t encoder_att_backward_workspace(int rows, int d) {
  AttWork w;
  return att_work(nullptr, rows, d, &w);
}

// Shared memory of the attention backward kernel for (t_pad, dh), in bytes.
extern "C" int encoder_attention_bwd_smem_bytes(int t_pad, int dh) {
  return (4 * t_pad * (dh + 1) + 2 * t_pad * (t_pad + 1)) * (int)sizeof(float);
}

// Pass A.  In: x1 (rows, d) bf16 stash, dy (rows, d) bf16, LN2 scale/bias
// and b1 f32, w1 (d, f) and w2 (f, d) bf16.  Out: dx1 (rows, d) f32 and its
// bf16 rounding dx1b, dw1 (d, f) and dw2 (f, d) bf16, vec4 (4, d) f32 =
// [d ln2_scale, d ln2_bias, d b_out, d b2], db1 (f,) f32.  workspace holds
// encoder_ffn_backward_workspace(rows, d, f) bytes.  d and f multiples of 64.
extern "C" int encoder_ffn_backward(
    const void* x1, const void* dy, const void* ln2_s, const void* ln2_b,
    const void* w1, const void* b1, const void* w2, void* dx1, void* dx1b,
    void* dw1, void* dw2, void* vec4, void* db1, void* workspace, int rows,
    int d, int f, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  FfnWork w;
  ffn_work((char*)workspace, rows, d, f, &w);
  const bf16* X1 = (const bf16*)x1;
  const bf16* DY = (const bf16*)dy;
  int err;
  if ((err = launch_layernorm(X1, (const float*)ln2_s, (const float*)ln2_b, w.h2,
                              rows, d, s)))
    return err;
  // f1 = h2 W1 + b1 (kept in f32), g = bf16(gelu f1)
  Epi e1 = {(const float*)b1, nullptr, w.f1, w.gb, nullptr};
  if ((err = launch_gemm<false, false, EPI_BIAS_GELU_SAVE>(
           w.h2, (const bf16*)w1, rows, f, d, d, f, e1, s)))
    return err;
  // df1 = (dy W2^T) gelu'(f1), bf16; per-tile column sums for d b1
  Epi e2 = {nullptr, w.f1, nullptr, w.df1b, w.part_b1};
  if ((err = launch_gemm<false, true, EPI_GELU_BWD>(DY, (const bf16*)w2, rows, f,
                                                    d, d, d, e2, s)))
    return err;
  if ((err = colsum(w.part_b1, (int)row_tiles(rows), f, (float*)db1, s))) return err;
  // dh2 = df1 W1^T
  Epi e3 = {nullptr, nullptr, w.dh2, nullptr, nullptr};
  if ((err = launch_gemm<false, true, EPI_F32>(w.df1b, (const bf16*)w1, rows, d,
                                               f, f, f, e3, s)))
    return err;
  // dx1 = dy + LN2 backward; column sums of dh2 xhat2, dh2, dx1, dy
  if ((err = launch_ln_backward<4, bf16>(X1, w.dh2, DY, (const float*)ln2_s,
                                         (float*)dx1, (bf16*)dx1b, w.part_ln,
                                         rows, d, s)))
    return err;
  if ((err = colsum(w.part_ln, (int)ln_blocks(rows), 4 * d, (float*)vec4, s)))
    return err;
  // dW1 = h2^T df1, dW2 = g^T dy
  if ((err = weight_grad(w.h2, w.df1b, d, f, rows, w.part_w, (bf16*)dw1, s)))
    return err;
  return weight_grad(w.gb, DY, f, d, rows, w.part_w, (bf16*)dw2, s);
}

// Pass B.  In: x (rows, d) bf16 (the layer input), qkv (rows, 3d) bf16
// stash, dx1 (rows, d) f32 and dx1b bf16 from pass A, LN1 scale/bias f32,
// w_qkv (d, 3d) and w_out (d, d) bf16.  Out: dx (rows, d) bf16, dwqkv and
// dwout bf16, vec2 (2, d) f32 = [d ln1_scale, d ln1_bias].  workspace holds
// encoder_att_backward_workspace(rows, d) bytes.  att_scale = dh**-0.5 as
// the forward has it.
extern "C" int encoder_att_backward(
    const void* x, const void* qkv, const void* dx1, const void* dx1b,
    const void* ln1_s, const void* ln1_b, const void* w_qkv, const void* w_out,
    void* dx, void* dwqkv, void* dwout, void* vec2, void* workspace, int rows,
    int d, int heads, int t_pad, int t_valid, float att_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  AttWork w;
  att_work((char*)workspace, rows, d, &w);
  const bf16* X = (const bf16*)x;
  const bf16* DX1B = (const bf16*)dx1b;
  const int dh = d / heads;
  const int pairs = rows / t_pad;
  int err;
  if ((err = launch_layernorm(X, (const float*)ln1_s, (const float*)ln1_b, w.h1,
                              rows, d, s)))
    return err;
  // datt = bf16(dx1) Wout^T, rounded to bf16
  Epi e1 = {nullptr, nullptr, nullptr, w.datt, nullptr};
  if ((err = launch_gemm<false, true, EPI_BF16>(DX1B, (const bf16*)w_out, rows,
                                                d, d, d, d, e1, s)))
    return err;
  const int smem = encoder_attention_bwd_smem_bytes(t_pad, dh);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(pair_attention_bwd_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  pair_attention_bwd_kernel<<<dim3(pairs, heads), ATT_THREADS, smem, s>>>(
      (const bf16*)qkv, w.datt, w.att, w.dqkv, t_pad, t_valid, d, dh, att_scale);
  if ((err = (int)cudaGetLastError())) return err;
  // dh1 = bf16(dqkv) Wqkv^T
  Epi e2 = {nullptr, nullptr, w.dh1, nullptr, nullptr};
  if ((err = launch_gemm<false, true, EPI_F32>(w.dqkv, (const bf16*)w_qkv, rows,
                                               d, 3 * d, 3 * d, 3 * d, e2, s)))
    return err;
  // dx = dx1 + LN1 backward; column sums of dh1 xhat1, dh1
  if ((err = launch_ln_backward<2, float>(X, w.dh1, (const float*)dx1,
                                          (const float*)ln1_s, nullptr, (bf16*)dx,
                                          w.part_ln, rows, d, s)))
    return err;
  if ((err = colsum(w.part_ln, (int)ln_blocks(rows), 2 * d, (float*)vec2, s)))
    return err;
  // dWqkv = h1^T dqkv, dWout = att^T bf16(dx1)
  if ((err = weight_grad(w.h1, w.dqkv, d, 3 * d, rows, w.part_w, (bf16*)dwqkv, s)))
    return err;
  return weight_grad(w.att, DX1B, d, d, rows, w.part_w, (bf16*)dwout, s);
}
