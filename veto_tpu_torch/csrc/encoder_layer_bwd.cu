// Fused VETO encoder layer backward for Hopper (sm_90a): the two passes of
// the split backward, and the monolithic backward.
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
// and the Pallas kernel driven by _bwd (the backward with FUSED_SPLIT off,
// or of a call that kept no stash):
//
//   B5, _bwd_kernel (encoder_mono_backward below): both sub-blocks in one
//     entry point, pass A's launches then pass B's, emitting dx, the vector
//     grads, dWqkv and dWout, and instead of dW1 and dW2 their factors h2,
//     bf16(df1) and bf16(g), as _bwd_kernel does (the caller takes
//     h2^T df1 and g^T dy).  Without the stash it first recomputes qkv and
//     x1 with the forward's launches for LN1, the qkv GEMM and the
//     out-projection with bias and residual, but att with the tensor-core
//     attention of pair_attention_sm90.cuh in forward mode, not with B1's
//     own attention launch (encoder_layer.cu, on the CUDA cores): its sums
//     run in another order, so att, x1 and what follows may differ from
//     the forward's by a bf16 rounding.
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
// B5 runs f1, dg, dh2, datt, dh1, dWqkv and dWout (2.2 TFLOP, ~2.2 ms), and
// without the stash also qkv and the out-projection (2.8 TFLOP, ~2.8 ms).
// Each pass is a fixed sequence of launches: LayerNorm recompute, the
// Hopper GEMM core of gemm_sm90.cuh (wgmma fed by TMA through an mbarrier
// ring) with either operand read K-major or MN-major as it lies in its
// row-major storage, the per-pair attention backward on the tensor cores
// (mma.sync on the pair's rows staged by bulk copies;
// pair_attention_sm90.cuh, which B4a and B4b share), and a row-wise
// LayerNorm backward that reads each row once.  Pass A's first product is
// dual: one launch computes f1 = h2 W1 + b1 and dg = dy W2^T for the same
// (rows x F) tile and writes only g = bf16(gelu f1), df1 = bf16(dg
// gelu'(f1)) and the tile's column sums of df1, so f1 never reaches device
// memory (the TPU kernel keeps it in VMEM).
//
// Determinism: the weight gradients are contractions over all rows and the
// vector gradients column sums over all rows.  Where the TPU kernel
// accumulated across its sequential grid, here a split-K GEMM writes one
// f32 partial per row range and a second kernel sums the partials in a fixed
// order; column sums are per-block partials summed in a fixed order.  No
// atomics, so two runs give bit-equal gradients.

#include "pair_attention_sm90.cuh"

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
// fixed-order reductions of the GEMM core's per-block partials
// ----------------------------------------------------------------------------
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
// LayerNorm backward: one warp per row, LNB_WARPS warps and LNB_ROWS rows a
// block.
//   out = resid + inv (dxhat - mean(dxhat) - xhat mean(dxhat xhat)),
//   dxhat = dh * scale,
// with the block's column sums of dh * xhat, dh (and, NQ = 4, of out and
// resid) written to part[blockIdx.x] for colsum_reduce_kernel.
//
// Bound: bytes.  B2b's LN1 backward (NQ = 2) reads x (bf16), dh1 and dx1
// (f32) and writes dx (bf16): 12 bytes an element, 1.61 GB at 233,472 rows
// x 576, 0.48 ms at 3.35 TB/s.  So each row is read once: a lane loads its
// NP column pairs (2 (lane + 32 i) + {0, 1}) of x, dh and resid with one
// coalesced vector load each and keeps them, its columns' scale and its
// columns' partial sums over all its rows in registers; the block's warps
// meet once, at the end, to sum their partials in a fixed order.
// ----------------------------------------------------------------------------
constexpr int LNB_WARPS = 8, LNB_ROWS = 256, LNB_MAX_D = 768;

__device__ __forceinline__ float2 load2(const float* p, size_t i) {
  return reinterpret_cast<const float2*>(p)[i];
}
__device__ __forceinline__ float2 load2(const bf16* p, size_t i) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[i]);
}

template <int NQ, typename RES, int NP>
__global__ void __launch_bounds__(LNB_WARPS * 32)
    ln_backward_kernel(const bf16* __restrict__ x, const float* __restrict__ dh,
                       const RES* __restrict__ resid,
                       const float* __restrict__ scale, float* __restrict__ out_f32,
                       bf16* __restrict__ out_bf16, float* __restrict__ part,
                       int rows, float eps) {
  constexpr int D = 64 * NP;
  extern __shared__ float red[];  // [LNB_WARPS][NQ][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float2 sc[NP], acc[NQ][NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    sc[i] = load2(scale, lane + 32 * i);
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q][i] = make_float2(0.f, 0.f);
  }
  const int r1 = min(rows, (int)(blockIdx.x + 1) * LNB_ROWS);
  for (int row = blockIdx.x * LNB_ROWS + warp; row < r1; row += LNB_WARPS) {
    const size_t o = (size_t)row * (D / 2) + lane;  // this lane's first pair
    float2 xv[NP], g[NP], rs[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      xv[i] = load2(x, o + 32 * i);
      g[i] = load2(dh, o + 32 * i);
      rs[i] = load2(resid, o + 32 * i);
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) s += xv[i].x + xv[i].y;
    const float mean = warp_sum(s) / (float)D;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const float a = xv[i].x - mean, b = xv[i].y - mean;
      var += a * a + b * b;
    }
    const float inv = rsqrtf(warp_sum(var) / (float)D + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      xv[i] = make_float2((xv[i].x - mean) * inv, (xv[i].y - mean) * inv);  // xhat
      const float ga = g[i].x * sc[i].x, gb = g[i].y * sc[i].y;
      s1 += ga + gb;
      s2 += ga * xv[i].x + gb * xv[i].y;
    }
    const float m1 = warp_sum(s1) / (float)D, m2 = warp_sum(s2) / (float)D;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const float oa = rs[i].x + inv * (g[i].x * sc[i].x - m1 - xv[i].x * m2);
      const float ob = rs[i].y + inv * (g[i].y * sc[i].y - m1 - xv[i].y * m2);
      if (out_f32) reinterpret_cast<float2*>(out_f32)[o + 32 * i] = make_float2(oa, ob);
      if (out_bf16)
        reinterpret_cast<__nv_bfloat162*>(out_bf16)[o + 32 * i] =
            __floats2bfloat162_rn(oa, ob);
      acc[0][i].x += g[i].x * xv[i].x;
      acc[0][i].y += g[i].y * xv[i].y;
      acc[1][i].x += g[i].x;
      acc[1][i].y += g[i].y;
      if constexpr (NQ == 4) {
        acc[2][i].x += oa;
        acc[2][i].y += ob;
        acc[3][i].x += rs[i].x;
        acc[3][i].y += rs[i].y;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int i = 0; i < NP; ++i)
      reinterpret_cast<float2*>(red + (warp * NQ + q) * D)[lane + 32 * i] = acc[q][i];
  __syncthreads();
  for (int j = threadIdx.x; j < NQ * D; j += blockDim.x) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < LNB_WARPS; ++w) t += red[w * NQ * D + j];
    part[(size_t)blockIdx.x * NQ * D + j] = t;
  }
}

// ----------------------------------------------------------------------------
// host side
// ----------------------------------------------------------------------------
extern "C" const char* veto_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Split count of a (M x N, K over rows) weight-gradient GEMM: as many
// splits as keep the card's SMs busy for about four waves of one block
// each (rounded down, so the last wave is nearly full), and at least 8
// k-tiles a split.  Depends on the shapes and the card only, so a run's
// partial sums always have the same ranges.  fused_encoder.splitk_count
// mirrors it for the wrappers' workspace checks.
static int splitk_count(int M, int N, int K) {
  const int tiles = ((N + GEMM_BN - 1) / GEMM_BN) * ((M + GEMM_BM - 1) / GEMM_BM);
  const int want = 4 * num_sms() / tiles;
  const int most = (K + 8 * GEMM_BK - 1) / (8 * GEMM_BK);
  const int s = want < most ? want : most;
  return s < 1 ? 1 : s;
}
static int splitk_chunk(int K, int splits) {
  return ((K + splits - 1) / splits + GEMM_BK - 1) / GEMM_BK * GEMM_BK;
}
static int splitk_splits(int M, int N, int K) {
  const int chunk = splitk_chunk(K, splitk_count(M, N, K));
  return (K + chunk - 1) / chunk;
}

// C (M x N, bf16) = A^T B over K rows: A stored K x M, B stored K x N, both
// row-major, so both are read MN-major.  part holds splitk_splits(M, N, K)
// x M x N floats.
static int weight_grad(const bf16* A, const bf16* B, int M, int N, int K,
                       float* part, bf16* out, cudaStream_t s) {
  const int chunk = splitk_chunk(K, splitk_count(M, N, K));
  const int splits = (K + chunk - 1) / chunk;
  Epi epi{};
  epi.out_f32 = part;
  int err = gemm_launch<GEMM_BN, true, true, true, EPI_SPLITK>(
      A, B, nullptr, nullptr, M, N, K, splits, chunk, epi, s);
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

// The LN backward for d = 64 NP: the instance with NP column pairs a lane.
template <int NQ, typename RES, int NP = 1>
static int launch_ln_backward(const bf16* x, const float* dh, const RES* resid,
                              const float* scale, float* out_f32, bf16* out_bf16,
                              float* part, int rows, int d, cudaStream_t s) {
  if constexpr (64 * NP > LNB_MAX_D) {
    return (int)cudaErrorInvalidValue;  // d not a multiple of 64, or too wide
  } else {
    if (d != 64 * NP)
      return launch_ln_backward<NQ, RES, NP + 1>(x, dh, resid, scale, out_f32,
                                                 out_bf16, part, rows, d, s);
    const int smem = LNB_WARPS * NQ * d * (int)sizeof(float);
    auto kern = ln_backward_kernel<NQ, RES, NP>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kern<<<(rows + LNB_ROWS - 1) / LNB_ROWS, LNB_WARPS * 32, smem, s>>>(
        x, dh, resid, scale, out_f32, out_bf16, part, rows, 1e-6f);
    return (int)cudaGetLastError();
  }
}

// Shared memory of the attention backward kernel for (t_pad, d), in bytes
// (fused_encoder.attention_bwd_smem_bytes mirrors it).
extern "C" int encoder_attention_bwd_smem_bytes(int t_pad, int d) {
  return att_smem_bytes(t_pad, d);
}

// The attention backward alone, as B2b and B5 launch it: qkv (pairs t_pad,
// 3d) and datt (pairs t_pad, d) bf16 in, att (pairs t_pad, d) and dqkv
// (pairs t_pad, 3d) bf16 out; datt null: the forward only (att; dqkv is
// not written).
extern "C" int encoder_attention_backward(const void* qkv, const void* datt,
                                          void* att, void* dqkv, int pairs,
                                          int heads, int t_pad, int t_valid,
                                          int d, float scale, void* stream) {
  return launch_attention((const bf16*)qkv, (const bf16*)datt, (bf16*)att,
                          (bf16*)dqkv, pairs, heads, t_pad, t_valid, d, scale,
                          (cudaStream_t)stream);
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
static size_t row_tiles(int rows) { return (rows + GEMM_BM - 1) / GEMM_BM; }

// Pass A's workspace, carved from `base` (nullptr: just count the bytes).
struct FfnWork {
  bf16 *h2, *gb, *df1b;
  float *dh2, *part_b1, *part_ln, *part_w;
};
static size_t ffn_work(char* base, int rows, int d, int f, FfnWork* w) {
  Carve c{base, 0};
  w->h2 = c.take<bf16>((size_t)rows * d);
  w->gb = c.take<bf16>((size_t)rows * f);
  w->df1b = c.take<bf16>((size_t)rows * f);
  w->dh2 = c.take<float>((size_t)rows * d);
  w->part_b1 = c.take<float>(row_tiles(rows) * f);
  w->part_ln = c.take<float>(ln_blocks(rows) * 4 * d);
  const size_t s1 = (size_t)splitk_splits(d, f, rows) * d * f;
  const size_t s2 = (size_t)splitk_splits(f, d, rows) * f * d;
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
  const size_t s1 = (size_t)splitk_splits(d, 3 * d, rows) * d * 3 * d;
  const size_t s2 = (size_t)splitk_splits(d, d, rows) * d * d;
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

// The FFN sub-block's backward without its weight gradients: h2 = LN2(x1),
// then one dual launch for f1 = h2 W1 + b1 (f32, kept in registers) and
// dg = dy W2^T: g = bf16(gelu f1), df1 = bf16(dg gelu'(f1)) and per-tile
// column sums of df1; dh2 = df1 W1^T, dx1 = dy + LN2 backward (f32 and
// bf16), vec4 = [d ln2 scale, d ln2 bias, d b_out, d b2], db1.  Scratch:
// dh2 (rows, d) f32, part_b1 and part_ln (4 d) per block.
static int ffn_backward_core(const bf16* X1, const bf16* DY, const float* ln2_s,
                             const float* ln2_b, const bf16* w1, const float* b1,
                             const bf16* w2, bf16* h2, bf16* gb, bf16* df1b,
                             float* dh2, float* part_b1, float* part_ln,
                             float* dx1, bf16* dx1b, float* vec4, float* db1,
                             int rows, int d, int f, cudaStream_t s) {
  int err;
  if ((err = launch_layernorm(X1, ln2_s, ln2_b, h2, rows, d, s))) return err;
  // W1 (d, f) read MN-major; W2 (f, d) read K-major as W2^T
  Epi e1{};
  e1.bias = b1;
  e1.out_bf16 = gb;
  e1.out2_bf16 = df1b;
  e1.colsum = part_b1;
  if ((err = gemm_launch<GEMM_BN_DUAL, false, true, false, EPI_DUAL_GELU_BWD>(
           h2, w1, DY, w2, rows, f, d, 1, d, e1, s)))
    return err;
  if ((err = colsum(part_b1, (int)row_tiles(rows), f, db1, s))) return err;
  // dh2 = df1 W1^T
  Epi e2{};
  e2.out_f32 = dh2;
  if ((err = gemm<EPI_F32, true>(df1b, w1, rows, d, f, e2, s))) return err;
  // dx1 = dy + LN2 backward; column sums of dh2 xhat2, dh2, dx1, dy
  if ((err = launch_ln_backward<4, bf16>(X1, dh2, DY, ln2_s, dx1, dx1b, part_ln,
                                         rows, d, s)))
    return err;
  return colsum(part_ln, (int)ln_blocks(rows), 4 * d, vec4, s);
}

// The attention sub-block's backward: h1 = LN1(x), datt = bf16(bf16(dx1)
// Wout^T), the attention backward (recomputed att, dqkv), dh1 = dqkv
// Wqkv^T, dx = bf16(dx1 + LN1 backward), vec2 = [d ln1 scale, d ln1 bias],
// dWqkv = h1^T dqkv, dWout = att^T bf16(dx1).
static int att_backward_core(const bf16* X, const bf16* QKV, const float* DX1,
                             const bf16* DX1B, const float* ln1_s,
                             const float* ln1_b, const bf16* w_qkv,
                             const bf16* w_out, bf16* dx, bf16* dwqkv,
                             bf16* dwout, float* vec2, const AttWork& w,
                             int rows, int d, int heads, int t_pad, int t_valid,
                             float att_scale, cudaStream_t s) {
  const int pairs = rows / t_pad;
  int err;
  if ((err = launch_layernorm(X, ln1_s, ln1_b, w.h1, rows, d, s))) return err;
  // datt = bf16(dx1) Wout^T, rounded to bf16
  Epi e1{};
  e1.out_bf16 = w.datt;
  if ((err = gemm<EPI_BF16, true>(DX1B, w_out, rows, d, d, e1, s))) return err;
  if ((err = launch_attention(QKV, w.datt, w.att, w.dqkv, pairs, heads, t_pad,
                              t_valid, d, att_scale, s)))
    return err;
  // dh1 = bf16(dqkv) Wqkv^T
  Epi e2{};
  e2.out_f32 = w.dh1;
  if ((err = gemm<EPI_F32, true>(w.dqkv, w_qkv, rows, d, 3 * d, e2, s))) return err;
  // dx = dx1 + LN1 backward; column sums of dh1 xhat1, dh1
  if ((err = launch_ln_backward<2, float>(X, w.dh1, DX1, ln1_s, nullptr, dx,
                                          w.part_ln, rows, d, s)))
    return err;
  if ((err = colsum(w.part_ln, (int)ln_blocks(rows), 2 * d, vec2, s))) return err;
  // dWqkv = h1^T dqkv, dWout = att^T bf16(dx1)
  if ((err = weight_grad(w.h1, w.dqkv, d, 3 * d, rows, w.part_w, dwqkv, s)))
    return err;
  return weight_grad(w.att, DX1B, d, d, rows, w.part_w, dwout, s);
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
  const bf16* DY = (const bf16*)dy;
  int err;
  if ((err = ffn_backward_core((const bf16*)x1, DY, (const float*)ln2_s,
                               (const float*)ln2_b, (const bf16*)w1,
                               (const float*)b1, (const bf16*)w2, w.h2, w.gb,
                               w.df1b, w.dh2, w.part_b1, w.part_ln,
                               (float*)dx1, (bf16*)dx1b, (float*)vec4,
                               (float*)db1, rows, d, f, s)))
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
  AttWork w;
  att_work((char*)workspace, rows, d, &w);
  return att_backward_core(
      (const bf16*)x, (const bf16*)qkv, (const float*)dx1, (const bf16*)dx1b,
      (const float*)ln1_s, (const float*)ln1_b, (const bf16*)w_qkv,
      (const bf16*)w_out, (bf16*)dx, (bf16*)dwqkv, (bf16*)dwout, (float*)vec2, w,
      rows, d, heads, t_pad, t_valid, att_scale, (cudaStream_t)stream);
}

// B5's workspace: pass B's, then pass A's scratch, dx1 in f32 and bf16, and
// without the stash the recomputed qkv and x1.
struct MonoWork {
  AttWork att;
  bf16 *qkv, *x1, *dx1b;
  float *dh2, *dx1, *part_b1, *part_ln;
};
static size_t mono_work(char* base, int rows, int d, int f, bool stash,
                        MonoWork* w) {
  Carve c{base, att_work(base, rows, d, &w->att)};
  w->dh2 = c.take<float>((size_t)rows * d);
  w->dx1 = c.take<float>((size_t)rows * d);
  w->dx1b = c.take<bf16>((size_t)rows * d);
  w->part_b1 = c.take<float>(row_tiles(rows) * f);
  w->part_ln = c.take<float>(ln_blocks(rows) * 4 * d);
  w->qkv = stash ? nullptr : c.take<bf16>((size_t)rows * 3 * d);
  w->x1 = stash ? nullptr : c.take<bf16>((size_t)rows * d);
  return c.used;
}

extern "C" size_t encoder_mono_backward_workspace(int rows, int d, int f,
                                                  int stash) {
  MonoWork w;
  return mono_work(nullptr, rows, d, f, stash != 0, &w);
}

// B5, the monolithic layer backward (_bwd_kernel).  In: x, dy (rows, d)
// bf16; qkv (rows, 3d) and x1 (rows, d) bf16, the forward's stash, or both
// null to recompute them here (h1 = LN1 x, qkv = bf16(h1 Wqkv), att,
// x1 = x + bf16(att Wout + b_out); att by the tensor-core attention, whose
// sums run in another order than B1's, so not bit for bit the forward's
// where a rounding falls the other way); the 11
// layer parameters in EncoderLayerParams order (b2 unused).  Out: dx, h2
// (rows, d), df1, g (rows, f) bf16 (h2, df1, g are the factors of dW1 =
// h2^T df1 and dW2 = g^T dy, taken outside); vec6 (6, d) f32 = [d ln1
// scale, d ln1 bias, d ln2 scale, d ln2 bias, d b_out, d b2], db1 (f,) f32;
// dwqkv (d, 3d) and dwout (d, d) bf16.  workspace holds
// encoder_mono_backward_workspace(rows, d, f, stash) bytes.
extern "C" int encoder_mono_backward(
    const void* x, const void* qkv, const void* x1, const void* dy,
    const void* ln1_s, const void* ln1_b, const void* w_qkv, const void* w_out,
    const void* b_out, const void* ln2_s, const void* ln2_b, const void* w1,
    const void* b1, const void* w2, const void* b2, void* dx, void* h2,
    void* df1, void* g, void* vec6, void* db1, void* dwqkv, void* dwout,
    void* workspace, int rows, int d, int f, int heads, int t_pad, int t_valid,
    float att_scale, void* stream) {
  (void)b2;
  cudaStream_t s = (cudaStream_t)stream;
  const bool stash = qkv != nullptr;
  MonoWork w;
  mono_work((char*)workspace, rows, d, f, stash, &w);
  const bf16* X = (const bf16*)x;
  const bf16* QKV = stash ? (const bf16*)qkv : w.qkv;
  const bf16* X1 = stash ? (const bf16*)x1 : w.x1;
  int err;
  if (!stash) {
    if ((err = launch_layernorm(X, (const float*)ln1_s, (const float*)ln1_b,
                                w.att.h1, rows, d, s)))
      return err;
    Epi e1{};
    e1.out_bf16 = w.qkv;
    if ((err = gemm<EPI_BF16>(w.att.h1, (const bf16*)w_qkv, rows, 3 * d, d, e1, s)))
      return err;
    if ((err = launch_attention(w.qkv, nullptr, w.att.att, nullptr, rows / t_pad,
                                heads, t_pad, t_valid, d, att_scale, s)))
      return err;
    Epi e2{};
    e2.bias = (const float*)b_out;
    e2.resid = X;
    e2.out_bf16 = w.x1;
    if ((err = gemm<EPI_BIAS_RESID>(w.att.att, (const bf16*)w_out, rows, d, d, e2, s)))
      return err;
  }
  float* vec = (float*)vec6;
  if ((err = ffn_backward_core(X1, (const bf16*)dy, (const float*)ln2_s,
                               (const float*)ln2_b, (const bf16*)w1,
                               (const float*)b1, (const bf16*)w2, (bf16*)h2,
                               (bf16*)g, (bf16*)df1, w.dh2, w.part_b1,
                               w.part_ln, w.dx1, w.dx1b, vec + 2 * d,
                               (float*)db1, rows, d, f, s)))
    return err;
  return att_backward_core(X, QKV, w.dx1, w.dx1b, (const float*)ln1_s,
                           (const float*)ln1_b, (const bf16*)w_qkv,
                           (const bf16*)w_out, (bf16*)dx, (bf16*)dwqkv,
                           (bf16*)dwout, vec, w.att, rows, d, heads, t_pad,
                           t_valid, att_scale, s);
}

// The split count of weight_grad for (M, N, K) on this card.
extern "C" int encoder_splitk_count(int M, int N, int K) {
  return splitk_count(M, N, K);
}

// Scratch of encoder_gemm_product's weight-gradient form, in bytes.
extern "C" size_t encoder_gemm_workspace(int M, int N, int K) {
  return (size_t)splitk_splits(M, N, K) * M * N * sizeof(float);
}

// The GEMM core alone, in the operand majors the encoder uses, so that it
// can be held against a plain product and timed at the encoder's shapes:
//   mode 0: c (M, N) f32 = a (M, K) b, b (K, N) row-major (x W);
//   mode 1: c (M, N) f32 = a (M, K) b^T, b (N, K) row-major (dy W^T);
//   mode 2: c (M, N) bf16 = a^T b, a (K, M) and b (K, N) row-major, split-K
//           with the fixed-order reduction (the weight gradients);
//           workspace holds encoder_gemm_workspace(M, N, K) bytes.
extern "C" int encoder_gemm_product(const void* a, const void* b, void* c,
                                    void* workspace, int M, int N, int K,
                                    int mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* A = (const bf16*)a;
  const bf16* B = (const bf16*)b;
  Epi epi{};
  epi.out_f32 = (float*)c;
  if (mode == 0) return gemm<EPI_F32>(A, B, M, N, K, epi, s);
  if (mode == 1) return gemm<EPI_F32, true>(A, B, M, N, K, epi, s);
  if (mode == 2) return weight_grad(A, B, M, N, K, (float*)workspace, (bf16*)c, s);
  return (int)cudaErrorInvalidValue;
}
