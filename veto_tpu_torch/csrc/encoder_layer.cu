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
// The layer is a fixed sequence of seven launches:
//   LN1 -> GEMM(qkv) -> per-(pair, head) attention -> GEMM(out-proj + bias +
//   residual) -> LN2 -> GEMM(FFN1 + bias + GELU) -> GEMM(FFN2 + bias +
//   residual)
// The four GEMMs (99% of the work) run on the Hopper GEMM core of
// gemm_sm90.cuh: wgmma on 128x192 block tiles that TMA streams through an
// mbarrier ring, W read MN-major as it lies; their epilogues apply bias,
// GELU and the residual before the single bf16 rounding.  Attention (13.6
// GFLOP per layer, 1% of the work) runs on the CUDA cores from shared
// memory.  Weights are kept (in, out) row-major, the JAX package's layout.

#include "gemm_sm90.cuh"

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
  Epi epi{};
  epi.bias = bias;
  epi.resid = resid;
  epi.out_bf16 = C;
  return gemm<EPI>(A, B, M, N, K, epi, s);
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
// scratch: h (rows, d), qkv (rows, 3d), x1 (rows, d), g (rows, f), all
// bf16.  After the call qkv and x1 hold the layer's qkv and x1 (the stash
// the backward reads) unless g aliases qkv, which an inference call may do
// to save the buffer (f <= 3d): the GELU activations then overwrite qkv.  Weights
// (in, out) row-major bf16, LN scale/bias and biases f32.  Requires d and f
// multiples of 64 (16-byte TMA strides and whole 64-deep k-tiles), d a
// multiple of heads, and 16-byte aligned pointers; the caller checks.
// att_scale is dh**-0.5 rounded once to f32, as the TPU kernel has it.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int encoder_layer_forward(
    const void* x, void* y, void* h, void* qkv, void* x1, void* g,
    const void* ln1_s,
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
  if ((err = launch_gemm<EPI_BF16>(H, (const bf16*)w_qkv, nullptr, nullptr,
                                    QKV, rows, 3 * d, d, s)))
    return err;
  // attention output overwrites h: LN1's output is consumed by the qkv GEMM
  pair_attention_kernel<<<dim3(pairs, heads), ATT_THREADS,
                          encoder_attention_smem_bytes(t_pad, dh), s>>>(
      QKV, H, t_pad, t_valid, d, dh, att_scale);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = launch_gemm<EPI_BIAS_RESID>(H, (const bf16*)w_out,
                                            (const float*)b_out, X, X1, rows,
                                            d, d, s)))
    return err;
  if ((err = launch_layernorm(X1, (const float*)ln2_s, (const float*)ln2_b, H,
                              rows, d, s)))
    return err;
  bf16* G = (bf16*)g;
  if ((err = launch_gemm<EPI_BIAS_GELU>(H, (const bf16*)w1, (const float*)b1,
                                        nullptr, G, rows, f, d, s)))
    return err;
  return launch_gemm<EPI_BIAS_RESID>(G, (const bf16*)w2, (const float*)b2,
                                        X1, (bf16*)y, rows, d, f, s);
}
