// Multi-level ROIAlign forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of veto_tpu/ops/roi_align_windowed.py
// (_windowed_pool_raw -> _pool_kernel_factory).  Semantics are those of
// veto_tpu_torch/ops/roi_align.py (the reference CUDA ROIAlign): no -0.5
// offset, rois at least 1 px, sampling_ratio^2 bilinear samples per bin,
// samples with y < -1 or y > H (x likewise) contribute 0, coordinates clamp
// to >= 0 and snap onto the last pixel.  There is no window: each roi reads
// its assigned level directly.
//
// Bound: memory (the f32 output and the taps the rois touch; ~16 FMAs per
// output element).  One block per (roi, bin row); the block's P x s x s
// samples get their four taps and weights computed once into shared memory,
// then threads stride over channels so each NHWC tap load is coalesced.
// f32 weights, f32 accumulation.  Compiled with the default FMA contraction
// off for the coordinate arithmetic (explicit __fmul_rn/__fadd_rn), so the
// sample coordinates equal the plain PyTorch version's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEVELS 4
#define MAX_SAMPLES 256  // pooled * sampling * sampling per bin row

struct Levels {
  const void* feat[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  float scale[MAX_LEVELS];
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void roi_align_fwd_kernel(Levels lv, const float* __restrict__ rois,
                                     const int* __restrict__ levels,
                                     float* __restrict__ out, int rois_per_image,
                                     int channels, int pooled, int sampling) {
  __shared__ int tap_off[MAX_SAMPLES][4];
  __shared__ float tap_w[MAX_SAMPLES][4];

  const int roi = blockIdx.x;  // b * R + r
  const int i = blockIdx.y;    // bin row
  const int b = roi / rois_per_image;
  int l = levels[roi];
  l = l < 0 ? 0 : (l >= MAX_LEVELS ? MAX_LEVELS - 1 : l);
  const T* feat = static_cast<const T*>(lv.feat[l]);
  const int H = lv.h[l], W = lv.w[l];
  const float scale = lv.scale[l];
  const float fh = (float)H, fw = (float)W;

  const float x1 = __fmul_rn(rois[4 * roi + 0], scale);
  const float y1 = __fmul_rn(rois[4 * roi + 1], scale);
  const float x2 = __fmul_rn(rois[4 * roi + 2], scale);
  const float y2 = __fmul_rn(rois[4 * roi + 3], scale);
  const float bin_w = fmaxf(__fadd_rn(x2, -x1), 1.0f) / (float)pooled;
  const float bin_h = fmaxf(__fadd_rn(y2, -y1), 1.0f) / (float)pooled;

  const int per_bin = sampling * sampling;
  const int n_samples = pooled * per_bin;  // samples of this bin row
  for (int t = threadIdx.x; t < n_samples; t += blockDim.x) {
    const int j = t / per_bin;
    const int iy = (t % per_bin) / sampling;
    const int ix = t % sampling;
    const float oy = ((float)iy + 0.5f) / (float)sampling;
    const float ox = ((float)ix + 0.5f) / (float)sampling;
    float y = __fadd_rn(y1, __fmul_rn(__fadd_rn((float)i, oy), bin_h));
    float x = __fadd_rn(x1, __fmul_rn(__fadd_rn((float)j, ox), bin_w));
    const bool oob = (y < -1.0f) || (y > fh) || (x < -1.0f) || (x > fw);
    y = fmaxf(y, 0.0f);
    x = fmaxf(x, 0.0f);
    const float y_low = fminf(floorf(y), fh - 1.0f);
    const float x_low = fminf(floorf(x), fw - 1.0f);
    const float y_high = fminf(y_low + 1.0f, fh - 1.0f);
    const float x_high = fminf(x_low + 1.0f, fw - 1.0f);
    if (y_low >= fh - 1.0f) y = y_low;
    if (x_low >= fw - 1.0f) x = x_low;
    const float ly = __fadd_rn(y, -y_low), lx = __fadd_rn(x, -x_low);
    const float hy = __fadd_rn(1.0f, -ly), hx = __fadd_rn(1.0f, -lx);
    const int yl = (int)y_low, xl = (int)x_low, yh = (int)y_high, xh = (int)x_high;
    tap_off[t][0] = yl * W + xl;
    tap_off[t][1] = yl * W + xh;
    tap_off[t][2] = yh * W + xl;
    tap_off[t][3] = yh * W + xh;
    tap_w[t][0] = oob ? 0.0f : __fmul_rn(hy, hx);
    tap_w[t][1] = oob ? 0.0f : __fmul_rn(hy, lx);
    tap_w[t][2] = oob ? 0.0f : __fmul_rn(ly, hx);
    tap_w[t][3] = oob ? 0.0f : __fmul_rn(ly, lx);
  }
  __syncthreads();

  const T* img = feat + (size_t)b * H * W * channels;
  float* orow = out + ((size_t)roi * pooled + i) * pooled * channels;
  const float inv = 1.0f / (float)per_bin;
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    for (int j = 0; j < pooled; ++j) {
      float acc = 0.0f;
      for (int k = 0; k < per_bin; ++k) {
        const int t = j * per_bin + k;
        float v = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v += tap_w[t][q] * load_f32(img + (size_t)tap_off[t][q] * channels + c);
        acc += v;
      }
      orow[(size_t)j * channels + c] = acc * inv;
    }
  }
}

extern "C" const char* veto_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// feats/heights/widths/scales are host arrays of num_levels entries; rois,
// levels and out are device pointers: rois (B*R, 4) f32, levels (B*R,) int32,
// out (B*R, P, P, C) f32.  Returns cudaGetLastError() after the launch.
extern "C" int roi_align_forward(const void* const* feats, const int* heights,
                                 const int* widths, const float* scales,
                                 int num_levels, const void* rois,
                                 const void* levels, void* out, int batch,
                                 int rois_per_image, int channels, int pooled,
                                 int sampling, int is_bf16, void* stream) {
  if (num_levels < 1 || num_levels > MAX_LEVELS ||
      pooled * sampling * sampling > MAX_SAMPLES || pooled <= 0 ||
      sampling <= 0 || channels <= 0)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    const int k = l < num_levels ? l : 0;
    lv.feat[l] = feats[k];
    lv.h[l] = heights[k];
    lv.w[l] = widths[k];
    lv.scale[l] = scales[k];
  }
  const int n_rois = batch * rois_per_image;
  if (n_rois == 0) return 0;
  const dim3 grid(n_rois, pooled);
  const int threads = channels < 256 ? ((channels + 31) / 32) * 32 : 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        lv, (const float*)rois, (const int*)levels, (float*)out, rois_per_image,
        channels, pooled, sampling);
  else
    roi_align_fwd_kernel<float><<<grid, threads, 0, s>>>(
        lv, (const float*)rois, (const int*)levels, (float*)out, rois_per_image,
        channels, pooled, sampling);
  return (int)cudaGetLastError();
}
