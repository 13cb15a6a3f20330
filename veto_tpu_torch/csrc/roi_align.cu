// Multi-level ROIAlign forward and backward for Hopper (sm_90a).
//
// The forward replaces the Pallas TPU kernel of
// veto_tpu/ops/roi_align_windowed.py (_windowed_pool_raw ->
// _pool_kernel_factory).  The backward is the gradient JAX takes by autodiff
// of veto_tpu/ops/roi_align.py roi_align (the trainable depth map, pooled at
// veto_tpu/models/sgg.py:551-556).  Semantics are those of
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
//
// Backward: the transpose, a scatter.  Same blocks and taps; each bin's
// gradient, over sampling^2, goes to the 2x2 taps of each of its samples
// with the sample's bilinear weights (zero for samples off the map; taps
// clamped at the edge take the weight of both).  Bound: memory, the f32
// gradient read once and the touched map pixels updated.  Different rois
// and bins touch the same pixels, so the updates are f32 atomicAdds into an
// f32 buffer the caller zeroes: the sum's order, and so its last f32 bits,
// change from run to run.

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

// The four taps and bilinear weights of every sample of bin row i of one
// roi, into shared memory (n_samples = pooled * sampling^2 entries).
__device__ __forceinline__ void bin_row_taps(const float* __restrict__ roi,
                                             float scale, int H, int W, int i,
                                             int pooled, int sampling,
                                             int (*tap_off)[4],
                                             float (*tap_w)[4]) {
  const float fh = (float)H, fw = (float)W;
  const float x1 = __fmul_rn(roi[0], scale);
  const float y1 = __fmul_rn(roi[1], scale);
  const float x2 = __fmul_rn(roi[2], scale);
  const float y2 = __fmul_rn(roi[3], scale);
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
}

__device__ __forceinline__ int clamp_level(int l) {
  return l < 0 ? 0 : (l >= MAX_LEVELS ? MAX_LEVELS - 1 : l);
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
  const int l = clamp_level(levels[roi]);
  const T* feat = static_cast<const T*>(lv.feat[l]);
  const int H = lv.h[l], W = lv.w[l];
  bin_row_taps(rois + 4 * roi, lv.scale[l], H, W, i, pooled, sampling, tap_off,
               tap_w);
  __syncthreads();

  const int per_bin = sampling * sampling;
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

// grad[l] (B, H_l, W_l, C) f32 += the transpose of the forward applied to
// gout (B*R, P, P, C); levels whose grad pointer is null are skipped.
__global__ void roi_align_bwd_kernel(Levels lv, const float* __restrict__ rois,
                                     const int* __restrict__ levels,
                                     const float* __restrict__ gout,
                                     int rois_per_image, int channels,
                                     int pooled, int sampling) {
  __shared__ int tap_off[MAX_SAMPLES][4];
  __shared__ float tap_w[MAX_SAMPLES][4];

  const int roi = blockIdx.x;
  const int i = blockIdx.y;
  const int b = roi / rois_per_image;
  const int l = clamp_level(levels[roi]);
  float* grad = (float*)lv.feat[l];
  if (grad == nullptr) return;  // uniform over the block
  const int H = lv.h[l], W = lv.w[l];
  bin_row_taps(rois + 4 * roi, lv.scale[l], H, W, i, pooled, sampling, tap_off,
               tap_w);
  __syncthreads();

  const int per_bin = sampling * sampling;
  float* img = grad + (size_t)b * H * W * channels;
  const float* grow = gout + ((size_t)roi * pooled + i) * pooled * channels;
  const float inv = 1.0f / (float)per_bin;
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    for (int j = 0; j < pooled; ++j) {
      const float g = grow[(size_t)j * channels + c] * inv;
      for (int k = 0; k < per_bin; ++k) {
        const int t = j * per_bin + k;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float w = tap_w[t][q];
          if (w != 0.0f)
            atomicAdd(img + (size_t)tap_off[t][q] * channels + c, w * g);
        }
      }
    }
  }
}

extern "C" const char* veto_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

static bool fill_levels(Levels* lv, const void* const* ptrs, const int* heights,
                        const int* widths, const float* scales, int num_levels,
                        int pooled, int sampling, int channels) {
  if (num_levels < 1 || num_levels > MAX_LEVELS ||
      pooled * sampling * sampling > MAX_SAMPLES || pooled <= 0 ||
      sampling <= 0 || channels <= 0)
    return false;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    const int k = l < num_levels ? l : 0;
    lv->feat[l] = ptrs[k];
    lv->h[l] = heights[k];
    lv->w[l] = widths[k];
    lv->scale[l] = scales[k];
  }
  return true;
}

static int threads_for(int channels) {
  return channels < 256 ? ((channels + 31) / 32) * 32 : 256;
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
  Levels lv;
  if (!fill_levels(&lv, feats, heights, widths, scales, num_levels, pooled,
                   sampling, channels))
    return (int)cudaErrorInvalidValue;
  const int n_rois = batch * rois_per_image;
  if (n_rois == 0) return 0;
  const dim3 grid(n_rois, pooled);
  const int threads = threads_for(channels);
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

// grads: host array of num_levels device pointers to zeroed f32 maps
// (B, H_l, W_l, C), null for a level that needs no gradient; grad_out
// (B*R, P, P, C) f32; rois and levels as for roi_align_forward.
extern "C" int roi_align_backward(void* const* grads, const int* heights,
                                  const int* widths, const float* scales,
                                  int num_levels, const void* rois,
                                  const void* levels, const void* grad_out,
                                  int batch, int rois_per_image, int channels,
                                  int pooled, int sampling, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, (const void* const*)grads, heights, widths, scales,
                   num_levels, pooled, sampling, channels))
    return (int)cudaErrorInvalidValue;
  const int n_rois = batch * rois_per_image;
  if (n_rois == 0) return 0;
  roi_align_bwd_kernel<<<dim3(n_rois, pooled), threads_for(channels), 0,
                         (cudaStream_t)stream>>>(
      lv, (const float*)rois, (const int*)levels, (const float*)grad_out,
      rois_per_image, channels, pooled, sampling);
  return (int)cudaGetLastError();
}
