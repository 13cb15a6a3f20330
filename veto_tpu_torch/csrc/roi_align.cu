// Multi-level ROIAlign forward and backward for Hopper (sm_90a).
//
// The forward replaces the Pallas TPU kernel of
// veto_tpu/ops/roi_align_windowed.py (_windowed_pool_raw ->
// _pool_kernel_factory).  The backward is the gradient JAX takes by autodiff
// of veto_tpu/ops/roi_align.py roi_align (the trainable depth map, pooled at
// veto_tpu/models/sgg.py:551-556), and of every FPN level for detector
// pretraining.  Semantics are those of veto_tpu_torch/ops/roi_align.py (the
// reference CUDA ROIAlign): no -0.5 offset, rois at least 1 px,
// sampling_ratio^2 bilinear samples per bin, samples with y < -1 or y > H
// (x likewise) contribute 0, coordinates clamp to >= 0 and snap onto the
// last pixel.  There is no window: each roi reads its assigned level
// directly.  A roi whose level is past the last map given pools zeros and
// takes no gradient, as in the plain version.
//
// Separable taps.  A sample's y depends only on (bin row, iy) and its x only
// on (bin column, ix), so a roi has pooled * sampling row taps and as many
// column taps (struct Tap: low and high pixel, their weights, or lo = -1 for
// a sample off the map).  A sample's four tap weights are products of one
// row and one column weight, rounded as the plain version rounds them
// (__fmul_rn / __fadd_rn, no contraction): its coordinates and weights equal
// the plain version's bit for bit.
//
// Forward.  Bound: bytes (the f32 output and the taps the rois touch; ~16
// multiply-adds per output).  One block per roi: it computes the roi's 2 P s
// taps once into shared memory and reuses them over all P^2 bins.  A lane
// owns 8 consecutive bf16 channels (4 f32): each tap is one 16-byte load and
// a bin's f32 result one or two 16-byte stores; one warp covers 256 bf16
// channels of a bin, the block's warps take the roi's bins in turn, so
// neighbouring bins share tap rows in L1.  No branch guards a load: a sample
// off the map reads pixel 0 and a select drops it, so a bin's 4 s^2 loads
// are all in flight at once.
//
// Backward: the transpose, computed by the owners of the outputs, with no
// atomics.  Bound: bytes (the f32 bin gradients in, the map gradient out).
// One block per (image, level, tile of the level's map); every pixel of a
// needed level is owned by one slot of threads (BWD_PIX pixels a slot), and
// a lane of a slot owns 8 (bf16) or 4 (f32) channels of its pixels.  Each
// warp ballots 32 of the image's rois: those of the block's level whose tap
// bounding box -- the first sample's low tap to the last sample's high tap,
// coordinates rising with the sample index -- meets the tile.  The hits, in
// roi order, go 32 at a time: the block computes their taps and the bins
// each sends the tile (a rectangle: the bins of the samples whose taps land
// in the tile's rows and columns); then, in passes of BWD_STAGE_BYTES of
// shared memory, stages those bins' gradients (cp.async, 16 bytes a copy)
// and each bin's weight at each pixel of the tile.  The weight is
// separable, wy x wx: wy is the sum, in sample order, of the bin row's
// sample taps that land on the pixel's row, wx likewise for its column.  A
// tap clamped at the last row or column lands twice on one pixel (the
// second with weight 0).  Each owner then walks the pass's bins in one
// fixed order (roi, bin row, bin column), skips a bin of weight 0 at its
// pixels and adds weight x bin gradient in f32 registers.  The sum is
// scaled by 1 / sampling^2 once and written once, in the map's dtype, 0
// where no roi reaches: no zero-fill, no cast pass, and two runs are
// bit-equal.  A tile that many rois reach is summed by its block alone, a
// pass per 60 bins at 256 channels: the zero boxes that pad an image's
// boxes all pool the map's corner, and that one block sets the kernel's
// time on the main path's boxes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEVELS 4
#define MAX_AXIS 32      // pooled * sampling: a roi's samples along one axis
#define MAX_SAMPLING 4
#define FWD_THREADS 256
#define BWD_THREADS 512
#define BWD_CHUNK 32     // hit rois whose taps a backward block holds at once
#define BWD_TILE_W 8     // tile columns
#define BWD_PIX 2        // pixels a slot of a backward block owns, one column
#define BWD_WARPS (BWD_THREADS / 32)
#define BWD_GROUP (BWD_WARPS * 32)  // rois one round of ballots covers
#define BWD_STAGE_BYTES 65536       // dynamic shared memory: a pass's bins
// lanes a pixel's channels take (C / 8 bf16, C / 4 f32): at most 64, so a
// backward block holds at least one tile row of BWD_TILE_W pixels
#define MAX_UNITS (BWD_THREADS / BWD_TILE_W)

struct Levels {
  const void* feat[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  float scale[MAX_LEVELS];
  int num_levels;
  int tile_start[MAX_LEVELS + 1];  // backward: first tile of each level
  int tiles_x[MAX_LEVELS];
};

// One sample along one axis: its low and high tap and their weights; lo = -1
// when the sample is off the map (y < -1 or y > size).
struct Tap {
  int lo, hi;
  float wl, wh;
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
// this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
};

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[V]) {
#pragma unroll
  for (int q = 0; q < V; q += 4)
    *reinterpret_cast<float4*>(p + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
}

// the same with the evict-first hint: the forward's output is not read
// again by the kernel, so it should not push the maps' taps out of L2
template <int V>
__device__ __forceinline__ void store_f32_streaming(float* p, const float (&v)[V]) {
#pragma unroll
  for (int q = 0; q < V; q += 4)
    __stcs(reinterpret_cast<float4*>(p + q), make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]));
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  store_f32<4>(p, v);
}

// A roi's start and bin size along one axis (0: x, 1: y) on a level.
__device__ __forceinline__ void roi_axis(const float* __restrict__ roi, int axis,
                                         float scale, int pooled, float* start,
                                         float* bin) {
  const float a = __fmul_rn(roi[axis], scale);
  const float b = __fmul_rn(roi[axis + 2], scale);
  *start = a;
  *bin = fmaxf(__fadd_rn(b, -a), 1.0f) / (float)pooled;
}

// The coordinate of sample k = bin * sampling + sub along one axis.
__device__ __forceinline__ float sample_coord(float start, float bin, int k,
                                              int sampling) {
  const int cell = k / sampling, sub = k - cell * sampling;
  const float off = ((float)sub + 0.5f) / (float)sampling;
  return __fadd_rn(start, __fmul_rn(__fadd_rn((float)cell, off), bin));
}

// The low tap of a coordinate, ignoring whether the sample is on the map.
__device__ __forceinline__ int low_tap(float c, int size) {
  return (int)fminf(floorf(fmaxf(c, 0.0f)), (float)size - 1.0f);
}

__device__ __forceinline__ Tap axis_tap(float c, int size) {
  const float n = (float)size;
  Tap t;
  if (c < -1.0f || c > n) {
    t.lo = t.hi = -1;
    t.wl = t.wh = 0.0f;
    return t;
  }
  c = fmaxf(c, 0.0f);
  const float low = fminf(floorf(c), n - 1.0f);
  const float high = fminf(low + 1.0f, n - 1.0f);
  if (low >= n - 1.0f) c = low;
  const float l = __fadd_rn(c, -low);
  t.lo = (int)low;
  t.hi = (int)high;
  t.wl = __fadd_rn(1.0f, -l);
  t.wh = l;
  return t;
}

__device__ __forceinline__ int roi_level(const int* levels, int roi) {
  const int l = levels[roi];
  return l < 0 ? 0 : l;
}

template <typename T, int S>
__global__ void __launch_bounds__(FWD_THREADS)
roi_align_fwd_kernel(Levels lv, const float* __restrict__ rois,
                     const int* __restrict__ levels, float* __restrict__ out,
                     int rois_per_image, int channels, int pooled,
                     int sampling_arg) {
  constexpr int V = Vec<T>::N;
  const int sampling = S > 0 ? S : sampling_arg;
  __shared__ Tap ty[MAX_AXIS], tx[MAX_AXIS];

  const int roi = blockIdx.x;  // b * R + r
  const int b = roi / rois_per_image;
  const int l = roi_level(levels, roi);
  const int units = channels / V;
  const int slots = FWD_THREADS / units;
  const int slot = threadIdx.x / units, u = threadIdx.x - slot * units;
  float* obase = out + (size_t)roi * pooled * pooled * channels + u * V;
  if (l >= lv.num_levels) {  // no map for this level: the plain version's zeros
    if (slot < slots) {
      float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int bin = slot; bin < pooled * pooled; bin += slots)
#pragma unroll
        for (int q = 0; q < V; q += 4) store_f32<4>(obase + (size_t)bin * channels + q, z);
    }
    return;
  }
  const int H = lv.h[l], W = lv.w[l];
  const int n_axis = pooled * sampling;
  if (threadIdx.x < 2 * n_axis) {
    const bool is_y = threadIdx.x < n_axis;
    const int k = is_y ? threadIdx.x : threadIdx.x - n_axis;
    float start, bin;
    roi_axis(rois + 4 * (size_t)roi, is_y ? 1 : 0, lv.scale[l], pooled, &start, &bin);
    const Tap t = axis_tap(sample_coord(start, bin, k, sampling), is_y ? H : W);
    if (is_y)
      ty[k] = t;
    else
      tx[k] = t;
  }
  __syncthreads();
  if (slot >= slots) return;

  const T* img = static_cast<const T*>(lv.feat[l]) + (size_t)b * H * W * channels + u * V;
  const float inv = 1.0f / (float)(sampling * sampling);
  for (int bin = slot; bin < pooled * pooled; bin += slots) {
    const int i = bin / pooled, j = bin - i * pooled;
    float acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = 0.0f;
    // no branch around the loads: a sample off the map reads pixel 0 and
    // is dropped by a select, so all 4 s^2 loads of a bin are in flight at once
#pragma unroll
    for (int iy = 0; iy < (S > 0 ? S : sampling); ++iy) {
      const Tap y = ty[i * sampling + iy];
      const T* row_lo = img + (size_t)max(y.lo, 0) * W * channels;
      const T* row_hi = img + (size_t)max(y.hi, 0) * W * channels;
#pragma unroll
      for (int ix = 0; ix < (S > 0 ? S : sampling); ++ix) {
        const Tap x = tx[j * sampling + ix];
        const bool on_map = y.lo >= 0 && x.lo >= 0;
        const size_t xl = (size_t)max(x.lo, 0) * channels;
        const size_t xh = (size_t)max(x.hi, 0) * channels;
        float t0[V], t1[V], t2[V], t3[V];
        load_vec(row_lo + xl, t0);
        load_vec(row_lo + xh, t1);
        load_vec(row_hi + xl, t2);
        load_vec(row_hi + xh, t3);
        const float w0 = __fmul_rn(y.wl, x.wl), w1 = __fmul_rn(y.wl, x.wh);
        const float w2 = __fmul_rn(y.wh, x.wl), w3 = __fmul_rn(y.wh, x.wh);
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const float v = w0 * t0[q] + w1 * t1[q] + w2 * t2[q] + w3 * t3[q];
          acc[q] += on_map ? v : 0.0f;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] *= inv;
    store_f32_streaming<V>(obase + (size_t)bin * channels, acc);
  }
}

// grad[l] (B, H_l, W_l, C) in the maps' dtype = the transpose of the forward
// applied to gout (B*R, P, P, C) f32, for the levels with tiles (a level
// whose grad pointer is null has none).  A slot (channels / V threads) owns
// BWD_PIX pixels of the tile, in one column, tile_h / BWD_PIX rows apart.
template <typename T, int S>
__global__ void __launch_bounds__(BWD_THREADS)
roi_align_bwd_kernel(Levels lv, const float* __restrict__ rois,
                     const int* __restrict__ levels,
                     const float* __restrict__ gout, int rois_per_image,
                     int channels, int pooled, int sampling_arg, int tile_h) {
  constexpr int V = Vec<T>::N;
  const int sampling = S > 0 ? S : sampling_arg;
  extern __shared__ float4 stage_raw[];  // BWD_STAGE_BYTES: a pass's bins
  __shared__ Tap ty[BWD_CHUNK][MAX_AXIS], tx[BWD_CHUNK][MAX_AXIS];
  __shared__ int hit_roi[BWD_CHUNK];
  __shared__ int rect[BWD_CHUNK][3];  // first bin row, first bin column, columns
  __shared__ int start[BWD_CHUNK + 1];  // a hit roi's first flat bin; the total last
  __shared__ unsigned masks[BWD_WARPS];

  const int tile = blockIdx.x;
  int l = 0;
  while (tile >= lv.tile_start[l + 1]) ++l;
  const int b = blockIdx.y;
  const int local = tile - lv.tile_start[l];
  const int H = lv.h[l], W = lv.w[l];
  const int y0 = (local / lv.tiles_x[l]) * tile_h;
  const int x0 = (local % lv.tiles_x[l]) * BWD_TILE_W;
  const int units = channels / V;
  const int row_step = tile_h / BWD_PIX;  // tile rows one pass of slots covers
  const int wrow = tile_h + BWD_TILE_W;   // a bin's weights: at each tile row, column
  const int slot = threadIdx.x / units, u = threadIdx.x - slot * units;
  const int tx_ = slot % BWD_TILE_W, ty0 = slot / BWD_TILE_W;
  const int px = x0 + tx_;
  const bool slot_owns = ty0 < row_step && px < W;
  const int n_axis = pooled * sampling;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float scale = lv.scale[l];
  const int first = b * rois_per_image;
  const float inv = 1.0f / (float)(sampling * sampling);
  // a pass: nb_stage bins' gradients (channels f32 each), their weights
  // (wrow each) and places (hit << 16 | bin row << 8 | bin column)
  const int nb_stage = BWD_STAGE_BYTES / ((channels + wrow + 1) * 4);
  float* stage = reinterpret_cast<float*>(stage_raw);
  float* wts = stage + (size_t)nb_stage * channels;
  int* place = reinterpret_cast<int*>(wts + (size_t)nb_stage * wrow);
  float acc[BWD_PIX][V];
#pragma unroll
  for (int m = 0; m < BWD_PIX; ++m)
#pragma unroll
    for (int q = 0; q < V; ++q) acc[m][q] = 0.0f;

  for (int g0 = 0; g0 < rois_per_image; g0 += BWD_GROUP) {
    // warp w ballots rois g0 + 32 w .. + 31 of this level whose tap box
    // meets the tile; the hits, in roi order, go in batches of BWD_CHUNK
    {
      const int r = g0 + 32 * warp + lane;
      bool hit = false;
      if (r < rois_per_image && roi_level(levels, first + r) == l) {
        const float* box = rois + 4 * (size_t)(first + r);
        float ys, yb, xs, xb;
        roi_axis(box, 1, scale, pooled, &ys, &yb);
        roi_axis(box, 0, scale, pooled, &xs, &xb);
        const int last = n_axis - 1;
        const int ylo = low_tap(sample_coord(ys, yb, 0, sampling), H);
        const int yhi = min(low_tap(sample_coord(ys, yb, last, sampling), H) + 1, H - 1);
        const int xlo = low_tap(sample_coord(xs, xb, 0, sampling), W);
        const int xhi = min(low_tap(sample_coord(xs, xb, last, sampling), W) + 1, W - 1);
        hit = ylo < y0 + tile_h && yhi >= y0 && xlo < x0 + BWD_TILE_W && xhi >= x0;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) masks[warp] = mask;
    }
    __syncthreads();
    int n_group = 0;
#pragma unroll
    for (int w = 0; w < BWD_WARPS; ++w) n_group += __popc(masks[w]);

    for (int hb = 0; hb < n_group; hb += BWD_CHUNK) {
      const int n_hit = min(BWD_CHUNK, n_group - hb);
      // the hit rois' taps
      for (int e = threadIdx.x; e < n_hit * 2 * n_axis; e += BWD_THREADS) {
        const int h = e / (2 * n_axis), rest = e - h * 2 * n_axis;
        int nth = hb + h, w = 0;
        while (nth >= __popc(masks[w])) nth -= __popc(masks[w++]);
        unsigned m = masks[w];
        for (int q = 0; q < nth; ++q) m &= m - 1u;  // drop the nth lowest hits
        const int rr = g0 + 32 * w + __ffs(m) - 1;
        const bool is_y = rest < n_axis;
        const int k = is_y ? rest : rest - n_axis;
        float start, bin;
        roi_axis(rois + 4 * (size_t)(first + rr), is_y ? 1 : 0, scale, pooled, &start, &bin);
        const Tap t = axis_tap(sample_coord(start, bin, k, sampling), is_y ? H : W);
        if (is_y)
          ty[h][k] = t;
        else
          tx[h][k] = t;
        if (rest == 0) hit_roi[h] = rr;
      }
      __syncthreads();
      // the bins each hit roi sends the tile: those of the samples whose
      // taps land in its rows and columns, a rectangle, flattened in (roi,
      // bin row, bin column) order
      if (warp == 0) {
        int cnt = 0, bi0 = 0, bj0 = 0, ncol = 1;
        if (lane < n_hit) {
          int ky0 = n_axis, ky1 = 0, kx0 = n_axis, kx1 = 0;
          for (int k = 0; k < n_axis; ++k) {
            const Tap y = ty[lane][k], x = tx[lane][k];
            if ((y.lo >= y0 && y.lo < y0 + tile_h) || (y.hi >= y0 && y.hi < y0 + tile_h)) {
              ky0 = min(ky0, k);
              ky1 = k + 1;
            }
            if ((x.lo >= x0 && x.lo < x0 + BWD_TILE_W) || (x.hi >= x0 && x.hi < x0 + BWD_TILE_W)) {
              kx0 = min(kx0, k);
              kx1 = k + 1;
            }
          }
          if (ky0 < ky1 && kx0 < kx1) {
            bi0 = ky0 / sampling;
            bj0 = kx0 / sampling;
            ncol = (kx1 - 1) / sampling - bj0 + 1;
            cnt = ((ky1 - 1) / sampling - bi0 + 1) * ncol;
          }
        }
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += v;
        }
        if (lane < n_hit) {
          rect[lane][0] = bi0;
          rect[lane][1] = bj0;
          rect[lane][2] = ncol;
          start[lane] = incl - cnt;
        }
        if (lane == 31) start[n_hit] = incl;
      }
      __syncthreads();
      const int n_flat = start[n_hit];
      for (int f0 = 0; f0 < n_flat; f0 += nb_stage) {
        const int nb = min(nb_stage, n_flat - f0);
        // each bin's hit roi and place
        for (int fb = threadIdx.x; fb < nb; fb += BWD_THREADS) {
          int h = 0, top = n_hit - 1;  // the last hit roi starting at or before f0 + fb
          while (h < top) {
            const int mid = (h + top + 1) >> 1;
            if (start[mid] <= f0 + fb)
              h = mid;
            else
              top = mid - 1;
          }
          const int in = f0 + fb - start[h];
          place[fb] = h << 16 | (rect[h][0] + in / rect[h][2]) << 8 |
                      (rect[h][1] + in % rect[h][2]);
        }
        __syncthreads();
        // stage the bins' gradients, 16 bytes a cp.async; meanwhile weigh
        // each bin at each tile row and column: the sum, in sample order,
        // of its samples' taps that land there
        for (int e = threadIdx.x; e < nb * units; e += BWD_THREADS) {
          const int fb = e / units, uu = e - fb * units;
          const int pl = place[fb], i = (pl >> 8) & 255, j = pl & 255;
          const float* src = gout + ((size_t)(first + hit_roi[pl >> 16]) * pooled * pooled +
                                     i * pooled + j) * channels + uu * V;
          float* dst = stage + (size_t)fb * channels + uu * V;
#pragma unroll
          for (int q = 0; q < V; q += 4) cp_async16(dst + q, src + q);
        }
        for (int e = threadIdx.x; e < nb * wrow; e += BWD_THREADS) {
          const int fb = e / wrow, r = e - fb * wrow;
          const int pl = place[fb], h = pl >> 16;
          const bool is_y = r < tile_h;
          const int pix = is_y ? y0 + r : x0 + r - tile_h;
          const Tap* tab = is_y ? &ty[h][((pl >> 8) & 255) * sampling]
                                : &tx[h][(pl & 255) * sampling];
          float w = 0.0f;
#pragma unroll
          for (int k = 0; k < (S > 0 ? S : sampling); ++k) {
            const Tap t = tab[k];
            if (t.lo == pix) w += t.wl;
            if (t.hi == pix) w += t.wh;
          }
          wts[e] = w;
        }
        cp_async_wait_all();
        __syncthreads();
        // each owner adds the pass's bins in (roi, bin row, bin column)
        // order, weight wy x wx; a bin that reaches neither of its pixels
        // is skipped
        if (slot_owns) {
          for (int fb = 0; fb < nb; ++fb) {
            const float* wr = wts + fb * wrow;
            const float wx = wr[tile_h + tx_];
            if (wx == 0.0f) continue;
            float w[BWD_PIX];
            bool any = false;
#pragma unroll
            for (int m = 0; m < BWD_PIX; ++m) {
              w[m] = __fmul_rn(wr[ty0 + m * row_step], wx);
              any |= w[m] != 0.0f;
            }
            if (!any) continue;
            const float* g = stage + (size_t)fb * channels + u * V;
#pragma unroll
            for (int q = 0; q < V; q += 4) {
              const float4 f = *reinterpret_cast<const float4*>(g + q);
#pragma unroll
              for (int m = 0; m < BWD_PIX; ++m) {
                acc[m][q] = fmaf(w[m], f.x, acc[m][q]);
                acc[m][q + 1] = fmaf(w[m], f.y, acc[m][q + 1]);
                acc[m][q + 2] = fmaf(w[m], f.z, acc[m][q + 2]);
                acc[m][q + 3] = fmaf(w[m], f.w, acc[m][q + 3]);
              }
            }
          }
        }
        __syncthreads();  // the next pass restages, the next batch rewrites the tables
      }
    }
    __syncthreads();  // the next group rewrites the masks
  }
  if (slot_owns) {
    T* grad = static_cast<T*>(const_cast<void*>(lv.feat[l]));
#pragma unroll
    for (int m = 0; m < BWD_PIX; ++m) {
      const int py = y0 + ty0 + m * row_step;
#pragma unroll
      for (int q = 0; q < V; ++q) acc[m][q] *= inv;  // the mean over a bin's samples
      if (py < H)
        store_vec(grad + (((size_t)b * H + py) * W + px) * channels + u * V, acc[m]);
    }
  }
}

template <typename K>
static void launch_bwd(K kernel, dim3 grid, cudaStream_t s, Levels lv,
                       const float* rois, const int* levels, const float* gout,
                       int rois_per_image, int channels, int pooled, int sampling,
                       int tile_h) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       BWD_STAGE_BYTES);
  kernel<<<grid, BWD_THREADS, BWD_STAGE_BYTES, s>>>(
      lv, rois, levels, gout, rois_per_image, channels, pooled, sampling, tile_h);
}

extern "C" const char* veto_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Rows of a backward tile for a channel count (columns: BWD_TILE_W); 0 when
// the kernel cannot take the count.  ops/roi_align_windowed.py mirrors it.
extern "C" int roi_align_bwd_tile_rows(int channels, int is_bf16) {
  const int v = is_bf16 ? 8 : 4;
  if (channels <= 0 || channels % v || channels / v > MAX_UNITS) return 0;
  return BWD_PIX * (BWD_THREADS / (channels / v) / BWD_TILE_W);
}

static bool fill_levels(Levels* lv, const void* const* ptrs, const int* heights,
                        const int* widths, const float* scales, int num_levels,
                        int pooled, int sampling, int channels, int is_bf16) {
  const int v = is_bf16 ? 8 : 4;
  if (num_levels < 1 || num_levels > MAX_LEVELS || pooled <= 0 || sampling <= 0 ||
      sampling > MAX_SAMPLING || pooled * sampling > MAX_AXIS || channels <= 0 ||
      channels % v || channels / v > MAX_UNITS)
    return false;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    const int k = l < num_levels ? l : 0;
    lv->feat[l] = l < num_levels ? ptrs[k] : nullptr;
    lv->h[l] = heights[k];
    lv->w[l] = widths[k];
    lv->scale[l] = scales[k];
    lv->tiles_x[l] = 0;
    lv->tile_start[l] = 0;
  }
  lv->tile_start[MAX_LEVELS] = 0;
  lv->num_levels = num_levels;
  return true;
}

// feats/heights/widths/scales are host arrays of num_levels entries; rois,
// levels and out are device pointers: rois (B*R, 4) f32, levels (B*R,) int32,
// out (B*R, P, P, C) f32; every map 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
extern "C" int roi_align_forward(const void* const* feats, const int* heights,
                                 const int* widths, const float* scales,
                                 int num_levels, const void* rois,
                                 const void* levels, void* out, int batch,
                                 int rois_per_image, int channels, int pooled,
                                 int sampling, int is_bf16, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, feats, heights, widths, scales, num_levels, pooled,
                   sampling, channels, is_bf16))
    return (int)cudaErrorInvalidValue;
  const int n_rois = batch * rois_per_image;
  if (n_rois == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* r = (const float*)rois;
  const int* lvl = (const int*)levels;
  float* o = (float*)out;
  // the four instances share one signature
  const auto kernel =
      is_bf16 ? (sampling == 2 ? roi_align_fwd_kernel<__nv_bfloat16, 2>
                               : roi_align_fwd_kernel<__nv_bfloat16, 0>)
              : (sampling == 2 ? roi_align_fwd_kernel<float, 2> : roi_align_fwd_kernel<float, 0>);
  kernel<<<n_rois, FWD_THREADS, 0, s>>>(lv, r, lvl, o, rois_per_image, channels, pooled,
                                         sampling);
  return (int)cudaGetLastError();
}

// grads: host array of num_levels device pointers to the map gradients
// (B, H_l, W_l, C) in the maps' dtype, null for a level that needs none;
// the kernel writes every element of each.  grad_out (B*R, P, P, C) f32,
// 16-byte aligned; rois and levels as for roi_align_forward.
extern "C" int roi_align_backward(void* const* grads, const int* heights,
                                  const int* widths, const float* scales,
                                  int num_levels, const void* rois,
                                  const void* levels, const void* grad_out,
                                  int batch, int rois_per_image, int channels,
                                  int pooled, int sampling, int is_bf16,
                                  void* stream) {
  Levels lv;
  if (!fill_levels(&lv, (const void* const*)grads, heights, widths, scales,
                   num_levels, pooled, sampling, channels, is_bf16))
    return (int)cudaErrorInvalidValue;
  const int tile_h = roi_align_bwd_tile_rows(channels, is_bf16);
  if (tile_h == 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  long long tiles = 0;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    lv.tile_start[l] = (int)tiles;
    if (l < num_levels && grads[l] != nullptr) {
      lv.tiles_x[l] = (widths[l] + BWD_TILE_W - 1) / BWD_TILE_W;
      tiles += (long long)lv.tiles_x[l] * ((heights[l] + tile_h - 1) / tile_h);
    }
  }
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lv.tile_start[MAX_LEVELS] = (int)tiles;
  if (tiles == 0 || batch == 0) return 0;
  const dim3 grid((unsigned)tiles, batch);
  cudaStream_t s = (cudaStream_t)stream;
  const float* r = (const float*)rois;
  const int* lvl = (const int*)levels;
  const float* g = (const float*)grad_out;
  const auto kernel =
      is_bf16 ? (sampling == 2 ? roi_align_bwd_kernel<__nv_bfloat16, 2>
                               : roi_align_bwd_kernel<__nv_bfloat16, 0>)
              : (sampling == 2 ? roi_align_bwd_kernel<float, 2> : roi_align_bwd_kernel<float, 0>);
  launch_bwd(kernel, grid, s, lv, r, lvl, g, rois_per_image, channels, pooled, sampling,
             tile_h);
  return (int)cudaGetLastError();
}
