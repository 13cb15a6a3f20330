// Kernel N1: greedy NMS for Hopper (sm_90a), an IoU bitmask and a scan.
//
// Replaces the walk of veto_tpu/ops/nms.py (_greedy_keep_sorted_coords,
// :85-169): XLA code on the TPU, not a Pallas kernel, whose block fixpoint
// is a lax.while_loop and whose RPN call exits early by another.  Written
// as plain PyTorch on a card, every trip of those loops is a host
// synchronisation or a fixed worst-case trip count; here the whole walk
// stays on the card.  The algorithm is the reference's own
// (pysgg/csrc/cuda/nms.cu), with the scan kept on the device.
//
// Each call solves G independent problems of N boxes, sorted by descending
// score (the sort stays in PyTorch): the RPN's (image, level) walks at
// N = 6000, or the box head's (image, class) walks at N = 1000.
//
// nms_mask_kernel: bit j of row i (word j / 64) is set when j > i and
// IoU(i, j) > t.  A block of 64 threads takes one 64 x 64 tile of one
// problem: it stages the tile's 64 column boxes and their areas in shared
// memory, and thread r compares row box r with them.  Tiles below the
// diagonal are never read by the scan and are not written.  Bound: the
// IoU arithmetic (~14 f32 operations a pair, N^2 / 2 pairs a problem),
// and the table's bytes (N^2 / 8 a problem).
//
// nms_scan_kernel: one warp a problem.  Its `removed` words start as the
// inactive rows (and the bits past N); the warp walks the words in order,
// and within a word takes the lowest row not removed: that row is kept,
// and every lane ORs its share of the row's mask words (from the row's
// own word on) into `removed`.  Removed rows cost nothing, so the walk is
// as long as its keeps, and it stops at max_outputs keeps (the later
// keeps are cut anyway, nms.py:169).  Bound: the kept rows, one after
// another, each a dependent read of its mask row.
//
// Exactness.  The keep set is the plain walk's and the JAX package's bit
// for bit: the IoU is inter / (area_i + area_j - inter), iw = min(x2) -
// max(x1) + 1 clipped at 0, likewise ih, areas (x2 - x1 + 1)(y2 - y1 + 1),
// every operation rounded on its own (__fadd_rn, __fsub_rn, __fmul_rn,
// __fdiv_rn: no contraction into an FMA, which would round once where XLA
// and PyTorch round twice), symmetric in i and j.  The threshold is the
// f32 the caller compares with, and the comparison strict.  Inactive rows
// are never kept, so they suppress nothing.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;        // boxes a side of a mask tile
constexpr int SCAN_WARPS = 4;   // problems a scan block walks
constexpr unsigned FULL = 0xffffffffu;
typedef unsigned long long u64;

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

__device__ __forceinline__ float iou_of(float4 a, float area_a, float4 b,
                                        float area_b) {
  const float iw = __fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.0f);
  const float ih = __fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.0f);
  const float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  return __fdiv_rn(inter, __fsub_rn(__fadd_rn(area_a, area_b), inter));
}

// grid (words, words, G), 64 threads
__global__ void __launch_bounds__(TILE) nms_mask_kernel(
    const float4* __restrict__ boxes, int n, int words, float thr,
    u64* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y;
  if (cb < rb) return;  // below the diagonal: never read
  const size_t g = blockIdx.z;
  const float4* bx = boxes + g * n;
  __shared__ float4 col_box[TILE];
  __shared__ float col_area[TILE];
  const int col0 = cb * TILE;
  const int ncols = min(TILE, n - col0);
  if ((int)threadIdx.x < ncols) {
    const float4 b = bx[col0 + threadIdx.x];
    col_box[threadIdx.x] = b;
    col_area[threadIdx.x] = area_of(b);
  }
  __syncthreads();
  const int i = rb * TILE + threadIdx.x;
  if (i >= n) return;
  const float4 a = bx[i];
  const float area_a = area_of(a);
  u64 bits = 0;
  for (int j = cb == rb ? threadIdx.x + 1 : 0; j < ncols; ++j) {
    if (iou_of(a, area_a, col_box[j], col_area[j]) > thr) bits |= 1ull << j;
  }
  mask[(g * n + i) * words + cb] = bits;
}

// SCAN_WARPS warps a block, one problem each; dynamic shared memory holds
// each warp's `removed` and `kept` words
__global__ void __launch_bounds__(SCAN_WARPS * 32) nms_scan_kernel(
    const u64* __restrict__ mask, const unsigned char* __restrict__ active,
    int problems, int n, int words, int max_outputs,
    unsigned char* __restrict__ keep) {
  extern __shared__ u64 smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.x * SCAN_WARPS + warp;
  if (g >= problems) return;  // the whole warp
  u64* removed = smem + (size_t)warp * 2 * words;
  u64* kept = removed + words;
  const unsigned char* act = active + (size_t)g * n;
  for (int w = 0; w < words; ++w) {
    const int lo = w * TILE + lane, hi = lo + 32;
    const unsigned off_lo = __ballot_sync(FULL, !(lo < n && act[lo]));
    const unsigned off_hi = __ballot_sync(FULL, !(hi < n && act[hi]));
    if (lane == 0) {
      removed[w] = (u64)off_lo | ((u64)off_hi << 32);
      kept[w] = 0;
    }
  }
  __syncwarp();
  const u64* rows = mask + (size_t)g * n * words;
  int count = 0;
  for (int w = 0; w < words && count < max_outputs; ++w) {
    u64 cur = removed[w];  // every lane reads the same word
    while (cur != ~0ull && count < max_outputs) {
      const int b = __ffsll((long long)~cur) - 1;
      const u64* row = rows + (size_t)(w * TILE + b) * words;
      for (int v = w + lane; v < words; v += 32) removed[v] |= row[v];
      if (lane == 0) kept[w] |= 1ull << b;
      ++count;
      __syncwarp();
      cur = removed[w] | ((2ull << b) - 1);  // bits up to b are done
    }
  }
  __syncwarp();
  unsigned char* out = keep + (size_t)g * n;
  for (int i = lane; i < n; i += 32) out[i] = (kept[i / TILE] >> (i % TILE)) & 1;
}

}  // namespace

extern "C" const char* veto_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int nms_scan_smem_bytes(int n) {
  return SCAN_WARPS * 2 * ((n + TILE - 1) / TILE) * (int)sizeof(u64);
}

// boxes: (G, N, 4) f32 sorted by descending score; mask: (G, N, words) u64.
// Returns cudaGetLastError() after the launch.
extern "C" int nms_mask(const void* boxes, int problems, int n, float thr,
                        void* mask, void* stream) {
  const int words = (n + TILE - 1) / TILE;
  const dim3 grid(words, words, problems);
  nms_mask_kernel<<<grid, TILE, 0, (cudaStream_t)stream>>>(
      (const float4*)boxes, n, words, thr, (u64*)mask);
  return (int)cudaGetLastError();
}

// active: (G, N) bool; keep: (G, N) bool, written whole.
extern "C" int nms_scan(const void* mask, const void* active, int problems,
                        int n, int max_outputs, void* keep, void* stream) {
  const int words = (n + TILE - 1) / TILE;
  const int blocks = (problems + SCAN_WARPS - 1) / SCAN_WARPS;
  nms_scan_kernel<<<blocks, SCAN_WARPS * 32, nms_scan_smem_bytes(n),
                    (cudaStream_t)stream>>>(
      (const u64*)mask, (const unsigned char*)active, problems, n, words,
      max_outputs, (unsigned char*)keep);
  return (int)cudaGetLastError();
}
