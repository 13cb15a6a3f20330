// The per-pair attention on the tensor cores (sm_90a), shared by the
// encoder's backward passes and the pair-attention kernels:
//
//   encoder_layer_bwd.cu: B2b (encoder_att_backward) and B5
//     (encoder_mono_backward) recompute att and take dq, dk, dv for pass B;
//     B5 without the stash runs it in forward mode to recompute att;
//   pair_attention.cu: B4a (pair_attention_forward) runs it in forward mode,
//     B4b (pair_attention_backward) in backward mode without the att write.
//
// All of them hand it the layout it reads: a pair's rows of one packed
// (pairs t_pad, 3d) qkv, of a (pairs t_pad, d) datt, and the same for att
// and dqkv.  It replaces the attention inside the Pallas TPU kernels
// _att_bwd_kernel and _bwd_kernel (veto_tpu/ops/fused_encoder.py) and
// _attn_fwd_kernel and _attn_bwd_kernel (veto_tpu/ops/pair_attention.py).
// The mbarrier helpers come from the GEMM core's header.

#pragma once

#include "gemm_sm90.cuh"

// ----------------------------------------------------------------------------
// Attention backward on the tensor cores: one block per pair.
//
// Recomputes the scores and probabilities from the stashed qkv and writes
// the head outputs att and dq, dk, dv; with datt null it stops after att
// (the attention forward: B4a, and B5's recompute without the stash); with
// datt given and att null it writes dq, dk, dv only (B4b).
//
// The pair's qkv rows (t_pad x 3d bf16) and datt rows (t_pad x d) come into
// shared memory by bulk copies (cp.async.bulk, one a row, completing on one
// mbarrier), each row padded to an odd number of 16-byte units so that
// ldmatrix reads eight rows without bank conflicts.  Six warp pairs take a
// head each (heads beyond six loop).  Tokens are padded to 32 (two m16
// tiles) and the head dim to a multiple of 16: a fragment row past t_pad or
// past the head's columns is read from a 16-byte block of zeros.  Every
// product is mma.sync m16n8k16, bf16 operands and f32 sums, fed by ldmatrix:
//
//   phase 1, each warp of a pair 16 query rows: S = Q K^T, scaled, keys >=
//     t_valid masked; P = softmax(S) in registers (row max and sums by quad
//     shuffles), bf16(P) to a 32 x 32 tile; with datt also dP = dO V^T and
//     ds = P (dP - rowsum(dP P)), bf16(ds * scale) to a second tile;
//   phase 2, one 8-column slice c of the head at a time: warp 0 of the pair
//     att[:, c] = bf16(P) V[:, c] and dv[:, c] = bf16(P)^T dO[:, c], warp 1
//     dq[:, c] = dS K[:, c] and dk[:, c] = dS^T Q[:, c] (the transposed
//     operands by ldmatrix.trans).  Each result overwrites the slice it was
//     computed from (att over dO, dv over V, dq over Q, dk over K), which
//     nothing reads after phase 1 but that warp, so the staged rows become
//     the outputs in place; without datt both warps compute att, alternate
//     slices each, into the unused datt rows; with datt and no att, warp 0
//     skips att[:, c] and computes dv[:, c] alone;
//
// then bulk stores write the rows back: att (when given), and dqkv in qkv's
// layout.
// These are the TPU kernel's rounding points: f32 scores and softmax,
// att = bf16(bf16(P) V), dv = bf16(P)^T dO, dp = dO V^T, ds in f32,
// dq = bf16(ds scale) K, dk = bf16(ds scale)^T Q, each output rounded to
// bf16 once.  Masked keys have P = 0 exactly, so their dk and dv are 0;
// padded query rows are computed as the real ones, and their zero-filled
// fragment rows add nothing to dk and dv.  Every sum stays inside one
// (pair, head): no atomics, two runs give the same bits.
//
// Bound: bytes.  At 12,288 pairs x 19 tokens x 576 it reads qkv (807 MB)
// and datt (269 MB) and writes att (269 MB) and dqkv (807 MB), 2.15 GB,
// 0.64 ms at 3.35 TB/s, for 0.03 TFLOP (B4b, without the att write, 1.88
// GB and 0.56 ms; B4a at 16,384 pairs reads qkv and writes att, 1.43 GB
// and 0.43 ms).  At t_pad 19 a block takes 110 KB
// of shared memory, so two blocks share an SM: one computes while the
// other's copies are in flight.
// ----------------------------------------------------------------------------
constexpr int ATT_TMAX = 32;   // most tokens a pair: two m16 tiles
constexpr int ATT_SLOTS = 6;   // warp pairs a block, one head each
constexpr int ATT_THREADS = 64 * ATT_SLOTS;
constexpr int ATT_TILE = ATT_TMAX * ATT_TMAX * 2;  // a 32 x 32 bf16 tile
constexpr int ATT_HEAD = 128;  // the zero block and the mbarrier
constexpr int ATT_SMEM_MAX = 232448;  // 227 KB: the most a block may take

// bytes of a staged row of `cols` bf16: an odd number of 16-byte units
static __host__ __device__ inline int att_row_bytes(int cols) {
  return ((cols * 2 / 16) | 1) * 16;
}
static __host__ __device__ inline int att_smem_bytes(int t_pad, int d) {
  return ATT_HEAD + 2 * ATT_SLOTS * ATT_TILE +
         t_pad * (att_row_bytes(3 * d) + att_row_bytes(d));
}

// (row, 16-byte chunk) of a 32 x 32 bf16 tile: rows of 64 B, the chunks
// XOR-swizzled by row pairs so that ldmatrix's eight rows hit eight bank
// groups, whether it reads rows or columns of the tile
__device__ __forceinline__ uint32_t tile_off(int row, int chunk) {
  return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4);
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// d += a b: m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void st_bf16x2(uint32_t addr, float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
               "r"(*reinterpret_cast<uint32_t*>(&v))
               : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}
// the two warps of head slot `slot` (named barriers 1-6; 0 is __syncthreads)
__device__ __forceinline__ void pair_sync(int slot) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + slot) : "memory");
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// acc[j] (columns 8j..8j+7 of a 16 x 32 tile) = A B^T over the head's dh
// columns: A rows r0..r0+15 and B rows 0..31 of staged rows (start address
// of the head's first column, row stride); fragment rows past t_pad and
// columns past dh come from the zero block.
__device__ __forceinline__ void rows_times_rows(float (*acc)[4], uint32_t a,
                                                int as, uint32_t b, int bs,
                                                int r0, int t_pad, int dh,
                                                uint32_t zero, int lane) {
  const int li = lane >> 3, lr = lane & 7;  // ldmatrix: matrix li, its row lr
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int k0 = 0; k0 < dh; k0 += 16) {
    uint32_t fa[4];
    const int ar = r0 + lr + 8 * (li & 1), ac = k0 + 8 * (li >> 1);
    ldsm_x4(ar < t_pad && ac < dh ? a + ar * as + 2 * ac : zero, fa);
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      uint32_t fb[4];
      const int br = 8 * j + lr + 8 * (li >> 1), bc = k0 + 8 * (li & 1);
      ldsm_x4(br < t_pad && bc < dh ? b + br * bs + 2 * bc : zero, fb);
      mma16816(acc[j], fa, fb[0], fb[1]);
      mma16816(acc[j + 1], fa, fb[2], fb[3]);
    }
  }
}

__global__ void __launch_bounds__(ATT_THREADS, 2)
    attention_bwd_mma_kernel(const bf16* __restrict__ qkv,
                             const bf16* __restrict__ datt,
                             bf16* __restrict__ att, bf16* __restrict__ dqkv,
                             int t_pad, int t_valid, int d, int heads,
                             float scale) {
  extern __shared__ __align__(128) unsigned char att_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp >> 1, half = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;   // C fragment: rows g, g + 8; columns 2 t4, + 1
  const int li = lane >> 3, lr = lane & 7;  // ldmatrix: matrix li, its row lr
  const int dh = d / heads;
  const int lq = att_row_bytes(3 * d), ld = att_row_bytes(d);
  const bool bwd = datt != nullptr;
  const uint32_t base = smem_u32(att_smem);
  const uint32_t zero = base, bar = base + 16;
  const uint32_t tp = base + ATT_HEAD + slot * 2 * ATT_TILE;  // bf16(P)
  const uint32_t ts = tp + ATT_TILE;                          // bf16(ds scale)
  const uint32_t sq = base + ATT_HEAD + 2 * ATT_SLOTS * ATT_TILE;  // qkv rows
  const uint32_t sd = sq + t_pad * lq;  // datt rows, then att
  const size_t row0 = (size_t)blockIdx.x * t_pad;

  if (threadIdx.x < 4) reinterpret_cast<uint32_t*>(att_smem)[threadIdx.x] = 0u;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) mbar_expect_tx(bar, (uint32_t)(t_pad * (bwd ? 4 : 3) * d * 2));
    __syncwarp();
    for (int r = lane; r < t_pad; r += 32) {
      bulk_load(sq + r * lq, qkv + (row0 + r) * 3 * d, 6 * d, bar);
      if (bwd) bulk_load(sd + r * ld, datt + (row0 + r) * d, 2 * d, bar);
    }
  }
  mbar_wait(bar, 0);

  for (int h = slot; h < heads; h += ATT_SLOTS) {
    const int cq = 2 * h * dh;  // byte column of the head in a qkv or datt row
    const uint32_t q = sq + cq, k = q + 2 * d, v = q + 4 * d, go = sd + cq;
    const int r0 = 16 * half;
    // ---- phase 1: this warp's 16 query rows
    float s[4][4];
    rows_times_rows(s, q, lq, k, lq, r0, t_pad, dh, zero, lane);
#pragma unroll
    for (int e = 0; e < 2; ++e) {  // rows r0 + g + 8 e
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[j][2 * e + c];
          x = 8 * j + 2 * t4 + c < t_valid ? x * scale : -INFINITY;
          m = fmaxf(m, x);
        }
      m = quad_max(m);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[j][2 * e + c];
          x = expf(x - m);
          sum += x;
        }
      sum = quad_sum(sum);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j][2 * e] /= sum;
        s[j][2 * e + 1] /= sum;
        st_bf16x2(tp + tile_off(r0 + g + 8 * e, j) + 4 * t4, s[j][2 * e],
                  s[j][2 * e + 1]);
      }
    }
    if (bwd) {
      float dp[4][4];
      rows_times_rows(dp, go, ld, v, lq, r0, t_pad, dh, zero, lane);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float rd = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          rd += dp[j][2 * e] * s[j][2 * e] + dp[j][2 * e + 1] * s[j][2 * e + 1];
        rd = quad_sum(rd);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          st_bf16x2(ts + tile_off(r0 + g + 8 * e, j) + 4 * t4,
                    s[j][2 * e] * (dp[j][2 * e] - rd) * scale,
                    s[j][2 * e + 1] * (dp[j][2 * e + 1] - rd) * scale);
      }
    }
    pair_sync(slot);
    // ---- phase 2: x = A B[:, c] into X's slice c, y = A^T C[:, c] into Y's
    // (A, B -> X; A^T, C -> Y): warp 0 (P, V -> dO; P^T, dO -> V), warp 1
    // (dS, K -> Q; dS^T, Q -> K); without datt (P, V -> att rows) alone
    const uint32_t ta = (bwd && half) ? ts : tp;
    const uint32_t b = (bwd && half) ? k : v, xo = (bwd && half) ? q : go;
    const uint32_t cc = half ? q : go, yo = half ? k : v;  // yo: qkv rows
    const int xs = (bwd && half) ? lq : ld, cs = half ? lq : ld;
    const bool xw = !bwd || half || att != nullptr;  // this warp computes x
    uint32_t fa[2][2][4], ft[2][2][4];  // [m tile][k step]: A, and A^T
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        ldsm_x4(ta + tile_off(16 * mt + lr + 8 * (li & 1), 2 * ks + (li >> 1)),
                fa[mt][ks]);
        if (bwd)
          ldsm_x4_t(ta + tile_off(16 * ks + lr + 8 * (li >> 1), 2 * mt + (li & 1)),
                    ft[mt][ks]);
      }
    const int row = 8 * li + lr;  // the trans loads: rows 0..31 of a slice
    for (int c = bwd ? 0 : half; c < dh / 8; c += bwd ? 1 : 2) {
      uint32_t fb[4], fc[4];
      float x[2][4] = {}, y[2][4] = {};
      if (xw) {
        ldsm_x4_t(row < t_pad ? b + row * lq + 16 * c : zero, fb);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(x[mt], fa[mt][0], fb[0], fb[1]);
          mma16816(x[mt], fa[mt][1], fb[2], fb[3]);
        }
      }
      if (bwd) {
        ldsm_x4_t(row < t_pad ? cc + row * cs + 16 * c : zero, fc);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(y[mt], ft[mt][0], fc[0], fc[1]);
          mma16816(y[mt], ft[mt][1], fc[2], fc[3]);
        }
      }
      __syncwarp();  // the slice is read before this warp overwrites it
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 16 * mt + g + 8 * e;
          if (r >= t_pad) continue;
          if (xw)
            st_bf16x2(xo + r * xs + 16 * c + 4 * t4, x[mt][2 * e], x[mt][2 * e + 1]);
          if (bwd)
            st_bf16x2(yo + r * lq + 16 * c + 4 * t4, y[mt][2 * e], y[mt][2 * e + 1]);
        }
    }
    if (h + ATT_SLOTS < heads) pair_sync(slot);  // before the tiles are reused
  }

  // the staged rows are the outputs: write them back
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (warp == 0) {
    for (int r = lane; r < t_pad; r += 32) {
      if (att) bulk_store(att + (row0 + r) * d, sd + r * ld, 2 * d);
      if (bwd) bulk_store(dqkv + (row0 + r) * 3 * d, sq + r * lq, 6 * d);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// Whether the kernel takes pairs of t_pad tokens of width d in `heads`
// heads: t_pad up to ATT_TMAX, head dims in whole 8-column slices, a pair's
// rows within ATT_SMEM_MAX (the wrappers' Python mirrors refuse or route
// the rest before they get here).
static inline bool attention_takes(int t_pad, int d, int heads) {
  return t_pad >= 1 && t_pad <= ATT_TMAX && heads >= 1 && d % heads == 0 &&
         (d / heads) % 8 == 0 && att_smem_bytes(t_pad, d) <= ATT_SMEM_MAX;
}

// One block per pair.  datt null: the forward only (att, which must be
// given); datt given: dqkv, and att too unless it is null.  Every pointer
// 16-byte aligned (the bulk copies'); qkv and dqkv rows of 3d, datt and att
// rows of d bf16.
static inline int launch_attention(const bf16* qkv, const bf16* datt, bf16* att,
                                   bf16* dqkv, int pairs, int heads, int t_pad,
                                   int t_valid, int d, float scale,
                                   cudaStream_t s) {
  if (!attention_takes(t_pad, d, heads) || t_valid < 1 || t_valid > t_pad ||
      (datt == nullptr && att == nullptr) || (datt != nullptr && dqkv == nullptr))
    return (int)cudaErrorInvalidValue;
  // the mbarrier's tx count holds at most 2^20 - 1 bytes: a pair's qkv and
  // datt rows (ATT_SMEM_MAX keeps them far below it; held all the same)
  if ((long long)t_pad * 4 * d * 2 >= (1 << 20)) return (int)cudaErrorInvalidValue;
  const int smem = att_smem_bytes(t_pad, d);
  int err;
  if ((err = (int)cudaFuncSetAttribute(attention_bwd_mma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem)))
    return err;
  // all of the SM's shared memory for blocks: two of 110 KB at t_pad 19
  if ((err = (int)cudaFuncSetAttribute(attention_bwd_mma_kernel,
                                       cudaFuncAttributePreferredSharedMemoryCarveout,
                                       (int)cudaSharedmemCarveoutMaxShared)))
    return err;
  attention_bwd_mma_kernel<<<pairs, ATT_THREADS, smem, s>>>(
      qkv, datt, att, dqkv, t_pad, t_valid, d, heads, scale);
  return (int)cudaGetLastError();
}
