// The GEMM core of the fused encoder kernels on Hopper (sm_90a):
//
//   C[M, N] = epilogue(A[M, K] B[K, N]),  bf16 operands, f32 accumulators.
//
// It carries every matrix product of encoder_layer.cu (B1: qkv, the
// out-projection with bias and residual, FFN1 with bias and GELU, FFN2 with
// bias and residual) and encoder_layer_bwd.cu (B2a, B2b, B5: the
// input-gradient products, the split-K weight gradients, and B2a's dual
// product f1 = h2 W1 + b1 beside dg = dy W2^T).  These are the products
// that the Pallas TPU kernels of veto_tpu/ops/fused_encoder.py
// (_fwd_kernel, _ffn_bwd_kernel, _att_bwd_kernel, _bwd_kernel) run on the
// MXU.
//
// Bound: operations.  At the PredCls shapes (K = 576, 1152 or 1728; N = 576,
// 1152 or 1728; M = 233,472 or 311,296 rows) each product does 2 M N K / (2
// (M K + K N + M N)) >= 190 FLOP a byte, so 989 TFLOP/s of bf16 tensor
// cores, not 3.35 TB/s of HBM, is the floor: FFN1 at 311,296 rows (0.41
// TFLOP) takes at least 0.42 ms.
//
// Design, to approach that rate:
// - wgmma.mma_async (m64nNk16) is the only instruction that reaches it.
//   Two consumer warpgroups each own 64 rows of a 128 x BN block tile and
//   keep their 64 x BN f32 accumulator in registers (BN = 192: 96 a thread;
//   the dual product, two accumulators at BN = 128: 128 a thread).  192
//   divides every N of the encoder (576, 1152, 1728), 128 divides F = 1152.
// - TMA (cp.async.bulk.tensor) brings 64-deep k-tiles of A and B into a
//   ring of 3 or 4 stages in dynamic shared memory, with the 128-byte
//   swizzle that wgmma reads without bank conflicts.  A
//   full/empty mbarrier pair guards each stage: one producer thread waits
//   for a free stage, announces its bytes and issues the loads; the
//   consumers wait for the bytes, issue the stage's wgmmas and free the
//   stage once the next stage's wgmmas are in flight.  No __syncthreads in
//   the main loop.
// - The producer and storing warpgroup gives up registers (setmaxnreg 72)
//   and the consumers take them (216), in one if/else on the warpgroup
//   index.
// - Persistent: one block an SM walks over its output tiles.  The producer
//   runs ahead into the next tile's k-tiles while the consumers finish this
//   one, so the ring does not drain between tiles and no block pays for
//   its launch, its barrier set-up or the first loads' latency more than
//   once.
// - Both majors of each operand are read as they lie, with no transposing
//   copy: a K-major operand (K contiguous, e.g. activations, or W2 read as
//   W2^T) is one TMA box of 64 (K) x rows; an MN-major operand (M or N
//   contiguous, e.g. W (in, out) in x W, or h2 in h2^T df1) is boxes of 64
//   (MN) x 64 (K), and wgmma reads it with its transpose bit set.
// - Ragged edges: TMA fills loads past M, N or K with zeros; the
//   epilogues mask their stores.  The weight gradients' M = 576 leaves the
//   last 128-row tile half empty (its second 64-row box lies wholly past M
//   and is zero-filled): 1 tile in 9 does half-useful work, which is
//   cheaper in code than a 192-row tile of three consumer warpgroups.
// - Epilogues: the consumers apply bias, GELU or the residual (loaded at
//   the tile's start, so its latency hides behind the products) to their
//   accumulators in registers, at the rounding points of the TPU kernels,
//   park the results (f32, or rounded to bf16) in a staged tile in shared
//   memory and go on to the next tile at once; three storing warps write
//   the tile with coalesced 16-byte stores while the tensor cores run.  (The
//   dual product's epilogue, whose two f32 tiles would not fit beside its
//   ring, stores from the consumers' registers.)
//
// Tensor maps are encoded on the host, for every launch, by libcuda's
// cuTensorMapEncodeTiled, whose address the CUDA runtime hands out at run
// time (cudaGetDriverEntryPoint, or its ByVersion form from CUDA 12.5; no
// -lcuda: the libraries are plain C interfaces loaded with ctypes), and
// passed as __grid_constant__ kernel parameters.  Global strides are
// multiples of 16 bytes because the callers take D and F multiples of 64,
// and base pointers are 16-byte aligned (the Python wrappers check both).
//
// No atomics: split-K partials and column sums are written per block and
// summed in a fixed order by the callers' reduction kernels, so two runs
// give bit-equal results.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// ----------------------------------------------------------------------------
// arithmetic shared by the epilogues and the encoder kernels
// ----------------------------------------------------------------------------
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 1 / x for finite x >= 1: the hardware estimate refined by one Newton step.
// Within an ulp of the IEEE quotient, and without its branch to a slow path
// for special operands, which x >= 1 never is (the branch kept the
// compiler from interleaving an epilogue's independent GELUs).
__device__ __forceinline__ float rcp_ge1(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.f), r);
}

// Abramowitz-Stegun 7.1.26 rational erf, the TPU kernel's _erf.
__device__ __forceinline__ float erf_rational(float x) {
  const float sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = rcp_ge1(1.f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return sign * (1.f - poly * expf(-ax * ax));
}

__device__ __forceinline__ float gelu_exact(float z) {
  return 0.5f * z * (1.f + erf_rational(z * 0.7071067811865476f));
}

// (gelu z, d gelu / dz = Phi(z) + z phi(z)) with one rational erf: the
// same arithmetic as gelu_exact and the plain version's _gelu_grad
__device__ __forceinline__ float2 gelu_and_grad(float z) {
  const float e = erf_rational(z * 0.7071067811865476f);
  const float phi = expf(-0.5f * z * z) * 0.3989422804014327f;
  const float cdf = 0.5f * (1.f + e);
  return make_float2(0.5f * z * (1.f + e), cdf + z * phi);
}

// ----------------------------------------------------------------------------
// tiles and epilogues
// ----------------------------------------------------------------------------
constexpr int GEMM_BM = 128, GEMM_BK = 64, GEMM_THREADS = 384;
constexpr int GEMM_BN = 192;       // single products
constexpr int GEMM_BN_DUAL = 128;  // the dual product: two accumulators

enum {
  EPI_F32 = 0,            // out_f32 = acc
  EPI_BF16 = 1,           // out_bf16 = bf16(acc)
  EPI_BIAS_GELU = 2,      // out_bf16 = bf16(gelu(acc + bias)), f32 to the GELU
  EPI_BIAS_RESID = 3,     // out_bf16 = bf16(resid + bf16(acc + bias))
  EPI_SPLITK = 4,         // out_f32[z] = acc, the partial of split z
  EPI_DUAL_GELU_BWD = 5,  // acc = A B (f1 without b1), acc2 = A2 B2 (dg):
                          // f1 = acc + bias stays f32;
                          // out_bf16 = bf16(gelu f1) (g),
                          // out2_bf16 = bf16(dg gelu'(f1)) (df1),
                          // colsum[m tile][n] = the tile's column sums
                          // of the f32 df1
};

struct Epi {
  const float* bias;   // (N,)
  const bf16* resid;   // (M, N)
  float* out_f32;      // (M, N), or (splits, M, N) for EPI_SPLITK
  bf16* out_bf16;      // (M, N)
  bf16* out2_bf16;     // (M, N)
  float* colsum;       // (M tiles, N)
};

// ----------------------------------------------------------------------------
// PTX: mbarriers, TMA, wgmma
// ----------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// Returns once the phase of parity `parity` has completed.  A pipeline
// that waits 5 s traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t spins = 0;
  uint64_t t0 = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && (++spins & 0xFFFFu) == 0) {
      const uint64_t t = globaltimer_ns();
      if (t0 == 0) t0 = t;
      else if (t - t0 > 5000000000ull) __trap();
    }
  } while (!done);
}
// 2-D box at (c0 innermost, c1) into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from touching accumulator registers across the
// asynchronous wgmmas that write them.
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// The descriptor of the kk-th 16-deep slice of an operand tile.  K-major:
// rows of 64 K values (128 B), 8-row groups 1024 B apart; the slice starts
// kk * 32 B into each row (the swizzle is applied to the address).
// MN-major: boxes of 64 K rows x 64 MN values; 8-row K groups 1024 B
// apart (SBO), 64-wide MN blocks one box (8192 B) apart (LBO); the slice
// starts kk * 16 rows down.
template <bool MN>
__device__ __forceinline__ uint64_t tile_desc(uint32_t tile, int kk) {
  return MN ? smem_desc(tile + kk * 2048, 8192, 1024)
            : smem_desc(tile + kk * 32, 16, 1024);
}

// wgmma m64nNk16, bf16 x bf16 -> f32, both operands from shared memory;
// TA / TB: 1 reads that operand MN-major (the instruction's transpose bit).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n192(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int BN, bool TA, bool TB>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da, uint64_t db) {
  static_assert(BN == 128 || BN == 192, "wgmma width");
  if constexpr (BN == 128)
    wgmma_m64n128<TA, TB>(d, da, db);
  else
    wgmma_m64n192<TA, TB>(d, da, db);
}

// One operand's k-tile: `ext` rows of the M or N dimension from mn0, 64 of
// K from k0.  K-major: one box (c0 = k, c1 = mn); MN-major: ext / 64 boxes
// (c0 = mn, c1 = k), 8192 B apart.
template <bool MN, int EXT>
__device__ __forceinline__ void load_operand(const CUtensorMap* map, uint32_t dst,
                                             uint32_t bar, int mn0, int k0) {
  if constexpr (MN) {
#pragma unroll
    for (int i = 0; i < EXT / 64; ++i) tma_load(map, dst + i * 8192, bar, mn0 + 64 * i, k0);
  } else {
    tma_load(map, dst, bar, k0, mn0);
  }
}

template <int BN, int EPI>
struct GemmShape {
  static constexpr bool DUAL = EPI == EPI_DUAL_GELU_BWD;
  // f32 results are staged in f32, all others as their bf16 rounding
  static constexpr bool F32_OUT = EPI == EPI_F32 || EPI == EPI_SPLITK;
  static constexpr int STAGES = DUAL || F32_OUT ? 3 : 4;
  static constexpr uint32_t A_BYTES = GEMM_BM * GEMM_BK * 2;
  static constexpr uint32_t B_BYTES = BN * GEMM_BK * 2;
  static constexpr uint32_t STAGE_BYTES = (DUAL ? 2 : 1) * (A_BYTES + B_BYTES);
  // the staged tile's row stride in elements: +8 keeps a warp's fragment
  // stores conflict-free (bf16) or at two wavefronts (f32)
  static constexpr int SP = BN + 8;
  static constexpr int STAGING = DUAL ? 0 : GEMM_BM * SP * (F32_OUT ? 4 : 2);
  // ring, 1 KB of slack to align it to the swizzle's 1024 B, the staged
  // tile, the barriers, and the dual epilogue's [8 warps][BN] column sums
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + STAGING +
                              2 * STAGES * 8 + (DUAL ? 8 * BN * 4 : 0);
};

// Named barriers (0 is __syncthreads): the consumers among themselves, and
// the staged tile's hand-over between the consumers and the storing warps
enum { BAR_CONSUMERS = 1, BAR_STAGED = 2, BAR_FREE = 3 };
constexpr int STORE_THREADS = 96;  // warps 9-11
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The storing warps' part of the epilogue: one staged (128 x BN) tile of
// finished values, f32 (EPI_F32, EPI_SPLITK) or already rounded to bf16,
// written with coalesced 16-byte stores (4 f32 or 8 bf16 a thread, a
// warp's threads along a row).
template <int BN, int EPI>
__device__ __forceinline__ void store_tile(const uint8_t* stg, const Epi& epi,
                                           int M, int N, int m0, int n0, int z,
                                           int et) {
  using S = GemmShape<BN, EPI>;
  constexpr int W = S::F32_OUT ? 4 : 8;  // elements a 16-byte chunk
  constexpr int CW = BN / W;             // chunks a row
  constexpr int ES = S::F32_OUT ? 4 : 2; // bytes an element
#pragma unroll 4
  for (int i = et; i < GEMM_BM * CW; i += STORE_THREADS) {
    const int rl = i / CW, cl = (i % CW) * W;
    const int r = m0 + rl, c = n0 + cl;
    if (r >= M || c >= N) continue;
    const uint4 x = *reinterpret_cast<const uint4*>(stg + (rl * S::SP + cl) * ES);
    const size_t o = (size_t)r * N + c;
    if constexpr (EPI == EPI_SPLITK)
      *reinterpret_cast<uint4*>(epi.out_f32 + (size_t)z * M * N + o) = x;
    else if constexpr (EPI == EPI_F32)
      *reinterpret_cast<uint4*>(epi.out_f32 + o) = x;
    else
      *reinterpret_cast<uint4*>(epi.out_bf16 + o) = x;
  }
}

// Persistent: block b takes output tiles b, b + gridDim.x, ... of the
// (split, M tile, N tile) grid, N tiles fastest (consecutive blocks share
// their A rows through L2).  Split z covers K in [z k_chunk, (z + 1)
// k_chunk).  Roles:
// - warpgroups 0 and 1 consume: rows 64 wg .. 64 wg + 63 of the tile, the
//   wgmmas of each k-tile; then the epilogue's arithmetic in registers,
//   after which they park the results in the staged tile and go on to the
//   next tile's k-tiles at once (the dual epilogue, which would need two
//   staged tiles, stores from their registers);
// - warp 8, one thread, produces: the TMA loads, running ahead into the
//   next tile while the consumers finish this one;
// - warps 9-11 store: the staged tile's global stores, while the tensor
//   cores run the next tile.
template <int BN, bool A_MN, bool B_MN, bool B2_MN, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap ta2,
                     const __grid_constant__ CUtensorMap tb2, int M, int N,
                     int K, int splits, int k_chunk, Epi epi) {
  constexpr bool DUAL = EPI == EPI_DUAL_GELU_BWD;
  using S = GemmShape<BN, EPI>;
  constexpr int HANDOVER = 256 + STORE_THREADS;  // threads of BAR_STAGED/FREE
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* staging = smem_raw + (ring - raw) + S::STAGES * S::STAGE_BYTES;
  uint8_t* after = staging + S::STAGING;
  const uint32_t full = smem_u32(after);           // STAGES barriers
  const uint32_t empty = full + 8 * S::STAGES;     // STAGES barriers
  float* red = reinterpret_cast<float*>(after + 16 * S::STAGES);

  const int n_tiles = (N + BN - 1) / BN;
  const int m_tiles = (M + GEMM_BM - 1) / GEMM_BM;
  const int tiles = n_tiles * m_tiles * splits;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    if (threadIdx.x == 256) {
      // -------------------------------------------------------- producer
      int it = 0;  // k-tiles issued so far: the ring position
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % n_tiles) * BN;
        const int m0 = (tile / n_tiles % m_tiles) * GEMM_BM;
        const int k_begin = tile / (n_tiles * m_tiles) * k_chunk;
        const int k_end = min(K, k_begin + k_chunk);
        for (int k = k_begin; k < k_end; k += GEMM_BK, ++it) {
          const int s = it % S::STAGES;
          if (it >= S::STAGES) mbar_wait(empty + 8 * s, ((it / S::STAGES) - 1) & 1);
          const uint32_t bar = full + 8 * s;
          const uint32_t st = ring + s * S::STAGE_BYTES;
          mbar_expect_tx(bar, S::STAGE_BYTES);
          load_operand<A_MN, GEMM_BM>(&ta, st, bar, m0, k);
          load_operand<B_MN, BN>(&tb, st + S::A_BYTES, bar, n0, k);
          if constexpr (DUAL) {
            load_operand<A_MN, GEMM_BM>(&ta2, st + S::A_BYTES + S::B_BYTES, bar, m0, k);
            load_operand<B2_MN, BN>(&tb2, st + 2 * S::A_BYTES + S::B_BYTES, bar, n0, k);
          }
        }
      }
    } else if (!DUAL && threadIdx.x >= 256 + 32) {
      // ---------------------------------------------------- storing warps
      const int et = threadIdx.x - (256 + 32);
      named_arrive(BAR_FREE, HANDOVER);  // the staged tile starts free
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % n_tiles) * BN;
        const int m0 = (tile / n_tiles % m_tiles) * GEMM_BM;
        const int z = tile / (n_tiles * m_tiles);
        named_sync(BAR_STAGED, HANDOVER);
        store_tile<BN, EPI>(staging, epi, M, N, m0, n0, z, et);
        if (tile + (int)gridDim.x < tiles) named_arrive(BAR_FREE, HANDOVER);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
    constexpr int NACC = BN / 2;
    float acc[NACC];
    float acc2[DUAL ? NACC : 1];
    // fragment: thread (warp w, lane l) of the warpgroup holds, for each
    // 8-column group j, columns 8 j + 2 (l % 4) + {0, 1} of rows
    // 16 w + l / 4 (acc[4 j], acc[4 j + 1]) and 8 rows below (+2, +3)
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int cq = (lane & 3) * 2;
    const int rl0 = wg * 64 + warp * 16 + (lane >> 2);  // row in the tile
    int it = 0;  // k-tiles consumed so far: the ring position
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % n_tiles) * BN;
      const int mt = tile / n_tiles % m_tiles;
      const int m0 = mt * GEMM_BM;
      const int k_begin = tile / (n_tiles * m_tiles) * k_chunk;
      const int k_end = min(K, k_begin + k_chunk);
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < (DUAL ? NACC : 1); ++i) acc2[i] = 0.f;
      // the residual's bf16 pairs, loaded now so that their latency hides
      // behind this tile's products
      uint32_t rv[EPI == EPI_BIAS_RESID ? BN / 4 : 1];
      if constexpr (EPI == EPI_BIAS_RESID) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = m0 + rl0 + 8 * h, c = n0 + j * 8 + cq;
            rv[2 * j + h] = r < M && c < N
                ? __ldg(reinterpret_cast<const unsigned int*>(epi.resid + (size_t)r * N + c))
                : 0u;
          }
      }

      for (int k = k_begin; k < k_end; k += GEMM_BK, ++it) {
        const int s = it % S::STAGES;
        mbar_wait(full + 8 * s, (it / S::STAGES) & 1);
        const uint32_t st = ring + s * S::STAGE_BYTES;
        fence_acc<NACC>(acc);
        if constexpr (DUAL) fence_acc<NACC>(acc2);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GEMM_BK / 16; ++kk) {
          wgmma_tile<BN, A_MN, B_MN>(acc, tile_desc<A_MN>(st + wg * 8192, kk),
                                     tile_desc<B_MN>(st + S::A_BYTES, kk));
          if constexpr (DUAL)
            wgmma_tile<BN, A_MN, B2_MN>(
                acc2, tile_desc<A_MN>(st + S::A_BYTES + S::B_BYTES + wg * 8192, kk),
                tile_desc<B2_MN>(st + 2 * S::A_BYTES + S::B_BYTES, kk));
        }
        wgmma_commit();
        // the previous stage's wgmmas are done: hand its buffers back
        wgmma_wait<1>();
        fence_acc<NACC>(acc);
        if constexpr (DUAL) fence_acc<NACC>(acc2);
        if (k > k_begin) mbar_arrive(empty + 8 * ((it - 1) % S::STAGES));
      }
      wgmma_wait<0>();
      fence_acc<NACC>(acc);
      if constexpr (DUAL) fence_acc<NACC>(acc2);
      if (k_end > k_begin) mbar_arrive(empty + 8 * ((it - 1) % S::STAGES));

      if constexpr (!DUAL) {
        // finish the values in registers (bias, GELU, residual), then park
        // them for the storing warps
        if constexpr (EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_RESID) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int c = n0 + j * 8 + cq;
            const float2 b = c < N ? __ldg(reinterpret_cast<const float2*>(epi.bias + c))
                                   : make_float2(0.f, 0.f);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float& v0 = acc[4 * j + 2 * h];
              float& v1 = acc[4 * j + 2 * h + 1];
              if constexpr (EPI == EPI_BIAS_GELU) {
                v0 = gelu_exact(v0 + b.x);
                v1 = gelu_exact(v1 + b.y);
              } else {
                const uint32_t u = rv[2 * j + h];
                const float2 res =
                    __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
                v0 = res.x + round_bf16(v0 + b.x);
                v1 = res.y + round_bf16(v1 + b.y);
              }
            }
          }
        }
        named_sync(BAR_FREE, HANDOVER);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = (rl0 + 8 * h) * S::SP + j * 8 + cq;
            const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
            if constexpr (S::F32_OUT)
              *reinterpret_cast<float2*>(staging + 4 * e) = make_float2(v0, v1);
            else
              *reinterpret_cast<__nv_bfloat162*>(staging + 2 * e) =
                  __floats2bfloat162_rn(v0, v1);
          }
        named_arrive(BAR_STAGED, HANDOVER);
      } else {
        // ------------------------------------------- the dual epilogue
        const int row0 = m0 + rl0;
        // the previous tile's column sums have been read
        named_sync(BAR_CONSUMERS, 256);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = n0 + j * 8 + cq;
          const bool cok = c < N;
          const float2 b = cok ? *reinterpret_cast<const float2*>(epi.bias + c)
                               : make_float2(0.f, 0.f);
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row0 + 8 * h;
            if (!cok || r >= M) continue;
            const size_t o = (size_t)r * N + c;
            const float2 g0 = gelu_and_grad(acc[4 * j + 2 * h] + b.x);
            const float2 g1 = gelu_and_grad(acc[4 * j + 2 * h + 1] + b.y);
            *reinterpret_cast<__nv_bfloat162*>(epi.out_bf16 + o) =
                __floats2bfloat162_rn(g0.x, g1.x);
            const float d0 = acc2[4 * j + 2 * h] * g0.y;
            const float d1 = acc2[4 * j + 2 * h + 1] * g1.y;
            *reinterpret_cast<__nv_bfloat162*>(epi.out2_bf16 + o) =
                __floats2bfloat162_rn(d0, d1);
            s0 += d0;
            s1 += d1;
          }
          // sum over the warp's 16 rows (the lanes with equal l % 4), then
          // park the warp's sums for the fixed-order sum over the 8 warps
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, o);
            s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          }
          if (lane < 4) {
            float* w = red + (wg * 4 + warp) * BN + j * 8 + cq;
            w[0] = s0;
            w[1] = s1;
          }
        }
        named_sync(BAR_CONSUMERS, 256);
        const int c = threadIdx.x;
        if (c < BN && n0 + c < N) {
          float t = 0.f;
#pragma unroll
          for (int w = 0; w < 8; ++w) t += red[w * BN + c];
          epi.colsum[(size_t)mt * N + n0 + c] = t;
        }
      }
    }
  }
}

// ----------------------------------------------------------------------------
// host side
// ----------------------------------------------------------------------------
static int num_sms() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// Tensor map of a bf16 operand stored row-major.  K-major: (mn, k) with k
// contiguous, box 64 (k) x tile_mn; MN-major: (k, mn) with mn contiguous,
// box 64 (mn) x 64 (k).  128-byte swizzle; loads past the edges read zeros.
template <bool MN>
static int operand_map(CUtensorMap* map, const bf16* ptr, int mn, int k,
                       int tile_mn) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)(MN ? mn : k), (cuuint64_t)(MN ? k : mn)};
  const cuuint64_t strides[1] = {dims[0] * sizeof(bf16)};
  const cuuint32_t box[2] = {64u, (cuuint32_t)(MN ? 64 : tile_mn)};
  const cuuint32_t elem[2] = {1u, 1u};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)ptr, dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// C = epilogue(A B), with A2 B2 beside it for the dual epilogue; K split
// into `splits` ranges of k_chunk (a multiple of 64).  Returns
// cudaGetLastError() after the launch (0 on success).
template <int BN, bool A_MN, bool B_MN, bool B2_MN, int EPI>
static int gemm_launch(const bf16* A, const bf16* B, const bf16* A2,
                       const bf16* B2, int M, int N, int K, int splits,
                       int k_chunk, const Epi& epi, cudaStream_t s) {
  constexpr bool DUAL = EPI == EPI_DUAL_GELU_BWD;
  CUtensorMap ta, tb, ta2, tb2;
  int err;
  if ((err = operand_map<A_MN>(&ta, A, M, K, GEMM_BM))) return err;
  if ((err = operand_map<B_MN>(&tb, B, N, K, BN))) return err;
  ta2 = ta;
  tb2 = tb;
  if (DUAL) {
    if ((err = operand_map<A_MN>(&ta2, A2, M, K, GEMM_BM))) return err;
    if ((err = operand_map<B2_MN>(&tb2, B2, N, K, BN))) return err;
  }
  auto kern = gemm_sm90_kernel<BN, A_MN, B_MN, B2_MN, EPI>;
  const int smem = GemmShape<BN, EPI>::SMEM;
  if ((err = (int)cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return err;
  const int tiles = ((N + BN - 1) / BN) * ((M + GEMM_BM - 1) / GEMM_BM) * splits;
  const int grid = tiles < num_sms() ? tiles : num_sms();
  kern<<<grid, GEMM_THREADS, smem, s>>>(ta, tb, ta2, tb2, M, N, K, splits, k_chunk,
                                        epi);
  return (int)cudaGetLastError();
}

// C[M, N] = epilogue(A B), A (M, K) row-major (K-major); B (K, N) row-major
// (MN-major, a weight (in, out) in x W) or, with B_KMAJOR, (N, K) row-major
// (a weight read transposed, dy W^T).
template <int EPI, bool B_KMAJOR = false>
static int gemm(const bf16* A, const bf16* B, int M, int N, int K,
                const Epi& epi, cudaStream_t s) {
  return gemm_launch<GEMM_BN, false, !B_KMAJOR, !B_KMAJOR, EPI>(
      A, B, nullptr, nullptr, M, N, K, 1, K, epi, s);
}
