// Grouped expert matmul (E, C, d) x (E, d, f) -> (E, C, f), f32 accumulation.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/moe_gemm/moe_gemm.py :: moe_gemm_pallas (_kernel)
//
// x (E,C,d) and w (E,d,f), both bf16 or both f32, contiguous; output (E,C,f)
// in x's dtype, every product summed in f32 and rounded once.  No
// dimension need divide a tile: the ragged edges of C, d and f are masked
// (loads past an edge read 0, stores past it are dropped), so the decode
// shape's 8 rows and d_ff 1,408 (5.5 x 256) run as they are.  The Pallas
// kernel computes every expert's whole (C, f) tile, though its docstring
// (moe_gemm.py:12-15) names the skipping of empty blocks as its intent.
// The mma body (decode and serve) skips them: a block whose rows of x are
// all zero reads no weights and writes +0, which is what the dense product
// gives there for finite weights (every term is +-0 and an f32 sum of +-0
// from +0 is +0), so the output equals the dense product exactly.  The
// precondition is finite weights: with an inf or NaN in a skipped expert's
// weights the dense product gives NaN where this gives 0.  A decode step's
// 4 rows x top-6 touch at most 24 of Moonlight's 64 experts, so most of
// the 369 MB of weights per product is never read.

// The Pallas grid (E, C/bc, f/bf, d/bd) accumulates over its innermost,
// sequential d axis in VMEM scratch.  Here a block loops over d itself,
// the sums in registers.  Three bodies; ops.kernel_path(e, c, d, f, dtype,
// aligned) picks one and passes it here:
//  * "wgmma", bf16 with d and f multiples of 8, 16-byte aligned tensors and
//    at least ops.WGMMA_MIN_ROWS rows (the prefill): Hopper's warpgroup
//    products on a ring of tiles that TMA brings into shared memory.  A
//    block of 384 threads has one producer warp, whose one thread issues
//    the TMA copies into 4 slots of 48 KB (64 deep: x's 256 rows and w's
//    128 columns), each with a "full" and an "empty" mbarrier, and two
//    consumer warpgroups, each running wgmma.m64n128k16 on a 128 x 128
//    output tile (two m64 halves) of the block's 256 x 128.  Each consumer
//    keeps one slice's products in flight while it issues the next.  x
//    (E,C,d) is the K-major A operand (128-byte swizzle); w (E,d,f) is read
//    MN-major through wgmma's transpose bit (LBO = one 64-column box, SBO =
//    1,024 bytes), so no transposed copy of the weights is made.  The
//    tensor maps are rank 3 over (inner dim, rows, E): rows past C and
//    depth past d read zeros from inside their own expert, never the next
//    expert's rows.  A half whose 64 rows all lie past C issues no products
//    (C = 960 is 3.75 tiles).  The kernel is persistent: one block per SM
//    walks the (expert, m tile, n tile) items, and the ring runs on across
//    items, so one tile's epilogue overlaps the next tile's loads.  Each
//    m64 half of the output goes out through a 16 KB staging tile per
//    consumer and TMA stores, which clip at C and f and run on beside the
//    next half and the next item's products (stores of 4 bytes a thread
//    straight from the fragments took several times as long in
//    development builds).  setmaxnreg hands the producer's registers to
//    the consumers.
//  * "mma", the same bf16 inputs with fewer rows (decode and serve: 4 or 8
//    rows per expert, byte-bound): `mma.sync.m16n8k16`.  A block is 4 warps
//    over 16, 32 or 64 rows (the fewest m16 tiles that hold C, up to 4) and
//    128 columns of one expert (blockIdx.z), 32 columns a warp.  First it
//    tests its rows of x (at most 64 x d from L2; the bits of every bf16
//    but the sign, so -0.0 counts as zero); a dead block writes its tile as
//    +0 and exits.  A live block streams 64-deep slices of x and w (16 KB of
//    w a slice) through a ring of shared-memory stages fed by 16-byte
//    `cp.async`: up to 16 rows, 3 stages, two slices in flight while one
//    computes; with four blocks per SM that keeps 128 KB of weight reads in
//    flight per SM.  Fragments are read with `ldmatrix` (`.trans` for w,
//    which is stored d-major, its rows swizzled).
//  * "simt", anything else (f32; bf16 with odd widths or misaligned): a
//    CUDA-core tile of 64 x 64 per 256 threads, 4 x 4 outputs a thread, in
//    f32 fmaf.
//
// Bound on an H100, at Moonlight-16B-A3B's shapes (E=64, d=2048, f=1408):
//  * prefill, 4 prompts of 2,048 tokens, capacity 240 per row, rows folded
//    into C = 960: 2*E*C*d*f = 3.54e11 FLOP, 0.358 ms at 989 TFLOP/s (bf16
//    dense), against 0.24 ms for its 794 MB -- operations;
//  * decode, C = 8 (one slot per row): 369 MB of expert weights read once,
//    0.110 ms at 3.35 TB/s -- bytes; with the skip, only the live experts'
//    5.77 MB each (at most 24 x 5.77 = 138 MB, 0.041 ms, at 4 rows).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "../../csrc/common.cuh"
#include "../../csrc/hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- mma.sync
constexpr int kBN = 128;         // columns of f per block, 32 per warp
constexpr int kBK = 64;          // depth of one ring stage
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWN = kBN / kWarps;  // 32 columns per warp
constexpr int kNT = kWN / 8;       // n8 fragments per warp
// Shared rows: x's padded to 144 bytes, w's 256 bytes with the 16-byte
// chunk c of row r stored at c ^ (r % 8) (unpadded, so that a stage is 16
// KB of w and four blocks fit on an SM); either way the 8 rows an ldmatrix
// reads fall in 8 distinct 16-byte bank groups.
constexpr int kAStr = kBK + 8;
constexpr int kBStr = kBN;

__device__ __forceinline__ int w_chunk(int r, int col) { return ((col >> 3) ^ (r & 7)) << 3; }

using kern::mma_bf16;

// MT m16 tiles of rows per block: 16, 32 or 64 rows.  Up to 16 rows
// (decode, serve) the ring has 3 stages, two slices in flight while one
// computes (55 KB: four blocks and 128 KB of weight reads in flight per
// SM, faster in development than 2-3 blocks with 4-5 stages); with more
// rows the products weigh more than the bytes in flight and 2 stages let
// 4-5 blocks share an SM (faster at 33 and 64 rows).
template <int MT>
struct MmaLayout {
  static constexpr int ROWS = 16 * MT;
  static constexpr int STAGES = MT == 1 ? 3 : 2;
  static constexpr int A = ROWS * kAStr;  // x slice, bf16
  static constexpr int B = kBK * kBStr;   // w slice, bf16
  static constexpr int STAGE = A + B;
  static constexpr int BYTES = STAGES * STAGE * 2;
};

template <int MT>
__global__ void __launch_bounds__(kThreads)
    moe_gemm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        bf16* __restrict__ out, int c, int d, int f, int skip_dead,
                        int dead_expert) {
  using L = MmaLayout<MT>;
  extern __shared__ __align__(16) uint8_t mma_smem[];
  bf16* sm = reinterpret_cast<bf16*>(mma_smem);
  const int m0 = blockIdx.y * L::ROWS, n0 = blockIdx.x * kBN, e = blockIdx.z;
  const bf16* xe = x + (long long)e * c * d;
  const bf16* we = w + (long long)e * d * f;
  bf16* oe = out + (long long)e * c * f;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wn = warp * kWN;
  const int rows = min(L::ROWS, c - m0);

  if (skip_dead) {
    // The block's rows of x, contiguous: dead if every element is +0 or -0.
    const uint4* xr = reinterpret_cast<const uint4*>(xe + (long long)m0 * d);
    const int chunks = rows * (d / 8);
    uint32_t bits = 0;
#pragma unroll 8
    for (int i = tid; i < chunks; i += kThreads) {
      const uint4 u = __ldg(xr + i);
      bits |= (u.x | u.y | u.z | u.w) & 0x7FFF7FFFu;
    }
    if (!__syncthreads_or(bits != 0) || e == dead_expert) {
      const int vecs = min(kBN, f - n0) / 8;  // f is a multiple of 8
      for (int i = tid; i < rows * vecs; i += kThreads)
        *reinterpret_cast<uint4*>(oe + (long long)(m0 + i / vecs) * f + n0 + (i % vecs) * 8) =
            make_uint4(0, 0, 0, 0);
      return;
    }
  }

  // Slice kt (depth kt * kBK) into stage kt % STAGES; zeros past C, d and
  // f (d and f are multiples of 8, so a 16-byte chunk is wholly in or out).
  const int nk = (d + kBK - 1) / kBK;
  auto load = [&](int kt) {
    if (kt < nk) {
      const int k0 = kt * kBK;
      bf16* as = sm + (kt % L::STAGES) * L::STAGE;
      bf16* bs = as + L::A;
#pragma unroll
      for (int j = 0; j < L::ROWS * (kBK / 8) / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int r = i / (kBK / 8), kc = (i % (kBK / 8)) * 8;
        const bool live = r < rows && k0 + kc < d;
        kern::cp_async16(as + r * kAStr + kc, live ? xe + (long long)(m0 + r) * d + k0 + kc : xe,
                         live);
      }
#pragma unroll
      for (int j = 0; j < kBK * (kBN / 8) / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int r = i / (kBN / 8), nc = (i % (kBN / 8)) * 8;
        const bool live = k0 + r < d && n0 + nc < f;
        kern::cp_async16(bs + r * kBStr + w_chunk(r, nc),
                         live ? we + (long long)(k0 + r) * f + n0 + nc : we, live);
      }
    }
    kern::cp_async_commit();  // one group per slice slot, empty or not
  };

  float acc[MT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNT; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;

#pragma unroll
  for (int kt = 0; kt < L::STAGES - 1; ++kt) load(kt);
  for (int kt = 0; kt < nk; ++kt) {
    kern::cp_async_wait<L::STAGES - 2>();  // this thread's copies of slice kt
    __syncthreads();  // ... and everyone's; slice kt - 1 is consumed
    load(kt + L::STAGES - 1);  // into slice kt - 1's stage
    const bf16* as = sm + (kt % L::STAGES) * L::STAGE;
    const bf16* bs = as + L::A;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A fragments (m16n8k16 row layout) of the block's m16 tiles.
      uint32_t af[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        kern::ldmatrix_x4(af[mi], as + (mi * 16 + (lane & 15)) * kAStr + kk * 16 + (lane >> 4) * 8);
      // B fragments two n8 tiles at a time: lanes 0-7 rows k 0-7 and lanes
      // 8-15 rows k 8-15 of tile nj; lanes 16-31 the same for tile nj + 1.
#pragma unroll
      for (int nj = 0; nj < kNT; nj += 2) {
        uint32_t bfrag[4];
        const int br = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        kern::ldmatrix_x4_trans(bfrag, bs + br * kBStr + w_chunk(br, wn + nj * 8 + (lane >> 4) * 8));
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma_bf16(acc[mi][nj], af[mi], bfrag[0], bfrag[1]);
          mma_bf16(acc[mi][nj + 1], af[mi], bfrag[2], bfrag[3]);
        }
      }
    }
  }
  kern::cp_async_wait<0>();

  // C fragments: acc[..][0..1] row grp, acc[..][2..3] row grp + 8, columns
  // 2 tig + {0, 1}.  f is a multiple of 8, so a pair is wholly in or out.
  const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mi * 16 + grp + half * 8;
      if (r >= rows) continue;
#pragma unroll
      for (int nj = 0; nj < kNT; ++nj) {
        const int col = n0 + wn + nj * 8 + tig * 2;
        if (col < f)
          *reinterpret_cast<__nv_bfloat162*>(oe + (long long)(m0 + r) * f + col) =
              __floats2bfloat162_rn(acc[mi][nj][half * 2], acc[mi][nj][half * 2 + 1]);
      }
    }
}

template <int MT>
cudaError_t launch_mma(const void* x, const void* w, void* out, int e, int c, int d, int f,
                       int skip_dead, int dead_expert, cudaStream_t st) {
  using L = MmaLayout<MT>;
  static unsigned long long sized = 0;  // devices whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(sized >> dev & 1)) {
    err = cudaFuncSetAttribute(moe_gemm_mma_kernel<MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return err;
    sized |= 1ULL << dev;
  }
  dim3 grid((f + kBN - 1) / kBN, (c + L::ROWS - 1) / L::ROWS, e);
  moe_gemm_mma_kernel<MT><<<grid, kThreads, L::BYTES, st>>>(
      (const bf16*)x, (const bf16*)w, (bf16*)out, c, d, f, skip_dead, dead_expert);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- CUDA cores
constexpr int kSBM = 64, kSBN = 64, kSBK = 16;
constexpr int kSThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

using kern::from_f;
using kern::to_f;

template <typename T>
__global__ void __launch_bounds__(kSThreads)
    moe_gemm_simt_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                         int c, int d, int f) {
  __shared__ float xs[kSBK][kSBM + 4];  // x slice, d-major
  __shared__ float ws[kSBK][kSBN + 4];
  const int m0 = blockIdx.y * kSBM, n0 = blockIdx.x * kSBN;
  const T* xe = x + (long long)blockIdx.z * c * d;
  const T* we = w + (long long)blockIdx.z * d * f;
  T* oe = out + (long long)blockIdx.z * c * f;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kSBK) {
    for (int i = tid; i < kSBM * kSBK; i += kSThreads) {
      const int r = i / kSBK, kk = i % kSBK;
      const int row = m0 + r, k = k0 + kk;
      xs[kk][r] = (row < c && k < d) ? to_f(xe[(long long)row * d + k]) : 0.f;
    }
    for (int i = tid; i < kSBK * kSBN; i += kSThreads) {
      const int kk = i / kSBN, nn = i % kSBN;
      const int k = k0 + kk, n = n0 + nn;
      ws[kk][nn] = (k < d && n < f) ? to_f(we[(long long)k * f + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= c) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < f) oe[(long long)row * f + col] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch_simt(const void* x, const void* w, void* out, int e, int c, int d, int f,
                        cudaStream_t st) {
  dim3 grid((f + kSBN - 1) / kSBN, (c + kSBM - 1) / kSBM, e);
  moe_gemm_simt_kernel<T><<<grid, kSThreads, 0, st>>>((const T*)x, (const T*)w, (T*)out, c, d, f);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- wgmma
constexpr int kWgRows = 128;              // output rows per consumer warpgroup: two m64 halves
constexpr int kWgBM = 2 * kWgRows;        // rows per tile
constexpr int kWgBN = 128;                // columns per tile: wgmma's N
constexpr int kWgBK = 64;                 // depth per ring slot: one 128-byte swizzle row
constexpr int kWgThreads = 3 * 128;       // producer + two consumer warpgroups
constexpr int kWgStages = 4;
// An SM sub-partition holds 3 of the block's 12 warps in 16,384 registers:
// 168 a thread at launch, or 40 for the producer and 232 for the consumers
// (whose two 64 x 128 accumulators take 128).
constexpr int kWgProducerRegs = 40, kWgConsumerRegs = 232;
constexpr int kBoxCols = 64;              // bf16 per TMA box row (128 bytes)
constexpr int kRowBytes = kBoxCols * 2;
constexpr int kHalfBytes = 64 * kRowBytes;           // 64 rows of x, 64 deep: 8 KB
constexpr int kABytes = kWgBM * kRowBytes;           // x: 256 rows x 64 deep, 32 KB
constexpr int kBBox = kWgBK * kRowBytes;             // w: 64 deep x 64 columns, 8 KB
constexpr int kBBytes = (kWgBN / kBoxCols) * kBBox;  // w: 64 deep x 128 columns
constexpr int kStageBytes = kABytes + kBBytes;       // 48 KB
constexpr int kOutBox = 64 * kRowBytes;              // out: 64 rows x 64 columns, 8 KB
constexpr int kOutWg = (kWgBN / kBoxCols) * kOutBox; // a consumer's staging: one m64 half
constexpr int kOutOff = kWgStages * kStageBytes;
constexpr int kBarOff = kOutOff + 2 * kOutWg;
constexpr int kWgSmem = kBarOff + 2 * kWgStages * 8 + 1024;  // + alignment slack: 225 KB

struct WgItem {
  int e, m0, n0;
};

// Item w: experts in order (the weights of the experts in flight stay in
// L2), then m tiles, then n tiles.
__device__ __forceinline__ WgItem wg_item(int w, int mt, int nt) {
  WgItem it;
  it.e = w / (mt * nt);
  it.m0 = (w / nt % mt) * kWgBM;
  it.n0 = (w % nt) * kWgBN;
  return it;
}

// A consumer's products over one item's nk slices of depth, on one (TWO =
// false) or both of its m64 halves; `it` counts the ring's slices.  Each
// branch is one straight run of wgmma, so ptxas adds no fences of its own.
template <bool TWO>
__device__ __forceinline__ void consume(float (&acc0)[kWgBN / 2], float (&acc1)[kWgBN / 2],
                                        const uint8_t* smem, uint64_t* full, uint64_t* empty,
                                        int cw, int nk, int& it) {
  for (int kb = 0; kb < nk; ++kb, ++it) {
    const int s = it % kWgStages;
    hopper::mbar_wait(&full[s], (it / kWgStages) & 1);
    // A k16 step kk is 32 bytes into x's rows and 16 rows (2 KB) down w's.
    const uint8_t* stage = smem + s * kStageBytes;
    const uint64_t da =
        hopper::desc_sw128(hopper::smem_u32(stage + 2 * cw * kHalfBytes), 16, 1024);
    const uint64_t db = hopper::desc_sw128(hopper::smem_u32(stage + kABytes), kBBox, 1024);
    hopper::fence_regs(acc0);
    if (TWO) hopper::fence_regs(acc1);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      const uint64_t dbk = db + ((kk * 16 * kRowBytes) >> 4);
      hopper::wgmma_ss_tb<kWgBN>(acc0, da + ((kk * 32) >> 4), dbk, kb > 0 || kk > 0);
      if (TWO)
        hopper::wgmma_ss_tb<kWgBN>(acc1, da + ((kHalfBytes + kk * 32) >> 4), dbk,
                                   kb > 0 || kk > 0);
    }
    hopper::wgmma_commit();
    // The previous slice's products are done: its slot may refill.
    hopper::wgmma_wait<1>();
    hopper::fence_regs(acc0);
    if (TWO) hopper::fence_regs(acc1);
    if (kb > 0) hopper::mbar_arrive(&empty[(it - 1) % kWgStages]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc0);
  if (TWO) hopper::fence_regs(acc1);
  hopper::mbar_arrive(&empty[(it - 1) % kWgStages]);
}

__global__ void __launch_bounds__(kWgThreads, 1)
    moe_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_w,
                          const __grid_constant__ CUtensorMap tm_o, int e_count, int c, int d,
                          int f) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kWgStages;
  const int mt = (c + kWgBM - 1) / kWgBM, nt = (f + kWgBN - 1) / kWgBN;
  const int n_items = e_count * mt * nt, nk = (d + kWgBK - 1) / kWgBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);  // every consumer thread arrives
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // The ring's slots and phases run on across items (`it` counts k slices).
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full.
    hopper::setmaxnreg_dec<kWgProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        const WgItem item = wg_item(w, mt, nt);
        // w's second 64-column box lies wholly past f on a ragged last n
        // tile: it is not loaded (its stale columns feed only outputs that
        // are not stored).
        const int boxes = item.n0 + kBoxCols < f ? 2 : 1;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % kWgStages;
          hopper::mbar_wait(&empty[s], ((it / kWgStages) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], kABytes + boxes * kBBox);
          uint8_t* stage = smem + s * kStageBytes;
          hopper::tma_load_3d(stage, &tm_x, &full[s], kb * kWgBK, item.m0, item.e);
          for (int bx = 0; bx < boxes; ++bx)
            hopper::tma_load_3d(stage + kABytes + bx * kBBox, &tm_w, &full[s],
                                item.n0 + bx * kBoxCols, kb * kWgBK, item.e);
        }
      }
    }
  } else {
    // ---- consumers: 128 rows of each tile, as two m64 halves.
    hopper::setmaxnreg_inc<kWgConsumerRegs>();
    const int cw = wg - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
    // Accumulator fragments (wgmma's D layout): acc[h] entry 4n + 2*half +
    // e holds row 64 h + 16 warp + g + 8 half, column 8n + 2q + e.
    float acc0[kWgBN / 2], acc1[kWgBN / 2];
    int it = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const WgItem item = wg_item(w, mt, nt);
      const int row0 = item.m0 + cw * kWgRows;
      // Halves whose 64 rows all lie past C issue no products.
      const int halves = row0 >= c ? 0 : row0 + 64 >= c ? 1 : 2;
      if (halves == 0) {  // let the slices pass
        for (int kb = 0; kb < nk; ++kb, ++it) {
          hopper::mbar_wait(&full[it % kWgStages], (it / kWgStages) & 1);
          hopper::mbar_arrive(&empty[it % kWgStages]);
        }
        continue;
      }
      if (halves == 2)
        consume<true>(acc0, acc1, smem, full, empty, cw, nk, it);
      else
        consume<false>(acc0, acc1, smem, full, empty, cw, nk, it);

      // Each m64 half goes out through this consumer's staging tile, in the
      // TMA box layout, and one TMA store per 64-column box, which clips at
      // C and f.  The store runs on while the next half is written (once
      // it has read the tile) and while the next item's products run.
      uint8_t* stage_out = smem + kOutOff + cw * kOutWg;
      auto put = [&](const float(&a)[kWgBN / 2], int r_base) {
        if (tid == 0) hopper::tma_store_wait_read<0>();
        hopper::bar_sync(1 + cw, 128);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp * 16 + g + 8 * half;
#pragma unroll
          for (int n = 0; n < kWgBN / 8; ++n) {
            const int byte =
                (n / 8) * kOutBox + r * kRowBytes + (((n % 8) ^ (r % 8)) * 16) + q * 4;
            *reinterpret_cast<__nv_bfloat162*>(stage_out + byte) =
                __floats2bfloat162_rn(a[4 * n + 2 * half], a[4 * n + 2 * half + 1]);
          }
        }
        hopper::fence_proxy_async();
        hopper::bar_sync(1 + cw, 128);
        if (tid == 0) {
          for (int bx = 0; bx < kWgBN / kBoxCols; ++bx)
            if (item.n0 + bx * kBoxCols < f)
              hopper::tma_store_3d(&tm_o, stage_out + bx * kOutBox, item.n0 + bx * kBoxCols,
                                   r_base, item.e);
          hopper::tma_store_commit();
        }
      };
      put(acc0, row0);
      if (halves == 2) put(acc1, row0 + 64);
    }
    if (tid == 0) hopper::tma_store_wait_all();
  }
}

// A rank-3 map (inner, rows, mats) of a contiguous bf16 tensor, boxes of 64
// x box_rows x 1 with 128-byte swizzle; reads past an edge give zeros.
bool encode_map(CUtensorMap* map, const void* ptr, int inner, int rows, int mats, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)mats};
  const cuuint64_t row = (cuuint64_t)inner * sizeof(bf16);
  const cuuint64_t strides[2] = {row, row * rows};
  const cuuint32_t box[3] = {(cuuint32_t)kBoxCols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_wgmma(const void* x, const void* w, void* out, int e, int c, int d, int f,
                         cudaStream_t st) {
  CUtensorMap mx, mw, mo;
  if (!encode_map(&mx, x, d, c, e, kWgBM) || !encode_map(&mw, w, f, d, e, kWgBK) ||
      !encode_map(&mo, out, f, c, e, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(moe_gemm_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long long items =
      (long long)e * ((c + kWgBM - 1) / kWgBM) * ((f + kWgBN - 1) / kWgBN);
  moe_gemm_wgmma_kernel<<<(int)std::min<long long>(items, sms), kWgThreads, kWgSmem, st>>>(
      mx, mw, mo, e, c, d, f);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// path: 0 = simt, 1 = mma, 2 = wgmma (ops.kernel_path); dtype: 0 = float32,
// 1 = bfloat16.  skip_dead (mma body only): blocks whose rows of x are all
// +-0 read no weights and write +0 (0 computes every block, as the other
// bodies do); dead_expert: an expert the mma body treats as dead whatever
// its rows (a planted fault for chip_smoke.py; -1 for none).  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a path that does
// not take the input, cudaErrorMisalignedAddress for a tensor core path
// given a misaligned one).
extern "C" int moe_gemm_launch(const void* x, const void* w, void* out, int e, int c, int d, int f,
                               int dtype, int path, int skip_dead, int dead_expert,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (path == 0 && dtype == 0) return (int)launch_simt<float>(x, w, out, e, c, d, f, st);
  if (path == 0 && dtype == 1) return (int)launch_simt<bf16>(x, w, out, e, c, d, f, st);
  if (dtype != 1 || d % 8 != 0 || f % 8 != 0 || (path != 1 && path != 2))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(out)) return (int)cudaErrorMisalignedAddress;
  if (path == 2) return (int)launch_wgmma(x, w, out, e, c, d, f, st);
  if (c <= 16) return (int)launch_mma<1>(x, w, out, e, c, d, f, skip_dead, dead_expert, st);
  if (c <= 32) return (int)launch_mma<2>(x, w, out, e, c, d, f, skip_dead, dead_expert, st);
  return (int)launch_mma<4>(x, w, out, e, c, d, f, skip_dead, dead_expert, st);
}
