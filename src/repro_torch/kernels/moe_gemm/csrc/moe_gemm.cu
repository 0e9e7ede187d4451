// Grouped expert matmul (E, C, d) x (E, d, f) -> (E, C, f), f32 accumulation.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/moe_gemm/moe_gemm.py :: moe_gemm_pallas (_kernel)
//
// x (E,C,d) and w (E,d,f), both bf16 or both f32, contiguous; output (E,C,f)
// in x's dtype, every product summed in f32 and rounded once.  Like the
// Pallas kernel it takes no count of the used capacity slots and skips
// nothing: every expert's whole (C, f) tile is computed.  Unlike it, no
// dimension need divide a tile: the ragged edges of C, d and f are masked
// (loads past an edge read 0, stores past it are dropped), so the decode
// shape's 8 rows and d_ff 1,408 (5.5 x 256) run as they are.
//
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
//    over a 64 x 128 tile of one expert (blockIdx.z), 32 x 64 per warp
//    (2 x 8 fragments); each 32-deep slice of x and w is staged in shared
//    memory with 16-byte loads, and fragments are read with `ldmatrix`
//    (`.trans` for w, which is stored d-major).  The next slice's global
//    loads are issued into registers before the current slice's products,
//    so they overlap.
//  * "simt", anything else (f32; bf16 with odd widths or misaligned): a
//    CUDA-core tile of 64 x 64 per 256 threads, 4 x 4 outputs a thread, in
//    f32 fmaf.
//
// Bound on an H100, at Moonlight-16B-A3B's shapes (E=64, d=2048, f=1408):
//  * prefill, 4 prompts of 2,048 tokens, capacity 240 per row, rows folded
//    into C = 960: 2*E*C*d*f = 3.54e11 FLOP, 0.358 ms at 989 TFLOP/s (bf16
//    dense), against 0.24 ms for its 794 MB -- operations;
//  * decode, C = 8 (one slot per row): 369 MB of expert weights read once,
//    0.110 ms at 3.35 TB/s -- bytes.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "../../csrc/common.cuh"
#include "../../csrc/hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- tensor cores
constexpr int kBM = 64;  // rows of C per block
constexpr int kBN = 128;  // columns of f per block
constexpr int kBK = 32;  // depth of one staged slice of d
constexpr int kWarpsM = 2, kWarpsN = 2;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWM = kBM / kWarpsM;  // 32 rows per warp
constexpr int kWN = kBN / kWarpsN;  // 64 columns per warp
constexpr int kMT = kWM / 16;  // m16 fragments per warp
constexpr int kNT = kWN / 8;  // n8 fragments per warp
// Shared row strides (bf16): 80 and 272 bytes, so the 8 rows an ldmatrix
// reads fall in 8 distinct 16-byte bank groups.
constexpr int kAStr = kBK + 8;
constexpr int kBStr = kBN + 8;
constexpr int kAChunks = kBM * kBK / 8 / kThreads;  // 16-byte chunks per thread
constexpr int kBChunks = kBK * kBN / 8 / kThreads;

using kern::mma_bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__global__ void __launch_bounds__(kThreads)
    moe_gemm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        bf16* __restrict__ out, int c, int d, int f) {
  __shared__ __align__(16) bf16 as[kBM * kAStr];
  __shared__ __align__(16) bf16 bs[kBK * kBStr];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const bf16* xe = x + (long long)blockIdx.z * c * d;
  const bf16* we = w + (long long)blockIdx.z * d * f;
  bf16* oe = out + (long long)blockIdx.z * c * f;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp / kWarpsN) * kWM, wn = (warp % kWarpsN) * kWN;

  // Global -> registers for the slice at depth k0 (zeros past the edges:
  // d and f are multiples of 8, so a 16-byte chunk is wholly in or out).
  uint4 ra[kAChunks], rb[kBChunks];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int chunk = tid + i * kThreads;
      const int r = chunk / (kBK / 8), kc = (chunk % (kBK / 8)) * 8;
      const int row = m0 + r, k = k0 + kc;
      ra[i] = (row < c && k < d) ? *reinterpret_cast<const uint4*>(xe + (long long)row * d + k)
                                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int chunk = tid + i * kThreads;
      const int r = chunk / (kBN / 8), nc = (chunk % (kBN / 8)) * 8;
      const int k = k0 + r, n = n0 + nc;
      rb[i] = (k < d && n < f) ? *reinterpret_cast<const uint4*>(we + (long long)k * f + n)
                               : make_uint4(0, 0, 0, 0);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int chunk = tid + i * kThreads;
      *reinterpret_cast<uint4*>(as + (chunk / (kBK / 8)) * kAStr + (chunk % (kBK / 8)) * 8) =
          ra[i];
    }
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int chunk = tid + i * kThreads;
      *reinterpret_cast<uint4*>(bs + (chunk / (kBN / 8)) * kBStr + (chunk % (kBN / 8)) * 8) =
          rb[i];
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNT; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  const int nk = (d + kBK - 1) / kBK;
  if (nk > 0) {
    load(0);
    store();
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) * kBK);  // in flight during the products below
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A fragments (m16n8k16 row layout) of the warp's two m16 tiles.
      uint32_t af[kMT][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
        ldmatrix_x4(af[mi], as + (wm + mi * 16 + (lane & 15)) * kAStr + kk * 16 + (lane >> 4) * 8);
      // B fragments two n8 tiles at a time: lanes 0-7 rows k 0-7 and lanes
      // 8-15 rows k 8-15 of tile nj; lanes 16-31 the same for tile nj + 1.
#pragma unroll
      for (int nj = 0; nj < kNT; nj += 2) {
        uint32_t bfrag[4];
        ldmatrix_x4_trans(bfrag, bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kBStr +
                                     wn + nj * 8 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          mma_bf16(acc[mi][nj], af[mi], bfrag[0], bfrag[1]);
          mma_bf16(acc[mi][nj + 1], af[mi], bfrag[2], bfrag[3]);
        }
      }
    }
    __syncthreads();  // the slice is consumed
    if (kt + 1 < nk) {
      store();
      __syncthreads();
    }
  }

  // C fragments: acc[..][0..1] row grp, acc[..][2..3] row grp + 8, columns
  // 2 tig + {0, 1}.  f is a multiple of 8, so a pair is wholly in or out.
  const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mi * 16 + grp + half * 8;
      if (row >= c) continue;
#pragma unroll
      for (int nj = 0; nj < kNT; ++nj) {
        const int col = n0 + wn + nj * 8 + tig * 2;
        if (col < f) {
          __nv_bfloat162 pair =
              __floats2bfloat162_rn(acc[mi][nj][half * 2], acc[mi][nj][half * 2 + 1]);
          *reinterpret_cast<__nv_bfloat162*>(oe + (long long)row * f + col) = pair;
        }
      }
    }
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
// 1 = bfloat16.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a path that does not take the input,
// cudaErrorMisalignedAddress for a tensor core path given a misaligned one).
extern "C" int moe_gemm_launch(const void* x, const void* w, void* out, int e, int c, int d, int f,
                               int dtype, int path, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (path == 0 && dtype == 0) return (int)launch_simt<float>(x, w, out, e, c, d, f, st);
  if (path == 0 && dtype == 1) return (int)launch_simt<bf16>(x, w, out, e, c, d, f, st);
  if (dtype != 1 || d % 8 != 0 || f % 8 != 0 || (path != 1 && path != 2))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(out)) return (int)cudaErrorMisalignedAddress;
  if (path == 2) return (int)launch_wgmma(x, w, out, e, c, d, f, st);
  dim3 grid((f + kBN - 1) / kBN, (c + kBM - 1) / kBM, e);
  moe_gemm_mma_kernel<<<grid, kThreads, 0, st>>>((const bf16*)x, (const bf16*)w, (bf16*)out, c,
                                                 d, f);
  return (int)cudaGetLastError();
}
