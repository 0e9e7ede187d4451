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
// sequential d axis in VMEM scratch.  Here one block owns one output tile
// of one expert (blockIdx.z = expert) and loops over d itself, the sums in
// registers.  Two paths:
//  * bf16 with d and f multiples of 8 and 16-byte aligned tensors (every
//    MoE config): tensor cores through `mma.sync.m16n8k16` (bf16 in, f32
//    accumulate).  A block is 4 warps over a 64 x 128 tile, 32 x 64 per
//    warp (2 x 8 fragments); each 32-deep slice of x and w is staged in
//    shared memory with 16-byte loads, and fragments are read with
//    `ldmatrix` (`.trans` for w, which is stored d-major: no transpose in
//    memory).  The next slice's global loads are issued into registers
//    before the current slice's products, so they overlap.
//  * anything else (f32; bf16 with odd widths): a CUDA-core tile of 64 x 64
//    per 256 threads, 4 x 4 outputs a thread, in f32 fmaf.
//
// Bound on an H100, at Moonlight-16B-A3B's shapes (E=64, d=2048, f=1408):
//  * prefill, 4 prompts of 2,048 tokens, capacity 240 per row, rows folded
//    into C = 960: 2*E*C*d*f = 3.54e11 FLOP, 0.358 ms at 989 TFLOP/s (bf16
//    dense), against 0.18 ms for its 540 MB -- operations;
//  * decode, C = 8 (one slot per row): 369 MB of expert weights read once,
//    0.110 ms at 3.35 TB/s -- bytes.
// `mma.sync` without TMA, `wgmma`, a deeper pipeline or a persistent
// schedule reaches a fraction of the tensor cores' peak; those are later
// work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "../../csrc/common.cuh"

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

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int moe_gemm_launch(const void* x, const void* w, void* out, int e, int c, int d, int f,
                               int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    if (d % 8 == 0 && f % 8 == 0 && aligned16(x) && aligned16(w) && aligned16(out)) {
      dim3 grid((f + kBN - 1) / kBN, (c + kBM - 1) / kBM, e);
      moe_gemm_mma_kernel<<<grid, kThreads, 0, st>>>((const bf16*)x, (const bf16*)w, (bf16*)out,
                                                     c, d, f);
      return (int)cudaGetLastError();
    }
    return (int)launch_simt<bf16>(x, w, out, e, c, d, f, st);
  }
  if (dtype == 0) return (int)launch_simt<float>(x, w, out, e, c, d, f, st);
  return (int)cudaErrorInvalidValue;
}
