// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over the sequence.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru_scan/rglru_scan.py :: rglru_scan_pallas (_kernel)
//
// a, b (B,S,W) bf16 or f32, h0 (B,W) f32; output (B,S,W) in a's dtype.  The
// carry is f32 and every step rounds as the plain version does: the product
// and the sum are each rounded to f32 (__fmul_rn, __fadd_rn, never
// contracted into an FMA), so the kernel agrees with the plain PyTorch
// version (ref.py) bit for bit.
//
// The Pallas kernel tiles (batch, width blocks, sequence blocks) with the
// sequence axis innermost and sequential, carrying h across sequence blocks
// in VMEM scratch (rglru_scan.py:26-38).  Blocks here run in no order, so
// the carry cannot pass between blocks: one thread owns one (b, w) channel
// and walks the whole sequence itself, with h in a register, in order.  The
// sequence is not split into chunks: a chunked scan would round otherwise,
// and the chain of S dependent steps (2,048 at ~8 cycles, ~9 us) is far
// below the bytes bound anyway.
//
// Bound on an H100: bytes.  The recurrence reads a and b once and writes h
// once: at RecurrentGemma-2B's prefill, (8, 2048, 2560) f32, 503 MB, or
// 0.150 ms at 3.35 TB/s; its 2 flops per element are nothing beside that.
// Only B*W = 20,480 channels exist, too few threads to cover device-memory
// latency with their own loads, so the loads leave the threads:
//
//  * "tma" body (ops.kernel_path: rows of a whole number of 16 bytes,
//    16-byte-aligned a, b and h).  A block owns a tile of channels of one
//    batch row.  One producer thread keeps a ring of kStages stages in
//    shared memory full with TMA copies of (tile channels x steps) boxes of
//    a and b, completing on an mbarrier per stage.  The tile is 160
//    channels: at the prefill shape 128 blocks, at most one per SM, each
//    with 3 x 40 KB in flight, so every block streams at the same share of
//    the card's bandwidth, and each box row is 640 contiguous bytes.  (In
//    development builds 64-channel tiles, 2-3 blocks an SM with rows of
//    256 bytes, read slower; so did the same tiles chosen at run time.)
//    The consumer threads, one per channel, read each stage in step order
//    from shared memory (conflict-free: a warp reads 32 neighbouring
//    channels) and write h into one of two staging tiles, which one thread
//    stores with a TMA copy per stage (in development builds a little
//    faster than each thread storing its own h).  Channels past W read the
//    zeros TMA fills in beyond the edge, steps past S likewise; the stores
//    clip at both.
//  * "direct" body (any other shape).  Each thread loads its channel's a
//    and b itself, kUnroll steps ahead of the dependent chain.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../csrc/common.cuh"
#include "../../csrc/hopper.cuh"

namespace {

using kern::from_f;
using kern::to_f;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- direct body
constexpr int kThreads = 64;  // small blocks spread 20,480 channels over all SMs
constexpr int kUnroll = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_direct_kernel(const T* __restrict__ a, const T* __restrict__ b,
                             const float* __restrict__ h0, T* __restrict__ out, int batch,
                             int s_len, int width) {
  const long long ch = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (ch >= (long long)batch * width) return;
  const long long row = ch / width, w = ch % width;
  const long long base = row * s_len * width + w;
  const T* __restrict__ ap = a + base;
  const T* __restrict__ bp = b + base;
  T* __restrict__ op = out + base;
  float h = h0[ch];
  int t = 0;
  for (; t + kUnroll <= s_len; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = to_f(ap[(long long)(t + u) * width]);
      bv[u] = to_f(bp[(long long)(t + u) * width]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      op[(long long)(t + u) * width] = from_f<T>(h);
    }
  }
  for (; t < s_len; ++t) {
    h = __fadd_rn(__fmul_rn(to_f(ap[(long long)t * width]), h), to_f(bp[(long long)t * width]));
    op[(long long)t * width] = from_f<T>(h);
  }
}

template <typename T>
cudaError_t launch_direct(const void* a, const void* b, const void* h0, void* out, int batch,
                          int s_len, int width, cudaStream_t st) {
  const long long channels = (long long)batch * width;
  const int blocks = (int)((channels + kThreads - 1) / kThreads);
  rglru_scan_direct_kernel<T><<<blocks, kThreads, 0, st>>>(
      (const T*)a, (const T*)b, (const float*)h0, (T*)out, batch, s_len, width);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- tma body
// ops.TILE, ops.STAGES, ops.STEP_BYTES: channels per block (one consumer
// thread each, whole warps), ring stages, and the bytes of one channel's a
// (and b) a stage holds -- kSteps<T> steps, 32 in f32 and 64 in bf16.
constexpr int kTile = 160;
constexpr int kStages = 3;
constexpr int kStepBytes = 128;
constexpr int kHalf = kTile * kStepBytes;  // a's part of a stage, then b's
constexpr int kTmaThreads = kTile + 32;    // the consumers, then the producer warp
// The ring, two staging tiles of h (kHalf bytes each), room to align them.
constexpr int kTmaSmem = kStages * 2 * kHalf + 2 * kHalf + 128;

template <typename T>
constexpr int kSteps = kStepBytes / (int)sizeof(T);

// fault_stage: a ring stage the consumers run through twice (a planted
// fault for chip_smoke.py; -1 for none).
template <typename T>
__global__ void __launch_bounds__(kTmaThreads)
    rglru_scan_tma_kernel(const __grid_constant__ CUtensorMap tm_a,
                          const __grid_constant__ CUtensorMap tm_b,
                          const __grid_constant__ CUtensorMap tm_o, const float* __restrict__ h0,
                          int s_len, int width, int fault_stage) {
  constexpr int kS = kSteps<T>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  const int w0 = blockIdx.x * kTile, row = blockIdx.y;
  const int nstage = (s_len + kS - 1) / kS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kTile / 32);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kTile) {
    // ---- producer: one thread keeps kStages stages in flight.
    if (threadIdx.x == kTile) {
      for (int it = 0; it < nstage; ++it) {
        const int s = it % kStages;
        hopper::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * kHalf);
        uint8_t* stage = ring + s * 2 * kHalf;
        hopper::tma_load_3d(stage, &tm_a, &full[s], w0, it * kS, row);
        hopper::tma_load_3d(stage + kHalf, &tm_b, &full[s], w0, it * kS, row);
      }
    }
    return;
  }

  // ---- consumers: thread c owns channel w0 + c, steps in order.
  const int c = threadIdx.x, w = w0 + c;
  const bool live = w < width;
  float h = live ? h0[(long long)row * width + w] : 0.0f;
  for (int it = 0; it < nstage; ++it) {
    const int s = it % kStages;
    // h goes out through two staging tiles, by TMA: the store from this
    // tile two stages ago must have read it first.
    T* so = reinterpret_cast<T*>(ring + kStages * 2 * kHalf + (it % 2) * kHalf) + c;
    if (c == 0) hopper::tma_store_wait_read<1>();
    hopper::bar_sync(1, kTile);
    hopper::mbar_wait(&full[s], (it / kStages) & 1);
    const T* sa = reinterpret_cast<const T*>(ring + s * 2 * kHalf) + c;
    const T* sb = reinterpret_cast<const T*>(ring + s * 2 * kHalf + kHalf) + c;
    const int steps = min(kS, s_len - it * kS);
    for (int pass = it == fault_stage ? 2 : 1; pass > 0; --pass) {
      float hs = h;
      if (steps == kS) {
#pragma unroll 16
        for (int u = 0; u < kS; ++u) {
          hs = __fadd_rn(__fmul_rn(to_f(sa[u * kTile]), hs), to_f(sb[u * kTile]));
          so[u * kTile] = from_f<T>(hs);
        }
      } else {
        for (int u = 0; u < steps; ++u) {
          hs = __fadd_rn(__fmul_rn(to_f(sa[u * kTile]), hs), to_f(sb[u * kTile]));
          so[u * kTile] = from_f<T>(hs);
        }
      }
      h = hs;
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&empty[s]);
    hopper::fence_proxy_async();  // the tile's writes, before the TMA store reads them
    hopper::bar_sync(1, kTile);
    if (c == 0) {  // the box clips at W and S
      hopper::tma_store_3d(&tm_o, so, w0, it * kS, row);
      hopper::tma_store_commit();
    }
  }
  if (c == 0) hopper::tma_store_wait_all();
}

// A rank-3 map (W, S, B) of a contiguous (B,S,W) tensor, boxes of kTile
// channels x kSteps steps x 1 row, no swizzle; reads past an edge give zeros.
template <typename T>
bool encode_map(CUtensorMap* map, const void* ptr, int batch, int s_len, int width) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)s_len, (cuuint64_t)batch};
  const cuuint64_t row = (cuuint64_t)width * sizeof(T);
  const cuuint64_t strides[2] = {row, row * s_len};
  const cuuint32_t box[3] = {(cuuint32_t)kTile, (cuuint32_t)kSteps<T>, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return cuTensorMapEncodeTiled(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
cudaError_t launch_tma(const void* a, const void* b, const void* h0, void* out, int batch,
                       int s_len, int width, int fault_stage, cudaStream_t st) {
  if ((width * sizeof(T)) % 16 != 0) return cudaErrorInvalidValue;
  if (!aligned16(a) || !aligned16(b) || !aligned16(out)) return cudaErrorMisalignedAddress;
  CUtensorMap ma, mb, mo;
  if (!encode_map<T>(&ma, a, batch, s_len, width) || !encode_map<T>(&mb, b, batch, s_len, width) ||
      !encode_map<T>(&mo, out, batch, s_len, width))
    return cudaErrorInvalidValue;
  auto kern = rglru_scan_tma_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kTmaSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((width + kTile - 1) / kTile), (unsigned)batch);
  kern<<<grid, kTmaThreads, kTmaSmem, st>>>(ma, mb, mo, (const float*)h0, s_len, width,
                                             fault_stage);
  return cudaGetLastError();
}

}  // namespace

// dtype of a, b and out: 0 = float32, 1 = bfloat16; h0 is float32.  path:
// 0 = direct, 1 = tma (ops.kernel_path); fault_stage: see the tma kernel
// (-1 for none).  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for the tma path given rows that are not a whole
// number of 16 bytes, cudaErrorMisalignedAddress for it given a misaligned
// a or b).
extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0, void* out,
                                 int batch, int s_len, int width, int dtype, int path,
                                 int fault_stage, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (path == 0 && dtype == 0)
    return (int)launch_direct<float>(a, b, h0, out, batch, s_len, width, st);
  if (path == 0 && dtype == 1)
    return (int)launch_direct<bf16>(a, b, h0, out, batch, s_len, width, st);
  if (path == 1 && dtype == 0)
    return (int)launch_tma<float>(a, b, h0, out, batch, s_len, width, fault_stage, st);
  if (path == 1 && dtype == 1)
    return (int)launch_tma<bf16>(a, b, h0, out, batch, s_len, width, fault_stage, st);
  return (int)cudaErrorInvalidValue;
}
