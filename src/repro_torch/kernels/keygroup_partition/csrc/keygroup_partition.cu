// Hash partition + arrival histogram: raw integer keys -> key-group ids.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/keygroup_partition/keygroup_partition.py
//   :: keygroup_partition_pallas (_kernel, _mix32_u32)
// and the 64->32 fold its wrapper ran on the host (ops.py fold_keys64).
//
// Per key: fold the two's-complement 64-bit view to 32 bits
// (u ^ (u >> 32)), run the murmur3 finisher mix32 in native uint32, take
// (h & 0x7FFFFFFF) % nkg, write base + id as int64, and count the id in a
// per-block shared-memory histogram that is flushed to the global int64
// histogram with one atomicAdd per nonzero bucket.  Integer atomics commute,
// so the histogram is exact whatever order the blocks run in.
//
// Bound on an H100: memory.  Each key is read once (8 B for int64 keys) and
// its id written once (8 B), plus nkg * 8 B of histogram: at n = 2^20 and
// nkg = 1000, 16.8 MB, about 5.0 us at 3.35 TB/s.  The arithmetic (two
// multiplies, three shifts, one modulo per key) is far below the card's
// integer rate.  The design keeps the histogram out of device memory until
// the block's flush, and runs a grid of about two blocks per SM so the
// flush costs nkg atomics per block, not per key.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kMixC1 = 0x85EBCA6Bu;
constexpr uint32_t kMixC2 = 0xC2B2AE35u;
constexpr uint32_t kMask31 = 0x7FFFFFFFu;
constexpr int kThreads = 256;
constexpr size_t kMaxSmemBytes = 200 * 1024;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= kMixC1;
  h ^= h >> 13;
  h *= kMixC2;
  h ^= h >> 16;
  return h;
}

template <typename K, bool kSmem>
__global__ void keygroup_partition_kernel(const K* __restrict__ keys, int64_t n,
                                          uint32_t nkg, int64_t base,
                                          int64_t* __restrict__ ids,
                                          unsigned long long* __restrict__ hist) {
  extern __shared__ unsigned int smem_hist[];
  if (kSmem) {
    for (uint32_t b = threadIdx.x; b < nkg; b += blockDim.x) smem_hist[b] = 0u;
    __syncthreads();
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    // Sign-extend int32 keys, then the two's-complement uint64 view.
    const uint64_t u = (uint64_t)(int64_t)keys[i];
    const uint32_t h = mix32((uint32_t)(u ^ (u >> 32)));
    const uint32_t kg = (h & kMask31) % nkg;
    ids[i] = (int64_t)kg + base;
    if (kSmem) {
      atomicAdd(&smem_hist[kg], 1u);
    } else {
      atomicAdd(&hist[kg], 1ull);
    }
  }
  if (kSmem) {
    __syncthreads();
    for (uint32_t b = threadIdx.x; b < nkg; b += blockDim.x) {
      const unsigned int c = smem_hist[b];
      if (c) atomicAdd(&hist[b], (unsigned long long)c);
    }
  }
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

template <typename K>
cudaError_t launch(const void* keys, int64_t n, int nkg, int64_t base, void* ids,
                   void* hist, cudaStream_t stream) {
  int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = 2LL * num_sms();
  const int blocks = (int)(want < cap ? (want > 0 ? want : 1) : cap);
  const size_t smem = (size_t)nkg * sizeof(unsigned int);
  if (smem <= kMaxSmemBytes) {
    auto kern = keygroup_partition_kernel<K, true>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    kern<<<blocks, kThreads, smem, stream>>>(
        (const K*)keys, n, (uint32_t)nkg, base, (int64_t*)ids,
        (unsigned long long*)hist);
  } else {
    keygroup_partition_kernel<K, false><<<blocks, kThreads, 0, stream>>>(
        (const K*)keys, n, (uint32_t)nkg, base, (int64_t*)ids,
        (unsigned long long*)hist);
  }
  return cudaGetLastError();
}

}  // namespace

// keys: n int32 (key_bytes = 4) or int64 (key_bytes = 8) keys on the card;
// ids: n int64 outputs; hist: nkg int64 outputs, zeroed here.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int keygroup_partition_launch(const void* keys, int key_bytes, long long n,
                                         int nkg, long long base, void* ids, void* hist,
                                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(hist, 0, (size_t)nkg * sizeof(int64_t), s);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return (int)cudaGetLastError();
  if (key_bytes == 8) return (int)launch<int64_t>(keys, n, nkg, base, ids, hist, s);
  if (key_bytes == 4) return (int)launch<int32_t>(keys, n, nkg, base, ids, hist, s);
  return (int)cudaErrorInvalidValue;
}
