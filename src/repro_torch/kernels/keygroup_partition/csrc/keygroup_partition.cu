// Hash partition + arrival histogram: raw integer keys -> key-group ids.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/keygroup_partition/keygroup_partition.py
//   :: keygroup_partition_pallas (_kernel, _mix32_u32)
// and the 64->32 fold its wrapper ran on the host (ops.py fold_keys64).
//
// Per key: fold the two's-complement 64-bit view to 32 bits
// (u ^ (u >> 32)), run the murmur3 finisher mix32 in native uint32, take
// (h & 0x7FFFFFFF) % nkg -- as a multiply-high by a constant the wrapper
// computes (ops.magic), exact for every dividend below 2^31 -- write
// base + id as int64, and count the id.  Integer sums are exact in any
// order, so the histogram is the same whatever order the blocks run in.
//
// Bound on an H100: memory.  Each key is read once (8 B for int64 keys) and
// its id written once (8 B), plus nkg * 8 B of histogram: at n = 2^20 and
// nkg = 1000, 16.8 MB, about 5.0 us at 3.35 TB/s.  The arithmetic (two
// multiplies, a multiply-high, shifts) is far below the card's integer
// rate.  A call is over in a few microseconds, so its ramp and its tail set
// the time as much as the bandwidth does:
//
//  * Wide loads, one wave.  Each thread issues kLoads 16-byte loads (2
//    int64 or 4 int32 keys each) before it hashes any, and writes its ids
//    with 16-byte stores.  The grid (ops.plan) is one wave of blocks that
//    are all resident at once; at the engine's shape every thread takes one
//    trip.  Keys before the first 16-byte boundary (a slice) and after the
//    last whole vector are taken one by one by warp 0 of block 0; the
//    wrapper lines the ids up with the keys, so both are 16-byte aligned in
//    between.
//  * A skew-proof histogram.  Each block counts in shared memory with one
//    plain atomic per key: Hopper's shared-memory atomic unit takes the
//    lanes of a warp that hit one address together, so a hot key group
//    (phase 3's airline keys put ~18 % of the tuples on one; all keys
//    equal, all) costs what spread ones do (chip_smoke.py times both).
//    Aggregating in the warp first only added time in development builds:
//    __match_any_sync costs a pass per distinct id in the warp, at 1000
//    key groups about as long as the loads; a ballot against one lane's id
//    cost more than it saved.
//  * A cluster flush.  The blocks of a cluster of kCluster sum each other's
//    histograms through distributed shared memory, each block one slice of
//    the buckets, and add the sums to the histogram in device memory: nkg
//    atomics per cluster, not per block.
//  * One launch.  Block 0 zeroes the histogram first and raises a `ready`
//    flag; blocks wait for it before their first atomic on the histogram
//    (in the shared body after their keys, so in practice never).  A `done`
//    count of arrivals lets the last cluster set both back to 0: the two
//    words live in a scratch buffer the wrapper keeps per (device,
//    stream).  No memset; the kernel's state is 0 again at its end, so a
//    captured graph can replay it.
//
// Above kMaxSmemBuckets the histogram does not fit in shared memory: the
// blocks wait for `ready` first and add into the histogram itself (no
// cluster), where a hot key group would serialize on one address: the
// lanes holding one id add once, together (__match_any_sync).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kMixC1 = 0x85EBCA6Bu;
constexpr uint32_t kMixC2 = 0xC2B2AE35u;
constexpr uint32_t kMask31 = 0x7FFFFFFFu;
constexpr uint32_t kNone = 0xFFFFFFFFu;  // a lane with no key
// ops.THREADS, ops.LOADS, ops.CLUSTER, ops.SMEM_MAX_BUCKETS.
constexpr int kThreads = 256;
constexpr int kLoads = 4;
constexpr int kCluster = 8;
constexpr uint32_t kMaxSmemBuckets = 51200;

// x % d for x < 2^31 as x - d * ((x * m) >> shift) (ops.magic).
struct Divisor {
  uint32_t d, m, shift;
};

template <typename K>
struct Vec16;
template <>
struct Vec16<long long> {
  using T = longlong2;
  static constexpr int kKeys = 2;
};
template <>
struct Vec16<int> {
  using T = int4;
  static constexpr int kKeys = 4;
};

// Key j of a 16-byte vector (j a compile-time constant after unrolling).
__device__ __forceinline__ long long key_at(const longlong2& v, int j) { return j ? v.y : v.x; }
__device__ __forceinline__ long long key_at(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= kMixC1;
  h ^= h >> 13;
  h *= kMixC2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t keygroup(long long key, const Divisor& dv) {
  // Sign-extended int32 keys and int64 keys alike: the two's-complement
  // uint64 view, folded.
  const uint64_t u = (uint64_t)key;
  const uint32_t x = mix32((uint32_t)(u ^ (u >> 32))) & kMask31;
  const uint32_t q = (uint32_t)(((uint64_t)x * dv.m) >> dv.shift);
  return x - q * dv.d;
}

// Count `kg` once (kNone counts nothing); every lane of the warp calls this
// together.  The shared body adds each lane's 1 itself: the card's
// shared-memory atomics take a warp's lanes on one address together, so a
// hot key group costs no more than spread ones.  Atomics in device memory
// do not: there the lanes holding one id elect their lowest
// (__match_any_sync), which adds how many they are.
template <bool kShared>
__device__ __forceinline__ void count(uint32_t kg, unsigned int* sh,
                                      unsigned long long* hist) {
  if constexpr (kShared) {
    if (kg != kNone) atomicAdd(&sh[kg], 1u);
  } else {
    const unsigned int peers = __match_any_sync(0xFFFFFFFFu, kg);
    if (kg != kNone && (threadIdx.x & 31) == (unsigned)(__ffs(peers) - 1))
      atomicAdd(&hist[kg], (unsigned long long)__popc(peers));
  }
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Block 0 zeroes the histogram and raises `ready`.
__device__ __forceinline__ void zero_hist(unsigned long long* hist, uint32_t nkg,
                                          unsigned int* ready) {
  for (uint32_t b = threadIdx.x; b < nkg; b += kThreads) hist[b] = 0ull;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicExch(ready, 1u);
}

// Thread 0 returns once `ready` is up; a barrier after it holds the rest.
__device__ __forceinline__ void wait_ready(const unsigned int* ready) {
  if (threadIdx.x == 0)
    while (load_acquire(ready) == 0u) {
    }
}

// keys[0, head) and the keys past the last whole 16-byte vector go one by
// one; keys + head and ids + head are 16-byte aligned.  sync: the scratch
// words `ready` and `done`.  drop_block: a block whose slice of its
// cluster's flush is left out (a planted fault for chip_smoke.py; -1 for
// none).
template <typename K, bool kShared>
__global__ void __launch_bounds__(kThreads, 4)
    keygroup_partition_kernel(const K* __restrict__ keys, long long n, int head, Divisor dv,
                              long long base, long long* __restrict__ ids,
                              unsigned long long* __restrict__ hist,
                              unsigned int* __restrict__ sync, int drop_block) {
  extern __shared__ unsigned int sh[];
  using V = typename Vec16<K>::T;
  constexpr int kV = Vec16<K>::kKeys;
  const uint32_t nkg = dv.d;
  const int lane = threadIdx.x & 31;
  unsigned int* ready = sync;
  unsigned int* done = sync + 1;
  if (blockIdx.x == 0) zero_hist(hist, nkg, ready);
  if constexpr (kShared) {
    for (uint32_t b = threadIdx.x; b < nkg; b += kThreads) sh[b] = 0u;
    __syncthreads();
  } else {
    wait_ready(ready);
    __syncthreads();
  }

  const long long nvec = (n - head) / kV;
  const long long tail0 = head + nvec * kV;
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    // The scalar edges: fewer than kV keys each side.
    const int tail = (int)(n - tail0);
    long long i = -1;
    if (lane < head)
      i = lane;
    else if (lane < head + tail)
      i = tail0 + (lane - head);
    uint32_t kg = kNone;
    if (i >= 0) {
      kg = keygroup((long long)keys[i], dv);
      ids[i] = base + kg;
    }
    count<kShared>(kg, sh, hist);
  }

  // The body: thread g takes vectors g, g + T, g + 2T, ... (T threads in
  // all), kLoads of them per trip, all loaded before any is hashed.  Trip
  // counts are per warp, so every lane reaches each warp vote of count().
  const V* __restrict__ vkeys = reinterpret_cast<const V*>(keys + head);
  long long* __restrict__ vids = ids + head;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long warp0 = (long long)blockIdx.x * kThreads + (threadIdx.x & ~31);
  for (long long v0 = warp0; v0 < nvec; v0 += kLoads * stride) {
    V r[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const long long v = v0 + lane + u * stride;
      if (v < nvec) r[u] = __ldcs(vkeys + v);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const long long v = v0 + lane + u * stride;
      const bool live = v < nvec;
      long long id[kV];
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const uint32_t kg = live ? keygroup(key_at(r[u], j), dv) : kNone;
        id[j] = base + kg;
        count<kShared>(kg, sh, hist);
      }
      if (live) {
        longlong2* dst = reinterpret_cast<longlong2*>(vids + v * kV);
#pragma unroll
        for (int j = 0; j < kV; j += 2) dst[j / 2] = make_longlong2(id[j], id[j + 1]);
      }
    }
  }

  // The arrivals that count towards `done`: clusters, or blocks.
  unsigned int arrivals = gridDim.x;
  if constexpr (kShared) {
    // Cluster flush: block `rank` sums bucket slice `rank` over the
    // cluster's shared histograms and adds each nonzero sum to hist.
    cg::cluster_group cluster = cg::this_cluster();
    wait_ready(ready);
    cluster.sync();
    const unsigned int rank = cluster.block_rank();
    const uint32_t per = (nkg + kCluster - 1) / kCluster;
    const uint32_t lo = rank * per, hi = min(nkg, lo + per);
    if ((int)blockIdx.x != drop_block) {
      for (uint32_t b = lo + threadIdx.x; b < hi; b += kThreads) {
        unsigned int c = 0;
#pragma unroll
        for (int q = 0; q < kCluster; ++q) c += cluster.map_shared_rank(sh, q)[b];
        if (c) atomicAdd(&hist[b], (unsigned long long)c);
      }
    }
    cluster.sync();  // no block leaves while a peer still reads its histogram
    if (rank != 0) return;
    arrivals /= kCluster;
  } else {
    __syncthreads();
  }
  // Every arrival has passed its wait for `ready`: the last sets both back.
  if (threadIdx.x == 0 && atomicAdd(done, 1u) == arrivals - 1) {
    *ready = 0u;
    *done = 0u;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename K>
cudaError_t launch(const void* keys, long long n, int head, Divisor dv, long long base, void* ids,
                   void* hist, void* sync, int blocks, int drop_block, cudaStream_t stream) {
  const K* k = (const K*)keys;
  long long* id = (long long*)ids;
  // Vectors start at key `head` (a head clamped to n leaves none).
  if (n - head >= Vec16<K>::kKeys && (!aligned16(k + head) || !aligned16(id + head)))
    return cudaErrorMisalignedAddress;
  if (dv.d > kMaxSmemBuckets) {
    keygroup_partition_kernel<K, false><<<blocks, kThreads, 0, stream>>>(
        k, n, head, dv, base, id, (unsigned long long*)hist, (unsigned int*)sync, drop_block);
    return cudaGetLastError();
  }
  if (blocks % kCluster != 0) return cudaErrorInvalidValue;
  auto kern = keygroup_partition_kernel<K, true>;
  const size_t smem = (size_t)dv.d * sizeof(unsigned int);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, k, n, head, dv, base, id, (unsigned long long*)hist,
                            (unsigned int*)sync, drop_block);
}

}  // namespace

// keys: n int32 (key_bytes = 4) or int64 (key_bytes = 8) keys on the card,
// the first `head` of them before a 16-byte boundary; ids: n int64 outputs
// with ids + head 16-byte aligned; hist: nkg int64 outputs; sync: two
// uint32 words of the wrapper's scratch, 0 before the launch and left 0
// after it; (magic_m, magic_shift): ops.magic(nkg);
// blocks: ops.plan (a multiple of the cluster size up to 51,200 key groups);
// drop_block: see the kernel (-1 for none).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int keygroup_partition_launch(const void* keys, int key_bytes, long long n, int head,
                                         int nkg, unsigned int magic_m, int magic_shift,
                                         long long base, void* ids, void* hist, void* sync,
                                         int blocks, int drop_block, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nkg < 1 || blocks < 1 || head < 0 || head > n) return (int)cudaErrorInvalidValue;
  const Divisor dv = {(uint32_t)nkg, magic_m, (uint32_t)magic_shift};
  if (key_bytes == 8)
    return (int)launch<long long>(keys, n, head, dv, base, ids, hist, sync, blocks, drop_block,
                                  s);
  if (key_bytes == 4)
    return (int)launch<int>(keys, n, head, dv, base, ids, hist, sync, blocks, drop_block, s);
  return (int)cudaErrorInvalidValue;
}
