// Stable bucketed counting argsort of small-range integer codes.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/radix_sort/radix_sort.py
//   :: bucket_argsort_pallas (_hist_kernel, _rank_kernel, the rank->order
//      scatter at radix_sort.py:124)
//
// The input is cut into `nblocks` chunks of `chunk` consecutive codes, one
// CUDA block per chunk.  Two passes, with one exclusive scan between them
// that the Python wrapper runs as torch.cumsum glue (as the JAX package ran
// its scan in jnp outside the Pallas calls, radix_sort.py:103-106):
//
//  1. histogram: block b counts its chunk's codes into column b of a
//     bucket-major table, table[c * nblocks + b];
//  2. scan: the exclusive prefix sum of the flat bucket-major table is, at
//     [c * nblocks + b], the number of codes < c anywhere plus the number of
//     codes == c in chunks before b -- the first output rank of chunk b's
//     code-c elements;
//  3. rank: one warp per block walks its chunk in input order, 32 codes at a
//     time.  __match_any_sync groups the lanes holding equal codes; a lane's
//     rank is its slot's base plus the number of equal lanes below it
//     (__popc of the lower peer mask), and the lowest peer then bumps the
//     base by the group size.  The walk is in input order and chunks own
//     disjoint, ordered base ranges, so equal codes keep their input order:
//     stability comes from the design, not from the order blocks run in.
//     Each element writes order[rank] = i directly (int64).
//
// Codes must lie in [0, num_buckets); codes outside are skipped, leaving
// their output slots unwritten.
//
// Bound on an H100: memory.  Each code is read once (2 B int16 or 4 B
// int32) and each order entry written once (8 B): at n = 2^20 int16 codes,
// 10.5 MB, about 3.1 us at 3.35 TB/s.  This first version is far from it:
// the rank walk is one warp per chunk with a dependent read-modify-write of
// the base slot per 32 codes, so it is latency-bound, and the table
// (nblocks x num_buckets int32, kept to tens of MB by the wrapper) is
// zeroed, scanned and read once more.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHistThreads = 256;

template <typename C>
__global__ void radix_hist_kernel(const C* __restrict__ codes, int64_t n, int64_t chunk,
                                  int nblocks, int nb, int* __restrict__ table) {
  const int b = blockIdx.x;
  const int64_t a = (int64_t)b * chunk;
  const int64_t z = a + chunk < n ? a + chunk : n;
  for (int64_t i = a + threadIdx.x; i < z; i += blockDim.x) {
    const int c = (int)codes[i];
    if ((unsigned)c < (unsigned)nb) atomicAdd(&table[(int64_t)c * nblocks + b], 1);
  }
}

template <typename C>
__global__ void radix_rank_kernel(const C* __restrict__ codes, int64_t n, int64_t chunk,
                                  int nblocks, int nb, int* __restrict__ base,
                                  int64_t* __restrict__ order) {
  const int b = blockIdx.x;
  const unsigned lane = threadIdx.x;
  const unsigned lower = (1u << lane) - 1u;
  const int64_t a = (int64_t)b * chunk;
  const int64_t z = a + chunk < n ? a + chunk : n;
  for (int64_t i0 = a; i0 < z; i0 += 32) {
    const int64_t i = i0 + lane;
    int c = -1;
    if (i < z) {
      c = (int)codes[i];
      if ((unsigned)c >= (unsigned)nb) c = -1;
    }
    // Lanes past the chunk's end and out-of-range codes all carry -1:
    // they group only with each other and write nothing.
    const unsigned peers = __match_any_sync(0xffffffffu, c);
    int* slot = base + (int64_t)(c < 0 ? 0 : c) * nblocks + b;
    if (c >= 0) {
      const int r = *slot + __popc(peers & lower);
      order[r] = i;
    }
    __syncwarp();
    if (c >= 0 && lane == (unsigned)(__ffs(peers) - 1)) *slot += __popc(peers);
    __syncwarp();
  }
}

template <typename C>
cudaError_t hist(const void* codes, int64_t n, int64_t chunk, int nblocks, int nb,
                 void* table, cudaStream_t s) {
  radix_hist_kernel<C><<<nblocks, kHistThreads, 0, s>>>((const C*)codes, n, chunk,
                                                        nblocks, nb, (int*)table);
  return cudaGetLastError();
}

template <typename C>
cudaError_t rank(const void* codes, int64_t n, int64_t chunk, int nblocks, int nb,
                 void* base, void* order, cudaStream_t s) {
  radix_rank_kernel<C><<<nblocks, 32, 0, s>>>((const C*)codes, n, chunk, nblocks, nb,
                                              (int*)base, (int64_t*)order);
  return cudaGetLastError();
}

}  // namespace

// Pass 1.  table: nb * nblocks int32 on the card, zeroed here.
extern "C" int radix_sort_hist_launch(const void* codes, int code_bytes, long long n,
                                      long long chunk, int nblocks, int nb, void* table,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(table, 0, (size_t)nb * nblocks * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  if (code_bytes == 2) return (int)hist<int16_t>(codes, n, chunk, nblocks, nb, table, s);
  if (code_bytes == 4) return (int)hist<int32_t>(codes, n, chunk, nblocks, nb, table, s);
  return (int)cudaErrorInvalidValue;
}

// Pass 3.  base: the exclusive scan of the pass-1 table (consumed: the walk
// bumps it in place); order: n int64 outputs.
extern "C" int radix_sort_rank_launch(const void* codes, int code_bytes, long long n,
                                      long long chunk, int nblocks, int nb, void* base,
                                      void* order, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (code_bytes == 2)
    return (int)rank<int16_t>(codes, n, chunk, nblocks, nb, base, order, s);
  if (code_bytes == 4)
    return (int)rank<int32_t>(codes, n, chunk, nblocks, nb, base, order, s);
  return (int)cudaErrorInvalidValue;
}
