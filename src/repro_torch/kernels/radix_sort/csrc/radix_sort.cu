// Stable LSD radix argsort of small-range integer codes, in onesweep passes.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/radix_sort/radix_sort.py:69
//   :: bucket_argsort_pallas (_hist_kernel, _rank_kernel, the rank->order
//      scatter at radix_sort.py:124)
//
// The codes lie in [0, nb).  With bits = bit_length(nb - 1) they are sorted
// in `passes` least-significant-digit passes of `bits / passes` bits (at
// most 8, so at most 256 digits; ops.plan picks both).  Each pass is stable,
// so the passes together give exactly np.argsort(codes, kind="stable").
// One C call (radix_sort_launch) makes every launch of a sort:
//
//  (a) one cudaMemsetAsync of the head of the scratch buffer: every pass's
//      digit histogram, its look-back status words and its tile counter --
//      so a second sort on the stream starts from clean state;
//  (b) one histogram kernel: each block counts every pass's digits of its
//      codes in shared memory, then adds them to the global histograms with
//      one atomic per nonzero bin;
//  (c) one kernel per pass (Merrill & Garland's decoupled look-back, in
//      the one-sweep form of Adinets & Merrill 2022).  A block takes its
//      tile index from an atomic counter, so every earlier tile is already
//      running and the look-back always progresses.  Each warp owns a
//      contiguous run of the tile and walks it 32 codes at a time: a
//      ballot per digit bit groups the lanes of equal digit (the
//      __match_any_sync idiom, built from ballots), and a lane's rank is
//      the warp's running count of its digit plus the equal lanes below it.
//      The warps' counts are scanned in warp order in shared memory, so
//      ranks follow input order inside the tile.  The block publishes its
//      per-digit counts (flag "aggregate"), adds up earlier tiles' counts
//      back to the first inclusive prefix it meets, and publishes its own
//      inclusive prefix (flag "prefix"); a digit's global start is an
//      in-block scan of the pass's histogram.  The tile is reordered in
//      shared memory by digit and written out in runs: keys and int32
//      indices to ping-pong buffers, or, in the last pass, the int64 order.
//
// Status words are 64 bits: a 2-bit flag over a 62-bit count, each stored
// and read whole (relaxed gpu-scope atomics), so a prefix up to n < 2^31
// fits and a reader never sees a flag without its count.
//
// At the engine's n = 2^20 every tile of a pass is resident at once and
// publishes its counts at about the same moment, so a tile's walk passes
// aggregates all the way back to tile 0: the walks cost O(tiles^2) status
// reads, not the O(tiles) of a pass that runs in waves.  Hence large tiles
// -- 8,192 codes to a block of 512 threads, 128 tiles at 2^20, one per SM
// -- and a look-back that reads 16 earlier tiles' words at once.
//
// Codes outside [0, nb) are skipped: they count in no histogram and are
// written nowhere, so the in-range codes' order fills the first slots and
// the rest are left unwritten (as the first design did).
//
// Bound on an H100: memory.  Each code is read once and each order entry
// written once: at n = 2^20 int16 codes 10.5 MB, about 3.1 us at 3.35
// TB/s.  This design moves about 24 MB there in four launches (codes read
// twice, one ping-pong round trip of keys and indices, the order); the
// look-back and the match-based ranking keep every pass one read and one
// write of its data, where the first design's bucket-major table moved
// about 134 MB.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 512;                  // a pass kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                     // codes per lane per tile
constexpr int kRun = 32 * kItems;              // codes per warp per tile
constexpr int kTile = kThreads * kItems;       // 8192: 2^20 codes in 128 tiles, one per SM
constexpr int kHistThreads = 256;
constexpr int kRadix = 256;                    // most digits a pass has
constexpr int kMaxPasses = 4;                  // 31 bits in passes of <= 8
constexpr int kHistBlocksPerSm = 2;
constexpr int kHistItems = 16;                 // codes a thread loads at once

constexpr int kLookBack = 16;                  // status words read at once

constexpr uint64_t kAggregate = 1ull << 62;
constexpr uint64_t kPrefix = 2ull << 62;
constexpr uint64_t kCountMask = kAggregate - 1;

// Scratch layout (bytes); ops.scratch_bytes computes the same total.
constexpr size_t kHistBytes = (size_t)kMaxPasses * kRadix * 4;
constexpr size_t kCounterOff = kHistBytes;
constexpr size_t kStatusOff = kCounterOff + 256;

size_t align256(size_t b) { return (b + 255) & ~(size_t)255; }

// A status word carries its own count, and no other data is published
// through it, so relaxed gpu-scope atomics suffice: a reader sees the whole
// word or an older one, never a flag without its count.  (Acquire loads
// would order, and so serialize, the look-back's batched reads.)
__device__ __forceinline__ void store_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// The sum of digit d's counts in tiles before `tile`: walk back over their
// status words, kLookBack at a time (independent loads, one round trip to
// L2), adding aggregates until the first inclusive prefix; spin on a word
// not yet published.  Tile 0 always publishes a prefix, so the walk ends.
__device__ __forceinline__ uint64_t look_back(const uint64_t* status, int64_t tile, int d) {
  uint64_t before = 0;
  for (int64_t t = tile - 1;; t -= kLookBack) {
    uint64_t w[kLookBack];
#pragma unroll
    for (int q = 0; q < kLookBack; ++q)
      w[q] = t - q >= 0 ? load_status(status + (size_t)(t - q) * kRadix + d) : kPrefix;
#pragma unroll
    for (int q = 0; q < kLookBack; ++q) {
      uint64_t s = w[q];
      while ((s & ~kCountMask) == 0) s = load_status(status + (size_t)(t - q) * kRadix + d);
      before += s & kCountMask;
      if ((s & ~kCountMask) == kPrefix) return before;
    }
  }
}

// The lanes of the warp whose digit equals this lane's (-1 marks a lane
// with none): one ballot per digit bit, as CUB's MatchAny does -- the
// hardware's __match_any_sync is far slower on a warp of many distinct
// digits.  `bits` is the same in every lane.
__device__ __forceinline__ unsigned match_digit(int dig, int bits) {
  unsigned peers = __ballot_sync(0xffffffffu, dig >= 0);
  if (dig < 0) peers = ~peers;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if (b < bits) {
      const bool set = (dig >> b) & 1;
      const unsigned vote = __ballot_sync(0xffffffffu, set);
      peers &= set ? vote : ~vote;
    }
  }
  return peers;
}

// Exclusive scan of one value per thread over the block (kThreads); the
// block's total in *total.  Every thread calls it; it syncs the block.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* s_warp_sums,
                                                         uint32_t* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp_sums[warp] = x;
  __syncthreads();
  uint32_t before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t s = s_warp_sums[w];
    before += w < warp ? s : 0;
    all += s;
  }
  __syncthreads();  // s_warp_sums may be reused
  *total = all;
  return before + x - v;
}

// (b) Every pass's digit histogram of the in-range codes.
template <typename C>
__global__ void __launch_bounds__(kHistThreads)
    radix_hist_kernel(const C* __restrict__ codes, int64_t n, int nb, int passes, int bits,
                      uint32_t* __restrict__ hist) {
  __shared__ uint32_t s_hist[kMaxPasses * kRadix];
  for (int i = threadIdx.x; i < kMaxPasses * kRadix; i += kHistThreads) s_hist[i] = 0;
  __syncthreads();
  const uint32_t mask = (1u << bits) - 1u;
  // kHistItems loads in flight per thread before its atomics.
  const int64_t chunk = (int64_t)kHistThreads * kHistItems;
  for (int64_t base = (int64_t)blockIdx.x * chunk; base < n; base += (int64_t)gridDim.x * chunk) {
    int c[kHistItems];
#pragma unroll
    for (int j = 0; j < kHistItems; ++j) {
      const int64_t i = base + j * kHistThreads + threadIdx.x;
      c[j] = i < n ? (int)codes[i] : -1;
    }
#pragma unroll
    for (int j = 0; j < kHistItems; ++j) {
      if ((unsigned)c[j] >= (unsigned)nb) continue;
      for (int p = 0; p < passes; ++p)
        atomicAdd(&s_hist[p * kRadix + (((unsigned)c[j] >> (p * bits)) & mask)], 1u);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * kRadix; i += kHistThreads)
    if (s_hist[i] != 0) atomicAdd(&hist[i], s_hist[i]);
}

// (c) One stable counting pass over digit (key >> shift) & mask.  FIRST:
// keys are the codes (range-checked against nb) and indices their
// positions; LAST: write only order.
template <typename C, bool FIRST, bool LAST>
__global__ void __launch_bounds__(kThreads, 1)
    radix_pass_kernel(const C* __restrict__ keys_in, const uint32_t* __restrict__ idx_in,
                      C* __restrict__ keys_out, uint32_t* __restrict__ idx_out,
                      int64_t* __restrict__ order, const uint32_t* __restrict__ hist,
                      uint64_t* __restrict__ status, uint32_t* __restrict__ counter, int64_t n,
                      int nb, int shift, int bits) {
  __shared__ uint16_t s_warp[kWarps][kRadix];  // per-warp digit counts -> their warp prefix
  __shared__ uint32_t s_start[kRadix];         // digit's global start (the pass's histogram)
  __shared__ uint32_t s_base[kRadix];          // global position minus tile-local position
  __shared__ uint32_t s_local[kRadix];         // digit's first tile-local position
  __shared__ uint32_t s_sums[kWarps];
  __shared__ uint32_t s_tile;
  extern __shared__ uint4 s_dyn[];             // the reordered tile: indices, then keys
  uint32_t* s_idx = reinterpret_cast<uint32_t*>(s_dyn);
  C* s_keys = reinterpret_cast<C*>(s_idx + kTile);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int radix = 1 << bits;
  const uint32_t mask = (uint32_t)radix - 1u;
  if (tid == 0) s_tile = atomicAdd(counter, 1u);
  for (int i = tid; i < kWarps * kRadix; i += kThreads) (&s_warp[0][0])[i] = 0;
  uint32_t valid;  // in-range codes in all: the histogram's total
  const uint32_t start = block_exclusive_scan(tid < radix ? hist[tid] : 0u, s_sums, &valid);
  if (tid < kRadix) s_start[tid] = start;
  const uint32_t tile = s_tile;  // read after the scan's syncs

  // Load: warp w holds codes [w * kRun, (w + 1) * kRun) of the tile, lane
  // l the ones at l + 32 j.  A digit of -1 marks a slot with nothing.
  const int64_t limit = FIRST ? n : (int64_t)valid;
  const int64_t run0 = (int64_t)tile * kTile + warp * kRun;
  C key[kItems];
  uint32_t idx[kItems];
  int dig[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = run0 + j * 32 + lane;
    dig[j] = -1;
    key[j] = 0;
    idx[j] = 0;
    if (i < limit) {
      key[j] = keys_in[i];
      idx[j] = FIRST ? (uint32_t)i : idx_in[i];
      if (!FIRST || (unsigned)(int)key[j] < (unsigned)nb)
        dig[j] = (int)(((uint32_t)(int)key[j] >> shift) & mask);
    }
  }

  // Rank inside the warp, in input order.
  uint32_t rank[kItems];
  uint16_t* counts = s_warp[warp];
  const uint32_t lower = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const unsigned peers = match_digit(dig[j], bits);
    const bool leader = lane == __ffs(peers) - 1;
    uint32_t before = 0;
    if (dig[j] >= 0) before = counts[dig[j]];
    __syncwarp();
    if (dig[j] >= 0 && leader) counts[dig[j]] = (uint16_t)(before + __popc(peers));
    __syncwarp();
    rank[j] = before + __popc(peers & lower);
  }
  __syncthreads();

  // Per digit: the warps' counts -> their exclusive prefix in warp order,
  // and the tile's count.
  uint32_t count = 0;
  if (tid < radix) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = s_warp[w][tid];
      s_warp[w][tid] = (uint16_t)count;
      count += c;
    }
  }
  uint32_t in_tile;
  const uint32_t local = block_exclusive_scan(count, s_sums, &in_tile);

  // Publish the tile's per-digit counts at once (tile 0's are already its
  // inclusive prefix), so that later tiles' look-backs find them early.
  uint64_t* mine = status + (size_t)tile * kRadix + tid;
  if (tid < radix) {
    store_status(mine, (tile == 0 ? kPrefix : kAggregate) | count);
    s_local[tid] = local;
  }
  __syncthreads();

  // Reorder the tile by digit in shared memory (which frees the registers
  // for the look-back) ...
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (dig[j] < 0) continue;
    const uint32_t p = s_local[dig[j]] + s_warp[warp][dig[j]] + rank[j];
    s_keys[p] = key[j];
    s_idx[p] = idx[j];
  }

  // ... find each digit's count in earlier tiles ...
  if (tid < radix) {
    uint64_t before = 0;
    if (tile > 0) {
      before = look_back(status, tile, tid);
      store_status(mine, kPrefix | (before + count));
    }
    s_base[tid] = s_start[tid] + (uint32_t)before - local;
  }
  __syncthreads();
  // ... and write it out: each digit's run lands on consecutive slots.
  for (uint32_t p = tid; p < in_tile; p += kThreads) {
    const C k = s_keys[p];
    const uint32_t g = s_base[((uint32_t)(int)k >> shift) & mask] + p;
    if (LAST) {
      order[g] = (int64_t)s_idx[p];
    } else {
      keys_out[g] = k;
      idx_out[g] = s_idx[p];
    }
  }
}

template <typename C, bool FIRST, bool LAST>
cudaError_t pass(const void* keys_in, const uint32_t* idx_in, void* keys_out, uint32_t* idx_out,
                 int64_t* order, const uint32_t* hist, uint64_t* status, uint32_t* counter,
                 int64_t n, int tiles, int nb, int shift, int bits, cudaStream_t s) {
  // The reordered tile (64 KB of int32 keys and indices) passes the 48 KB
  // a block gets unasked.
  constexpr int smem = kTile * (4 + sizeof(C));
  cudaError_t e = cudaFuncSetAttribute(radix_pass_kernel<C, FIRST, LAST>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  radix_pass_kernel<C, FIRST, LAST><<<tiles, kThreads, smem, s>>>(
      (const C*)keys_in, idx_in, (C*)keys_out, idx_out, order, hist, status, counter, n, nb,
      shift, bits);
  return cudaGetLastError();
}

template <typename C>
cudaError_t sort(const void* codes, int64_t n, int nb, int passes, int bits, uint8_t* scratch,
                 size_t scratch_bytes, int64_t* order, cudaStream_t s) {
  const int tiles = (int)((n + kTile - 1) / kTile);
  const size_t status_bytes = (size_t)passes * tiles * kRadix * 8;
  const size_t keys_off = align256(kStatusOff + status_bytes);
  const int buffers = passes > 2 ? 2 : passes - 1;  // ping-pong key/index buffers
  const size_t key_bytes = align256((size_t)n * sizeof(C));
  const size_t idx_bytes = align256((size_t)n * 4);
  const size_t idx_off = keys_off + buffers * key_bytes;
  if (scratch_bytes < idx_off + buffers * idx_bytes) return cudaErrorInvalidValue;

  uint32_t* hist = (uint32_t*)scratch;
  uint32_t* counters = (uint32_t*)(scratch + kCounterOff);
  uint64_t* status = (uint64_t*)(scratch + kStatusOff);
  cudaError_t e = cudaMemsetAsync(scratch, 0, kStatusOff + status_bytes, s);
  if (e != cudaSuccess) return e;

  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const int64_t want =
      (n + (int64_t)kHistThreads * kHistItems - 1) / ((int64_t)kHistThreads * kHistItems);
  const int hist_blocks = (int)std::min<int64_t>(want, (int64_t)sms * kHistBlocksPerSm);
  radix_hist_kernel<C><<<hist_blocks, kHistThreads, 0, s>>>((const C*)codes, n, nb, passes,
                                                            bits, hist);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  for (int p = 0; p < passes; ++p) {
    const void* kin = p == 0 ? codes : scratch + keys_off + ((p - 1) % 2) * key_bytes;
    const uint32_t* iin =
        p == 0 ? nullptr : (const uint32_t*)(scratch + idx_off + ((p - 1) % 2) * idx_bytes);
    void* kout = scratch + keys_off + (p % 2) * key_bytes;
    uint32_t* iout = (uint32_t*)(scratch + idx_off + (p % 2) * idx_bytes);
    const uint32_t* h = hist + p * kRadix;
    uint64_t* st = status + (size_t)p * tiles * kRadix;
    uint32_t* ctr = counters + p;
    const bool first = p == 0, last = p == passes - 1;
    if (first && last)
      e = pass<C, true, true>(kin, iin, kout, iout, order, h, st, ctr, n, tiles, nb, 0, bits, s);
    else if (first)
      e = pass<C, true, false>(kin, iin, kout, iout, order, h, st, ctr, n, tiles, nb, 0, bits, s);
    else if (last)
      e = pass<C, false, true>(kin, iin, kout, iout, order, h, st, ctr, n, tiles, nb, p * bits,
                               bits, s);
    else
      e = pass<C, false, false>(kin, iin, kout, iout, order, h, st, ctr, n, tiles, nb, p * bits,
                                bits, s);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// Sorts n codes (int16 or int32, code_bytes 2 or 4) in [0, nb) in `passes`
// passes of `bits` bits (1 <= passes <= 4, passes * bits <= 32, bits <= 8),
// writing the n int64 entries of order.  scratch: scratch_bytes on the card
// (ops.scratch_bytes).  Returns the first failing cudaError_t.
extern "C" int radix_sort_launch(const void* codes, int code_bytes, long long n, int nb,
                                 int passes, int bits, void* scratch, long long scratch_bytes,
                                 void* order, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || n >= (1ll << 31) || passes < 1 || passes > kMaxPasses || bits < 1 || bits > 8)
    return (int)cudaErrorInvalidValue;
  if (code_bytes == 2)
    return (int)sort<int16_t>(codes, n, nb, passes, bits, (uint8_t*)scratch,
                              (size_t)scratch_bytes, (int64_t*)order, s);
  if (code_bytes == 4)
    return (int)sort<int32_t>(codes, n, nb, passes, bits, (uint8_t*)scratch,
                              (size_t)scratch_bytes, (int64_t*)order, s);
  return (int)cudaErrorInvalidValue;
}
