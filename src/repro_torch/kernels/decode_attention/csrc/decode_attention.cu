// Single-token flash-decode attention over a KV cache with per-row lengths.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py
//   :: decode_attention_pallas (_kernel)
//
// q (B,1,H,hd), caches (B,T,KV,hd), kv_len (B,) int32 or int64, bf16 or f32;
// output (B,1,H,hd) in q's dtype.  A block holds all G = H/KV query heads
// of one KV group, as one Pallas grid cell does (decode_attention.py:
// 102-109), with the f32 online-softmax state (m, l, acc) of the Pallas
// kernel and its 1e-37 clamp of the denominator.  Keys at or past kv_len[b]
// are never read (the Pallas kernel's `pl.when(k_start < kv_len)` skip) or
// are masked inside the last tile.  A row with kv_len 0 writes 0.
//
// Bound on an H100: memory.  Each call must read the live K and V rows once,
// sum_b kv_len[b] * KV * hd * 2 * sizeof(T) bytes: 16.9 MB (5.0 us at 3.35
// TB/s) at GLM-4-9B's B=8, KV=2, hd=128, kv_len ~2,064; 67.4 MB (20 us) at
// Moonlight's B=4, KV=16, kv_len ~2,056; 16.8 MB at RecurrentGemma's ring,
// B=8, KV=1, hd=256, 2,048 slots.  One block per (b, KV head) would be 8-64
// blocks on 132 SMs, far too few to draw the card's bandwidth, so the keys
// are split (flash-decoding): `nsplit` blocks per (b, KV head) (ops.plan:
// at most one wave of one block per SM, and at most 80 KB of partials for
// the merge) each take an even share of the row's tiles of [0, kv_len).
// Each writes a partial (acc, m, l) in f32; the last of the nsplit blocks
// to finish merges them (acc_s * exp(m_s - M) summed over splits, divided
// by sum_s l_s * exp(m_s - M), M = max_s m_s) in the same launch: after a
// barrier, one thread of every block fences the partial (__threadfence)
// and takes a ticket from the (b, KV head)'s arrival counter (atomicAdd);
// the block that draws nsplit - 1 merges and sets the counter back to 0.
// The counters therefore start every call at 0 as long as calls that share
// them run one after another: the wrapper keeps one set per (device,
// stream).  A round trip to L2 costs ~1 us, so the merging block brings
// the partials into its shared memory in one batch of cp.async copies.
//
// Two bodies; ops.kernel_path(dtype, G, hd) picks one and passes it here:
//  * "mma", bf16, G <= 16, hd in {16, 32, 64, 128, 256} (the three models'
//    decode shapes: G = 16, 10 and 1): the group is the A operand of
//    `mma.sync.m16n8k16` -- G query rows padded to 16 -- read with
//    `ldmatrix` from shared memory.  Each of the block's 4 warps takes every
//    4th 16-key tile of the block's share and streams it through a ring of
//    3 stages of its own, fed by 16-byte `cp.async` (zero-filled past
//    kv_len), so the loads of its tiles t+1 and t+2 are in flight while tile
//    t computes, and no block-wide barrier is needed in the key loop.  S =
//    Q K^T takes K's rows through `ldmatrix` as the B operand; P (bf16, from
//    the S fragments' registers) times V takes V through `ldmatrix.trans`.
//    (m, l) and acc stay in f32 registers.  At G = 1 fifteen of the sixteen
//    rows are padding, which does not show: a 16-key tile's 32 products at
//    hd 128 take about a tenth of the time its 8 KB of K and V take to reach
//    an SM at its share of the card's bandwidth.  Q is loaded before the
//    rings start (behind them its loads queue for microseconds).  The warps'
//    states merge in shared memory at the end.
//  * "simt", anything else (f32; G > 16; other head dims): the f32 CUDA-core
//    tile body of ../../csrc/attention_tile.cuh (256 threads, 64-key tiles).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

#include "../../csrc/attention_tile.cuh"
#include "../../csrc/common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using kern::mma_bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 16;    // keys per warp tile: one k16 step of P V
constexpr int kStages = 3;   // ring depth per warp
constexpr int kRows = 16;    // query rows of the m16 tile (G <= 16)
constexpr float kLog2e = 1.4426950408889634f;

// Tiles [t0, t1) of split s: the row's ceil(len / tile) tiles dealt out as
// evenly as they go.
__device__ __forceinline__ void split_tiles(int len, int tile, int nsplit, int s, int& t0,
                                            int& t1) {
  const int n = (len + tile - 1) / tile;
  t0 = (int)((long long)n * s / nsplit);
  t1 = (int)((long long)n * (s + 1) / nsplit);
}

__device__ __forceinline__ int row_len(const void* kv_len, int len_bytes, int b, int t_cap) {
  const long long n = len_bytes == 8 ? reinterpret_cast<const long long*>(kv_len)[b]
                                     : reinterpret_cast<const int*>(kv_len)[b];
  return (int)max(0LL, min(n, (long long)t_cap));
}

// After a block has written its partial of a (row, KV head): the last of
// the nsplit blocks to arrive merges the partials acc [nsplit][rows][hd]
// and (m, l) [nsplit][rows][2] into o [rows][hd], weighting split s by
// exp(m_s - max m) (exp2 when the m are in the log2 domain), and resets
// the counter.  One thread fences and takes the ticket: a fence orders the
// writes the barrier before it made visible to that thread, so the block's
// whole partial precedes the ticket (and, in the merging block, follows
// the others' tickets).  The merge is latency-bound (a round trip to L2
// costs ~1 us on the H100 even when the card is idle), so the partials
// come into the block's free shared memory (`stage`, `stage_floats`) as
// many splits at a time as fit (one batch at the models' shapes), with
// back-to-back 16-byte cp.async; one thread per row computes the weights,
// and each output is then a plain weighted sum.  With drop_last (a planted
// fault for chip_smoke.py) the merging block leaves its own split out.
// Each thread owns at most MAXV float4 of the output.
template <typename T, bool LOG2, int MAXV>
__device__ void merge_if_last(const float* __restrict__ part_acc,
                              const float* __restrict__ part_ml, T* __restrict__ o, int rows,
                              int hd, int nsplit, int split, unsigned* counter, int drop_last,
                              float* stage, int stage_floats) {
  __shared__ int last;
  __syncthreads();  // the block's partial is written
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1u) == (unsigned)(nsplit - 1);
    if (last) {
      *counter = 0;  // every block has its ticket: ready for the next call
      __threadfence();
    }
  }
  __syncthreads();
  if (!last) return;
  const int nt = blockDim.x, n4 = rows * hd / 4;
  // Staged per split: acc, then (m, l); after the batch, each row's
  // weights, its max and the weighted sum of its l.
  const int per_split = rows * hd + 2 * rows;
  const int batch = max(1, (stage_floats - 2 * rows) / per_split);
  float a[MAXV][4] = {}, m_run[MAXV], l_run[MAXV] = {};
#pragma unroll
  for (int v = 0; v < MAXV; ++v) m_run[v] = -INFINITY;
  for (int s0 = 0; s0 < nsplit; s0 += batch) {
    const int nb = min(batch, nsplit - s0);
    float* st_ml = stage + nb * rows * hd;
    float* row_m = st_ml + 2 * nb * rows;
    float* row_l = row_m + rows;
    // acc of splits [s0, s0 + nb) is contiguous in global memory.
    const float* src = part_acc + (long long)s0 * rows * hd;
    for (int i = threadIdx.x; i < nb * n4; i += nt)
      kern::cp_async16(stage + 4 * i, src + 4 * i, true);
    kern::cp_async_commit();
    for (int i = threadIdx.x; i < 2 * nb * rows; i += nt)
      st_ml[i] = __ldcg(part_ml + 2LL * s0 * rows + i);
    kern::cp_async_wait<0>();
    __syncthreads();
    // Each row's weights within the batch: exp(m_s - M) over the batch's max M.
    for (int r = threadIdx.x; r < rows; r += nt) {
      float mx = -INFINITY;
      for (int u = 0; u < nb; ++u)
        if (!(drop_last && s0 + u == split)) mx = fmaxf(mx, st_ml[2 * (u * rows + r)]);
      const float m_use = mx == -INFINITY ? 0.f : mx;
      float l = 0.f;
      for (int u = 0; u < nb; ++u) {
        float* ml = st_ml + 2 * (u * rows + r);
        const float w = drop_last && s0 + u == split ? 0.f
                        : LOG2 ? exp2f(ml[0] - m_use) : expf(ml[0] - m_use);
        l = fmaf(ml[1], w, l);
        ml[0] = w;
      }
      row_m[r] = mx;
      row_l[r] = l;
    }
    __syncthreads();
#pragma unroll
    for (int v = 0; v < MAXV; ++v) {
      const int i = threadIdx.x + v * nt;
      if (i >= n4) break;
      const int r = i * 4 / hd;
      float b[4] = {0.f, 0.f, 0.f, 0.f};
      for (int u = 0; u < nb; ++u) {
        const float w = st_ml[2 * (u * rows + r)];
        const float4 x = *reinterpret_cast<const float4*>(stage + (u * n4 + i) * 4);
        b[0] = fmaf(x.x, w, b[0]);
        b[1] = fmaf(x.y, w, b[1]);
        b[2] = fmaf(x.z, w, b[2]);
        b[3] = fmaf(x.w, w, b[3]);
      }
      // Fold the batch into the running state (one batch: keep = 0, w = 1).
      const float m_new = fmaxf(m_run[v], row_m[r]);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float keep = LOG2 ? exp2f(m_run[v] - m_use) : expf(m_run[v] - m_use);
      const float w = LOG2 ? exp2f(row_m[r] - m_use) : expf(row_m[r] - m_use);
      m_run[v] = m_new;
      l_run[v] = fmaf(l_run[v], keep, row_l[r] * w);
#pragma unroll
      for (int e = 0; e < 4; ++e) a[v][e] = fmaf(a[v][e], keep, b[e] * w);
    }
    __syncthreads();  // the batch is consumed
  }
#pragma unroll
  for (int v = 0; v < MAXV; ++v) {
    const int i = threadIdx.x + v * nt;
    if (i >= n4) break;
    const float inv = 1.f / fmaxf(l_run[v], 1e-37f);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * i + e] = kern::from_f<T>(a[v][e] * inv);
  }
}

// ---------------------------------------------------------------- mma.sync
template <int HD>
struct MmaLayout {
  static constexpr int STR = HD + 8;  // shared row stride (bf16): ldmatrix rows hit distinct banks
  static constexpr int TILE = kKeys * STR;  // one K or V tile
  static constexpr int STAGE = 2 * TILE;    // K, then V
  static constexpr int WARP_RING = kStages * STAGE;
  static constexpr int RING_OFF = kRows * STR * 2;  // bytes: Q first
  static constexpr int RING_BYTES = kWarps * WARP_RING * 2;
  // After the key loop the ring's space holds the warps' (m, l, acc), their
  // merge weights and the block's (m, l).
  static constexpr int MERGE_FLOATS = kWarps * kRows * (HD + 3) + 2 * kRows;
  static constexpr int BYTES =
      RING_OFF + (RING_BYTES > 4 * MERGE_FLOATS ? RING_BYTES : 4 * MERGE_FLOATS);
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
    decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const void* __restrict__ kv_len, int len_bytes,
                      bf16* __restrict__ o, float* __restrict__ part_acc,
                      float* __restrict__ part_ml, unsigned* __restrict__ counters, int t_cap,
                      int h, int kv, float scale_log2, int drop_last) {
  using L = MmaLayout<HD>;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, nsplit = gridDim.x;
  const int g = h / kv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
  const int len = row_len(kv_len, len_bytes, b, t_cap);
  int t0, t1;
  split_tiles(len, kKeys, nsplit, split, t0, t1);
  const long long q_off = ((long long)b * h + (long long)kvh * g) * HD;
  const long long kv_rs = (long long)kv * HD;
  const bf16* kh = k + ((long long)b * t_cap * kv + kvh) * HD;
  const bf16* vh = v + ((long long)b * t_cap * kv + kvh) * HD;

  // Q's g rows first (zeros up to 16), into registers: issued after the
  // K/V prefetch, its loads would queue behind it.
  constexpr int kQVecs = kRows * (HD / 8), kQChunks = (kQVecs + kThreads - 1) / kThreads;
  uint4 qx[kQChunks];
#pragma unroll
  for (int j = 0; j < kQChunks; ++j) {
    const int c = threadIdx.x + j * kThreads, r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    qx[j] = r < g && c < kQVecs
                ? *reinterpret_cast<const uint4*>(q + q_off + (long long)r * HD + col)
                : make_uint4(0, 0, 0, 0);
  }

  // This warp's tiles t0 + warp + i * kWarps, i < n_mine, through its ring.
  bf16* ring = reinterpret_cast<bf16*>(smem + L::RING_OFF) + warp * L::WARP_RING;
  const int n_mine = t1 - t0 > warp ? (t1 - t0 - warp + kWarps - 1) / kWarps : 0;
  auto load = [&](int i) {
    if (i < n_mine) {
      const int j0 = (t0 + warp + i * kWarps) * kKeys;
      bf16* ks = ring + (i % kStages) * L::STAGE;
#pragma unroll
      for (int c = lane; c < kKeys * (HD / 8); c += 32) {
        const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
        const bool live = j0 + r < len;
        const long long off = (long long)(live ? j0 + r : j0) * kv_rs + col;
        kern::cp_async16(ks + r * L::STR + col, kh + off, live);
        kern::cp_async16(ks + L::TILE + r * L::STR + col, vh + off, live);
      }
    }
    kern::cp_async_commit();  // one group per tile slot, empty or not
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load(i);
#pragma unroll
  for (int j = 0; j < kQChunks; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < kQVecs)
      *reinterpret_cast<uint4*>(qs + c / (HD / 8) * L::STR + (c % (HD / 8)) * 8) = qx[j];
  }
  __syncthreads();

  // S and O fragments (m16n8 C layout): [..][0..1] row grp, [..][2..3] row
  // grp + 8; columns 2 tig + {0, 1} of each n8 tile.
  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int i = 0; i < n_mine; ++i) {
    __syncwarp();           // tile i - 1 is consumed: its stage refills
    load(i + kStages - 1);
    kern::cp_async_wait<kStages - 1>();  // this thread's copies of tile i
    __syncwarp();           // ... and every lane's
    const bf16* ks = ring + (i % kStages) * L::STAGE;
    const bf16* vs = ks + L::TILE;
    const int j0 = (t0 + warp + i * kWarps) * kKeys;

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4], kb[4];
      kern::ldmatrix_x4(a, qs + (lane & 15) * L::STR + kk * 16 + (lane >> 4) * 8);
      // Matrices: keys 0-7 at depth +0 / +8, then keys 8-15 at +0 / +8.
      kern::ldmatrix_x4(kb, ks + ((lane & 7) + ((lane >> 4) << 3)) * L::STR + kk * 16 +
                                ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], a, kb[0], kb[1]);
      mma_bf16(s[1], a, kb[2], kb[3]);
    }
    const bool edge = j0 + kKeys > len;
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * half + e];
          x = (!edge || j0 + n * 8 + 2 * tig + e < len) ? x * scale_log2 : -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[half], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[half] = exp2f(m_run[half] - m_use);
      m_run[half] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * half + e];
          x = exp2f(x - m_use);
          sum += x;
        }
      l_run[half] = l_run[half] * alpha[half] + sum;  // this thread's share of the row
    }
    // acc += P V: the two score n-tiles are one A fragment (16 keys).
    const uint32_t pa[4] = {kern::pack_bf16x2(s[0][0], s[0][1]),
                            kern::pack_bf16x2(s[0][2], s[0][3]),
                            kern::pack_bf16x2(s[1][0], s[1][1]),
                            kern::pack_bf16x2(s[1][2], s[1][3])};
#pragma unroll
    for (int d = 0; d < HD / 8; d += 2) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
      acc[d + 1][0] *= alpha[0];
      acc[d + 1][1] *= alpha[0];
      acc[d + 1][2] *= alpha[1];
      acc[d + 1][3] *= alpha[1];
      uint32_t vb[4];
      // Matrices: keys 0-7 / 8-15 of columns d*8.., then of (d+1)*8...
      kern::ldmatrix_x4_trans(vb, vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * L::STR + d * 8 +
                                      (lane >> 4) * 8);
      mma_bf16(acc[d], pa, vb[0], vb[1]);
      mma_bf16(acc[d + 1], pa, vb[2], vb[3]);
    }
  }
  kern::cp_async_wait<0>();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l_run[half] += __shfl_xor_sync(0xffffffffu, l_run[half], 1);
    l_run[half] += __shfl_xor_sync(0xffffffffu, l_run[half], 2);
  }

  // The warps' states, merged in shared memory (the rings are done).
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem + L::RING_OFF);  // [warp][row]
  float* wl = wm + kWarps * kRows;
  float* ww = wl + kWarps * kRows;                           // merge weights
  float* wacc = ww + kWarps * kRows;                         // [warp][row][HD]
  float* bm = wacc + kWarps * kRows * HD;                    // the block's (m, l)
  float* bl = bm + kRows;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = grp + 8 * half;
    if (r >= g) continue;
    if (tig == 0) {
      wm[warp * kRows + r] = m_run[half];
      wl[warp * kRows + r] = l_run[half];
    }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<float2*>(wacc + (warp * kRows + r) * HD + d * 8 + 2 * tig) =
          make_float2(acc[d][2 * half], acc[d][2 * half + 1]);
  }
  __syncthreads();
  if (threadIdx.x < g) {
    const int r = threadIdx.x;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * kRows + r]);
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float x = exp2f(wm[w * kRows + r] - m_use);
      ww[w * kRows + r] = x;
      l = fmaf(wl[w * kRows + r], x, l);
    }
    bm[r] = mx;
    bl[r] = l;
  }
  __syncthreads();
  const long long pair = (long long)b * kv + kvh;
  float* my_acc = part_acc + (pair * nsplit + split) * g * HD;
  for (int i = threadIdx.x; i < g * HD; i += kThreads) {
    const int r = i / HD, col = i % HD;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a = fmaf(wacc[(w * kRows + r) * HD + col], ww[w * kRows + r], a);
    if (nsplit == 1)
      o[q_off + i] = __float2bfloat16(a / fmaxf(bl[r], 1e-37f));
    else
      my_acc[i] = a;
  }
  if (nsplit == 1) return;
  if (threadIdx.x < g) {
    float* ml = part_ml + ((pair * nsplit + split) * g + threadIdx.x) * 2;
    ml[0] = bm[threadIdx.x];
    ml[1] = bl[threadIdx.x];
  }
  // The ring's shared memory stages the partials of the merge.
  merge_if_last<bf16, true, (HD >= 64 ? HD / 32 : 1)>(
      part_acc + pair * nsplit * g * HD, part_ml + pair * nsplit * g * 2, o + q_off, g, HD,
      nsplit, split, counters + pair, drop_last, reinterpret_cast<float*>(smem + L::RING_OFF),
      L::RING_BYTES / 4);
}

// ---------------------------------------------------------------- CUDA cores
struct KvLenMask {
  int len;
  __device__ bool operator()(int, int j) const { return j < len; }
};

template <typename T>
__global__ void __launch_bounds__(attn::kTileThreads)
    decode_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const void* __restrict__ kv_len, int len_bytes,
                       T* __restrict__ o, float* __restrict__ part_acc,
                       float* __restrict__ part_ml, unsigned* __restrict__ counters, int t_cap,
                       int h, int kv, int hd, float scale, int drop_last, int smem_floats) {
  extern __shared__ float smem_f[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, nsplit = gridDim.x;
  const int g = h / kv;
  const int len = row_len(kv_len, len_bytes, b, t_cap);
  int t0, t1;
  split_tiles(len, attn::kTileKeys, nsplit, split, t0, t1);
  const int begin = min(len, t0 * attn::kTileKeys), end = min(len, t1 * attn::kTileKeys);
  const long long q_off = ((long long)b * h + (long long)kvh * g) * hd;
  const long long kv_off = ((long long)b * t_cap * kv + kvh) * hd;
  const long long pair = (long long)b * kv + kvh;
  const bool merged = nsplit > 1;
  attn::tile_attention<T>(q + q_off, hd, g, k + kv_off, v + kv_off, (long long)kv * hd, begin,
                          end, o + q_off, hd, hd, scale, KvLenMask{len}, smem_f,
                          merged ? part_acc + (pair * nsplit + split) * g * hd : nullptr,
                          merged ? part_ml + (pair * nsplit + split) * g * 2 : nullptr);
  if (!merged) return;
  // G x hd <= 4,096 (ops.MAX_ACC): at most 4 float4 of the output a thread.
  merge_if_last<T, false, 4>(part_acc + pair * nsplit * g * hd, part_ml + pair * nsplit * g * 2,
                             o + q_off, g, hd, nsplit, split, counters + pair, drop_last, smem_f,
                             smem_floats);
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* kv_len,
                       int len_bytes, void* o, float* part_acc, float* part_ml,
                       unsigned* counters, int b, int t_cap, int h, int kv, int nsplit,
                       int drop_last, cudaStream_t s) {
  using L = MmaLayout<HD>;
  static unsigned long long sized = 0;  // devices whose attribute is set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(sized >> dev & 1)) {
    e = cudaFuncSetAttribute(decode_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::BYTES);
    if (e != cudaSuccess) return e;
    sized |= 1ULL << dev;
  }
  const float scale_log2 = (float)(1.0 / std::sqrt((double)HD)) * kLog2e;
  decode_mma_kernel<HD><<<dim3(nsplit, kv, b), kThreads, L::BYTES, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, kv_len, len_bytes, (bf16*)o, part_acc,
      part_ml, counters, t_cap, h, kv, scale_log2, drop_last);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simt(const void* q, const void* k, const void* v, const void* kv_len,
                        int len_bytes, void* o, float* part_acc, float* part_ml,
                        unsigned* counters, int b, int t_cap, int h, int kv, int hd, int nsplit,
                        int drop_last, cudaStream_t s) {
  const int g = h / kv;
  const size_t smem = attn::tile_smem_bytes(g, hd);
  cudaError_t e = cudaFuncSetAttribute(decode_simt_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const float scale = (float)(1.0 / std::sqrt((double)hd));
  decode_simt_kernel<T><<<dim3(nsplit, kv, b), attn::kTileThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_len, len_bytes, (T*)o, part_acc, part_ml,
      counters, t_cap, h, kv, hd, scale, drop_last, (int)(smem / sizeof(float)));
  return cudaGetLastError();
}

}  // namespace

// path: 0 = simt, 1 = mma (ops.kernel_path); dtype: 0 = float32, 1 =
// bfloat16; len_bytes: 4 or 8 (kv_len int32 or int64).  part: f32 scratch
// of B*KV*nsplit*G*(hd + 2) floats (the partials' acc, then their (m, l));
// counters: B*KV arrival counters, 0 on entry, left at 0 (unused when
// nsplit is 1).  drop_last: leave the merging block's own split out of
// every merge (a planted fault; 0 otherwise).  Returns the cudaError_t of
// the launch (cudaErrorInvalidValue for a path or shape the kernel does not
// take).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* kv_len, int len_bytes, void* o, void* part,
                                       void* counters, int b, int t_cap, int h, int kv, int hd,
                                       int nsplit, int dtype, int path, int drop_last,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (b == 0) return (int)cudaSuccess;
  if (nsplit < 1 || kv < 1 || h % kv != 0 ||
      (len_bytes != 4 && len_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const int g = h / kv;
  float* pa = (float*)part;
  float* pm = pa + (size_t)b * kv * nsplit * g * hd;
  unsigned* cnt = (unsigned*)counters;
  if (path == 1 && dtype == 1 && g <= kRows) {
    switch (hd) {
      case 16:
        return (int)launch_mma<16>(q, k, v, kv_len, len_bytes, o, pa, pm, cnt, b, t_cap, h, kv,
                                   nsplit, drop_last, s);
      case 32:
        return (int)launch_mma<32>(q, k, v, kv_len, len_bytes, o, pa, pm, cnt, b, t_cap, h, kv,
                                   nsplit, drop_last, s);
      case 64:
        return (int)launch_mma<64>(q, k, v, kv_len, len_bytes, o, pa, pm, cnt, b, t_cap, h, kv,
                                   nsplit, drop_last, s);
      case 128:
        return (int)launch_mma<128>(q, k, v, kv_len, len_bytes, o, pa, pm, cnt, b, t_cap, h, kv,
                                    nsplit, drop_last, s);
      case 256:
        return (int)launch_mma<256>(q, k, v, kv_len, len_bytes, o, pa, pm, cnt, b, t_cap, h, kv,
                                    nsplit, drop_last, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_simt<float>(q, k, v, kv_len, len_bytes, o, pa, pm, cnt, b, t_cap, h, kv,
                                   hd, nsplit, drop_last, s);
  if (dtype == 1)
    return (int)launch_simt<bf16>(q, k, v, kv_len, len_bytes, o, pa, pm, cnt, b, t_cap, h, kv, hd,
                                  nsplit, drop_last, s);
  return (int)cudaErrorInvalidValue;
}
