// Causal / sliding-window GQA flash attention (forward).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py
//   :: flash_attention_pallas (_kernel)
//
// q (B,S,H,hd), k/v (B,T,KV,hd), bf16 or f32; output (B,S,H,hd) in q's
// dtype.  Query head h reads KV head h / (H/KV) (flash_attention.py:145);
// query i attends to key j when j < T, j <= i (causal) and j > i - window
// (window); scale 1/sqrt(hd); f32 online softmax (m, l, acc); denominator
// clamped at 1e-37 (a row whose keys are all masked writes 0).
//
// A block's loop over KV tiles takes the place of the TPU's sequential
// innermost grid dimension (flash_attention.py:143).  KV tiles that lie
// wholly above the causal diagonal or wholly outside the window are never
// loaded, as the Pallas kernel's `pl.when` skips them
// (flash_attention.py:99-103).  S and T need not be multiples of the tile:
// the ragged edge is masked.
//
// Three bodies; ops.kernel_path(dtype, hd) picks one and passes it here:
//  * "wgmma", bf16 at hd 64, 128 and 256 (every model config's head dim
//    that the wrapper takes): Hopper's warpgroup products on a ring of K/V
//    tiles that TMA brings into shared memory (FlashAttention-3's forward,
//    written for this repo).  A work item is 128 query rows of one (head,
//    batch row).  A block of 384 threads has one producer warpgroup, whose
//    one thread issues the TMA copies (K(0), Q, then K(t+1) before V(t),
//    into `stages` slots with a "full" and an "empty" mbarrier each for K
//    and for V, so that a K slot refills as soon as S is done with it), and
//    two consumer warpgroups of 64 rows that share every K/V tile.
//    setmaxnreg moves registers from the producer (24) to the consumers
//    (240), whose O, S and P do not fit the 168 a thread that 384 threads
//    get at launch (at 168, ptxas spilled and serialized the wgmma).
//    Each consumer issues S(t) = Q K(t)^T beside P(t-1) V(t-1) and runs the
//    softmax of tile t while that product runs (FlashAttention-3's
//    intra-warpgroup overlap), and the two consumers take turns to issue
//    (ping-pong), so that one's softmax overlaps the other's products.  S = Q K^T is a wgmma with both operands in shared memory,
//    K-major (K's natural (keys, hd) rows).  O += P V takes P from
//    registers -- the S accumulator packed to bf16 is already wgmma's A
//    fragment -- and V from shared memory as an MN-major operand (the
//    transpose bit), so no transposed copy of V is made.  The tensor maps
//    are rank 4 (hd, heads, seq, batch): a ragged S or T edge reads zeros
//    from inside its own batch row, and the j < T mask still applies to
//    those zero keys.  Masks are computed only on tiles that cross the
//    diagonal, the window's edge or T; other tiles skip the arithmetic.
//    The output goes back through the Q tile's shared memory and a TMA
//    store, which clips the ragged S edge.  The kernel is persistent: one
//    block per SM walks the work items, the longest causal q tiles first,
//    so the next item's loads overlap this one's last products and store.
//  * "mma", bf16 at hd 16 and 32 (the SMOKE configs): `mma.sync.m16n8k16`,
//    one block per (64-row q tile, head, batch row), 4 warps, each 64-key
//    K/V tile staged in shared memory with 16-byte loads.
//  * "simt", anything else (f32; other multiples of 8): the f32 CUDA-core
//    body of ../../csrc/attention_tile.cuh, 16 query rows per block, which
//    keeps the Pallas kernel's all-f32 arithmetic.
// Both bf16 bodies give Q K^T exactly (bf16 products are exact in f32) with
// f32 sums, and round P to bf16 for P V (relative error <= 2^-9 per
// weight) where the Pallas kernel keeps it in f32: within the bf16
// tolerance (atol = rtol = 3e-2) the tests and chip_smoke.py hold it to.
//
// Bound on an H100: operations.  Causal attention at B=8, S=T=2048, H=32,
// hd=128 does about 4*B*H*S^2*hd/2 = 2.75e11 FLOP, 0.278 ms at 989 TFLOP/s
// (bf16 dense), against 0.085 ms for its 285 MB of q/k/v/o at 3.35 TB/s.
// The wgmma body reaches about 54 % of that bound (PERF.md); the softmax
// between the products, the masks of the diagonal tiles and, at hd 256,
// registers that spill are what remains.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <initializer_list>

#include "../../csrc/attention_tile.cuh"
#include "../../csrc/hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;  // mma.sync: query rows per block (16 per warp)
constexpr int kBK = 64;  // mma.sync: keys per tile
constexpr int kWarps = 4;
constexpr int kSimtRows = 16;
constexpr float kLog2e = 1.4426950408889634f;

using kern::mma_bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 p;
  p.x = lo;
  p.y = hi;
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ bool attends(int i, int j, int t_len, int causal, int window) {
  return j < t_len && (!causal || j <= i) && (window <= 0 || j > i - window);
}

// Keys [j_begin, j_end) that query rows [q0, q0 + rows) can see, j_begin
// rounded down to a multiple of `tile`.
__device__ __forceinline__ void key_range(int q0, int rows, int t_len, int causal, int window,
                                          int tile, int& j_begin, int& j_end) {
  j_end = causal ? min(t_len, q0 + rows) : t_len;
  j_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  j_begin = (j_begin / tile) * tile;
}

// ---------------------------------------------------------------- wgmma
constexpr int kWgRows = 64;               // query rows per consumer warpgroup
constexpr int kWgBQ = 2 * kWgRows;        // query rows per block
constexpr int kWgThreads = 3 * 128;       // producer + two consumer warpgroups
// An SM sub-partition holds 3 of the block's 12 warps in 16,384 registers:
// 168 a thread at launch, or 24 for the producer and 240 for the consumers.
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kBoxCols = 64;              // bf16 per TMA box row: the 128-byte swizzle
constexpr int kRowBytes = kBoxCols * 2;

// Keys per K/V tile, and slots in the ring.  Shared memory is Q (128 x hd)
// + 2 x (K + V) (BK x hd each) in bf16: 80 KB at hd 64, 160 KB at hd 128,
// 192 KB at hd 256 (a third slot there would pass the 227 KB a block can
// have; at hd 128 it measured slower).
constexpr int kStages = 2;
template <int HD>
constexpr int kWgKeys = HD == 256 ? 64 : 128;

template <int HD>
struct WgLayout {
  static constexpr int BK = kWgKeys<HD>, STAGES = kStages;
  static constexpr int NB = HD / kBoxCols;              // boxes across a row
  static constexpr int Q_BOX = kWgRows * kRowBytes;     // one Q (or O) box: 8 KB
  static constexpr int KV_BOX = BK * kRowBytes;         // one K or V box
  static constexpr int Q_WG = NB * Q_BOX;               // a consumer's Q rows
  static constexpr int KV_TILE = NB * KV_BOX;           // one K or V tile
  static constexpr int K_OFF = 2 * Q_WG;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_TILE;
  // K full, V full, K empty, V empty per slot, then Q full and empty per
  // consumer.
  static constexpr int BYTES = BAR_OFF + (4 * STAGES + 4) * 8 + 1024;  // + alignment slack
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online-softmax step for a consumer thread's two rows (r0 and
// r0 + 8): mask (on edge tiles only), new running max, scores -> exp2 in
// place, running sum; returns each row's rescale factor for O in alpha.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2], int r0,
                                             int c, int j0, bool edge, int t_len, int causal,
                                             int window, float scale_log2) {
  if (edge) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (!attends(r0 + 8 * half, j0 + 8 * n + 2 * c + e, t_len, causal, window))
            sc[4 * n + 2 * half + e] = -INFINITY;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
      mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * half], sc[4 * n + 2 * half + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[half], mx * scale_log2);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    alpha[half] = ex2(m_run[half] - m_use);
    m_run[half] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * n + 2 * half + e];
        x = ex2(fmaf(x, scale_log2, -m_use));
        sum += x;
      }
    l_run[half] = l_run[half] * alpha[half] + sum;  // this thread's share of the row
  }
}

// One unit of a block's work: 128 query rows of one (head, batch row) and
// the run of BK-key tiles they see.
struct WgWork {
  int q0, head, b, j_begin, n_tiles;
};

// The work item of a block's r-th round over `grid` blocks: a snake order
// (blocks 0..grid-1 on even rounds, grid-1..0 on odd ones), which evens
// out the blocks' sums of the decreasing item lengths.
__device__ __forceinline__ int wg_item(int r, int grid, int block) {
  return r * grid + ((r & 1) ? grid - 1 - block : block);
}

// Work item w, the longest causal q tiles first: q tile nq - 1 - w / (h B),
// then heads (neighbouring heads share a KV head in L2), then batch rows.
template <int BK>
__device__ __forceinline__ WgWork wg_work(int w, int nq, int h, int batch, int t_len,
                                          int causal, int window) {
  WgWork k;
  const int hb = h * batch;
  k.q0 = (nq - 1 - w / hb) * kWgBQ;
  k.head = w % h;
  k.b = (w % hb) / h;
  int j_end;
  key_range(k.q0, kWgBQ, t_len, causal, window, BK, k.j_begin, j_end);
  k.n_tiles = j_end > k.j_begin ? (j_end - k.j_begin + BK - 1) / BK : 0;
  return k;
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o, int s_len, int t_len, int h,
                       int kv, int batch, int causal, int window, float scale_log2) {
  using L = WgLayout<HD>;
  constexpr int BK = L::BK, STAGES = L::STAGES, NB = L::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;
  uint64_t* q_full = v_empty + STAGES;  // one per consumer
  uint64_t* q_empty = q_full + 2;       // one per consumer: its O has left
  const int nq = (s_len + kWgBQ - 1) / kWgBQ;
  const int n_work = nq * h * batch;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 2 * 128);  // every consumer thread arrives
      hopper::mbar_init(&v_empty[s], 2 * 128);
    }
    for (int w = 0; w < 2; ++w) {
      hopper::mbar_init(&q_full[w], 1);
      hopper::mbar_init(&q_empty[w], 1);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // Persistent: each block takes one work item a round (wg_item); the K/V ring's
  // slots and phases run on across items (`it` counts its tiles), so the
  // next item's first loads overlap this one's last products and output.
  // Warp-uniform (a shuffle from lane 0), as setmaxnreg needs.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full, in the order the
    // consumers take the tiles: K(0), Q, then K(t+1) before V(t).
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0, n = 0;
      for (int w; (w = wg_item(n, gridDim.x, blockIdx.x)) < n_work; ++n) {
        const WgWork k = wg_work<BK>(w, nq, h, batch, t_len, causal, window);
        const int kvh = k.head / (h / kv);
        auto load = [&](const CUtensorMap* map, int off, uint64_t* full, uint64_t* empty,
                        int t) {
          const int s = (it + t) % STAGES;
          hopper::mbar_wait(&empty[s], (((it + t) / STAGES) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], L::KV_TILE);
          for (int bx = 0; bx < NB; ++bx)
            hopper::tma_load_4d(smem + off + s * L::KV_TILE + bx * L::KV_BOX, map, &full[s],
                                bx * kBoxCols, kvh, k.j_begin + t * BK, k.b);
        };
        if (k.n_tiles > 0) load(&tm_k, L::K_OFF, k_full, k_empty, 0);
        for (int cw = 0; cw < 2; ++cw) {
          hopper::mbar_wait(&q_empty[cw], (n & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&q_full[cw], L::Q_WG);
          for (int bx = 0; bx < NB; ++bx)
            hopper::tma_load_4d(smem + cw * L::Q_WG + bx * L::Q_BOX, &tm_q, &q_full[cw],
                                bx * kBoxCols, k.head, k.q0 + cw * kWgRows, k.b);
        }
        for (int t = 0; t < k.n_tiles; ++t) {
          if (t + 1 < k.n_tiles) load(&tm_k, L::K_OFF, k_full, k_empty, t + 1);
          load(&tm_v, L::V_OFF, v_full, v_empty, t);
        }
        it += k.n_tiles;
      }
    }
  } else {
    // ---- consumers: 64 query rows each.
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
    uint8_t* qs = smem + cw * L::Q_WG;
    const uint32_t q_addr = hopper::smem_u32(qs);

    // Ping-pong: each consumer issues its products (S(t) and P(t-1) V(t-1))
    // only in its turn -- named barrier 3 + cw, which the other consumer
    // arrives on once it has issued its own -- so that one's softmax runs
    // while the other's products keep the tensor cores busy.  Both take
    // n_tiles + 1 turns per item, idle ones where a tile is not theirs; the
    // second starts by handing the first turn over and skips its last
    // hand-over.
    int turns = 0;
    for (int r = 0, w; (w = wg_item(r, gridDim.x, blockIdx.x)) < n_work; ++r)
      turns += wg_work<BK>(w, nq, h, batch, t_len, causal, window).n_tiles + 1;
    auto turn_wait = [&]() { hopper::bar_sync(3 + cw, 256); };
    auto turn_pass = [&]() {
      if (--turns > 0 || cw == 0) hopper::bar_arrive(3 + (1 - cw), 256);
    };
    if (cw == 1) hopper::bar_arrive(3, 256);

    // Accumulator fragments (wgmma's D layout): entry 4n + 2*half + e holds
    // row r0 + 8*half, column 8n + 2c + e.
    float o[HD / 2];
    float m_run[2], l_run[2], alpha[2];
    float sc[BK / 2];
    uint32_t p[BK / 16][4];

    int it = 0, n = 0;
    for (int w; (w = wg_item(n, gridDim.x, blockIdx.x)) < n_work; ++n) {
      const WgWork k = wg_work<BK>(w, nq, h, batch, t_len, causal, window);
      const int row_lo = k.q0 + cw * kWgRows, row_hi = row_lo + kWgRows - 1;
      const int r0 = row_lo + warp * 16 + g;  // this thread's rows: r0 and r0 + 8

      // The item's tiles this warpgroup's rows see, [t_first, t_last): a
      // run, since each row sees a run of keys.  The others it only lets
      // pass.
      int t_first = 0, t_last = 0;
      if (row_lo < s_len) {
        int jb, je;
        key_range(row_lo, kWgRows, t_len, causal, window, BK, jb, je);
        if (je > jb) {
          t_first = (jb - k.j_begin) / BK;
          t_last = min(k.n_tiles, (je - k.j_begin + BK - 1) / BK);
        }
      }
      auto slot = [&](int t) { return (it + t) % STAGES; };
      auto phase = [&](int t) { return (uint32_t)(((it + t) / STAGES) & 1); };
      auto pass = [&](int t) {
        turn_wait();
        turn_pass();
        hopper::mbar_wait(&k_full[slot(t)], phase(t));
        hopper::mbar_arrive(&k_empty[slot(t)]);
        hopper::mbar_wait(&v_full[slot(t)], phase(t));
        hopper::mbar_arrive(&v_empty[slot(t)]);
      };
      // Masks only where a tile crosses T, the diagonal or the window's edge.
      auto edge = [&](int j0) {
        return j0 + BK > t_len || (causal && j0 + BK - 1 > row_lo) ||
               (window > 0 && j0 <= row_hi - window);
      };
      // S = Q K^T over hd in k16 steps: box kk/4, 32 bytes per step in it.
      // Each step adds its byte offset / 16 to the descriptors' start
      // address; the asm keeps the compiler from hoisting all HD / 8 of
      // them out of the tile loop into registers.
      auto issue_s = [&](int s) {
        uint64_t dq = hopper::desc_sw128(q_addr, 16, 1024);
        uint64_t dk = hopper::desc_sw128(
            hopper::smem_u32(smem + L::K_OFF + s * L::KV_TILE), 16, 1024);
        asm volatile("" : "+l"(dq));
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;
          hopper::wgmma_ss<BK>(sc, dq + (((kk / 4) * L::Q_BOX + col) >> 4),
                               dk + (((kk / 4) * L::KV_BOX + col) >> 4), kk > 0);
        }
        hopper::wgmma_commit();
      };
      // O += P V: V's rows are keys (K) with hd along N, 16 keys per step.
      auto issue_pv = [&](int s) {
        const uint64_t dv = hopper::desc_sw128(
            hopper::smem_u32(smem + L::V_OFF + s * L::KV_TILE), L::KV_BOX, 1024);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          hopper::wgmma_rs<HD>(o, p[kk], dv + ((kk * 16 * kRowBytes) >> 4));
        hopper::wgmma_commit();
      };
      // P in bf16 as wgmma's A fragments: keys [16kk, 16kk + 16) are the
      // accumulator's column chunks 2kk and 2kk + 1.
      auto pack_p = [&]() {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            p[kk][jj] = pack_bf16(sc[8 * kk + 2 * jj], sc[8 * kk + 2 * jj + 1]);
      };

#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      m_run[0] = m_run[1] = -INFINITY;
      l_run[0] = l_run[1] = 0.f;
      hopper::mbar_wait(&q_full[cw], n & 1);
      for (int t = 0; t < t_first; ++t) pass(t);
      if (t_first < t_last) {
        // The first tile: S, softmax, P (O is still 0).
        {
          hopper::mbar_wait(&k_full[slot(t_first)], phase(t_first));
          turn_wait();
          hopper::wgmma_fence();
          issue_s(slot(t_first));
          turn_pass();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(sc);
          hopper::mbar_arrive(&k_empty[slot(t_first)]);
          const int j0 = k.j_begin + t_first * BK;
          softmax_tile<BK>(sc, m_run, l_run, alpha, r0, c, j0, edge(j0), t_len, causal, window,
                           scale_log2);
          pack_p();
        }
        // Then S(t) runs beside P(t-1) V(t-1), and the softmax of tile t
        // beside that P V product.
        for (int t = t_first + 1; t < t_last; ++t) {
          hopper::mbar_wait(&k_full[slot(t)], phase(t));
          hopper::fence_regs(o);
          turn_wait();
          hopper::wgmma_fence();
          issue_s(slot(t));
          hopper::mbar_wait(&v_full[slot(t - 1)], phase(t - 1));
          issue_pv(slot(t - 1));
          turn_pass();
          hopper::wgmma_wait<1>();
          hopper::fence_regs(sc);
          hopper::mbar_arrive(&k_empty[slot(t)]);
          const int j0 = k.j_begin + t * BK;
          softmax_tile<BK>(sc, m_run, l_run, alpha, r0, c, j0, edge(j0), t_len, causal, window,
                           scale_log2);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(o);
          hopper::fence_regs(p);
          hopper::mbar_arrive(&v_empty[slot(t - 1)]);
#pragma unroll
          for (int d = 0; d < HD / 8; ++d) {
            o[4 * d] *= alpha[0];
            o[4 * d + 1] *= alpha[0];
            o[4 * d + 2] *= alpha[1];
            o[4 * d + 3] *= alpha[1];
          }
          pack_p();
        }
        // The last P V.
        {
          hopper::mbar_wait(&v_full[slot(t_last - 1)], phase(t_last - 1));
          hopper::fence_regs(o);
          turn_wait();
          hopper::wgmma_fence();
          issue_pv(slot(t_last - 1));
          turn_pass();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(o);
          hopper::fence_regs(p);
          hopper::mbar_arrive(&v_empty[slot(t_last - 1)]);
        }
      }
      for (int t = max(t_first, t_last); t < k.n_tiles; ++t) pass(t);
      if (t_first >= t_last) {  // no tile of its own: the turn of the last P V
        turn_wait();
        turn_pass();
      }

      // O / l into this warpgroup's Q tile (no longer read), in the TMA box
      // layout, then one TMA store per box; once the store has read it, the
      // tile takes the next item's Q.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float l = l_run[half];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / fmaxf(l, 1e-37f);
        const int r = warp * 16 + g + 8 * half;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) {
          const int byte =
              (d / 8) * L::Q_BOX + r * kRowBytes + (((d % 8) ^ (r % 8)) * 16) + c * 4;
          *reinterpret_cast<uint32_t*>(qs + byte) =
              pack_bf16(o[4 * d + 2 * half] * inv, o[4 * d + 2 * half + 1] * inv);
        }
      }
      hopper::fence_proxy_async();
      hopper::bar_sync(1 + cw, 128);
      if (tid == 0) {
        for (int bx = 0; bx < NB; ++bx)
          hopper::tma_store_4d(&tm_o, qs + bx * L::Q_BOX, bx * kBoxCols, k.head, row_lo, k.b);
        hopper::tma_store_commit_and_wait();
        hopper::mbar_arrive(&q_empty[cw]);
      }
      it += k.n_tiles;
    }
  }
}

// ---------------------------------------------------------------- mma.sync
template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
    flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int s_len, int t_len,
                     int h, int kv, int causal, int window, float scale_log2) {
  constexpr int KSTR = HD + 8;  // shared row stride (bf16): B-fragment loads hit 32 banks
  constexpr int NK = HD / 16;   // k-steps of Q K^T
  constexpr int ND = HD / 8;    // n-tiles of the output
  constexpr int NT = kBK / 8;   // n-tiles of the scores
  __shared__ __align__(16) bf16 ks[kBK * KSTR];
  __shared__ __align__(16) bf16 vs[kBK * KSTR];

  const int q0 = blockIdx.x * kBQ, head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (h / kv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int row[2] = {q0 + warp * 16 + grp, q0 + warp * 16 + grp + 8};

  const long long q_rs = (long long)h * HD;
  const bf16* qh = q + ((long long)b * s_len * h + head) * HD;
  bf16* oh = o + ((long long)b * s_len * h + head) * HD;
  const long long kv_rs = (long long)kv * HD;
  const bf16* kh = k + ((long long)b * t_len * kv + kvh) * HD;
  const bf16* vh = v + ((long long)b * t_len * kv + kvh) * HD;

  // Q fragments (m16n8k16 A layout): a0 (grp, 2tig), a1 (grp+8, 2tig),
  // a2 (grp, 2tig+8), a3 (grp+8, 2tig+8) within each 16-column slice.
  uint32_t qf[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row[e & 1];
      const int c = kk * 16 + tig * 2 + (e >> 1) * 8;
      qf[kk][e] = r < s_len ? *reinterpret_cast<const uint32_t*>(qh + r * q_rs + c) : 0u;
    }
  }

  float oacc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[d][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  int j_begin, j_end;
  key_range(q0, kBQ, t_len, causal, window, kBK, j_begin, j_end);
  for (int j0 = j_begin; j0 < j_end; j0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int c = threadIdx.x; c < kBK * (HD / 8); c += kWarps * 32) {
      const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (j0 + r < t_len) {
        const long long off = (long long)(j0 + r) * kv_rs + col;
        kx = *reinterpret_cast<const uint4*>(kh + off);
        vx = *reinterpret_cast<const uint4*>(vh + off);
      }
      *reinterpret_cast<uint4*>(ks + r * KSTR + col) = kx;
      *reinterpret_cast<uint4*>(vs + r * KSTR + col) = vx;
    }
    __syncthreads();

    // Scores (C layout): s[nt][0..1] row grp, s[nt][2..3] row grp+8, keys
    // j0 + nt*8 + 2tig + {0, 1}.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const bf16* kr = ks + (nt * 8 + grp) * KSTR + tig * 2;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16(s[nt], qf[kk], b0, b1);
      }
    }
    // Scale into the log2 domain, mask, and update (m, l, acc) per row.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = row[half];
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + nt * 8 + tig * 2 + e;
          float& x = s[nt][half * 2 + e];
          x = attends(i, j, t_len, causal, window) ? x * scale_log2 : -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[half], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_run[half] - m_use);
      m_run[half] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][half * 2 + e];
          x = exp2f(x - m_use);
          sum += x;
        }
      l_run[half] = l_run[half] * alpha + sum;  // this thread's share of the row
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        oacc[d][half * 2] *= alpha;
        oacc[d][half * 2 + 1] *= alpha;
      }
    }
    // acc += P V: two score n-tiles form one A fragment (16 keys).
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* vr = vs + (kk * 16 + tig * 2) * KSTR + grp;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const bf16* vc = vr + d * 8;
        const uint32_t b0 = pack_bf16(vc[0], vc[KSTR]);
        const uint32_t b1 = pack_bf16(vc[8 * KSTR], vc[9 * KSTR]);
        mma_bf16(oacc[d], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = l_run[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-37f);
    const int i = row[half];
    if (i < s_len) {
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const uint32_t packed = pack_bf16(oacc[d][half * 2] * inv, oacc[d][half * 2 + 1] * inv);
        *reinterpret_cast<uint32_t*>(oh + i * q_rs + d * 8 + tig * 2) = packed;
      }
    }
  }
}

// ---------------------------------------------------------------- CUDA cores
struct CausalWindowMask {
  int q0, t_len, causal, window;
  __device__ bool operator()(int r, int j) const {
    return attends(q0 + r, j, t_len, causal, window);
  }
};

template <typename T>
__global__ void __launch_bounds__(attn::kTileThreads)
    flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int s_len, int t_len, int h,
                      int kv, int hd, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * kSimtRows, head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (h / kv);
  const int rows = min(kSimtRows, s_len - q0);
  int j_begin, j_end;
  key_range(q0, rows, t_len, causal, window, 1, j_begin, j_end);
  const long long q_off = (((long long)b * s_len + q0) * h + head) * hd;
  const long long kv_off = ((long long)b * t_len * kv + kvh) * hd;
  attn::tile_attention<T>(q + q_off, (long long)h * hd, rows, k + kv_off, v + kv_off,
                          (long long)kv * hd, j_begin, j_end, o + q_off, (long long)h * hd,
                          hd, scale, CausalWindowMask{q0, t_len, causal, window}, smem);
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int b, int s_len,
                       int t_len, int h, int kv, int causal, int window, float scale,
                       cudaStream_t st) {
  dim3 grid((s_len + kBQ - 1) / kBQ, h, b);
  flash_mma_kernel<HD><<<grid, kWarps * 32, 0, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, s_len, t_len, h, kv, causal,
      window, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o, int b, int s_len,
                        int t_len, int h, int kv, int hd, int causal, int window, float scale,
                        cudaStream_t st) {
  const size_t smem = attn::tile_smem_bytes(kSimtRows, hd);
  cudaError_t e = cudaFuncSetAttribute(flash_simt_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((s_len + kSimtRows - 1) / kSimtRows, h, b);
  flash_simt_kernel<T><<<grid, attn::kTileThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, s_len, t_len, h, kv, hd, causal, window,
      scale);
  return cudaGetLastError();
}

// A rank-4 map (hd, heads, seq, batch) of a contiguous bf16 tensor with
// boxes of 64 x 1 x rows x 1 and 128-byte swizzle.
bool encode_map(CUtensorMap* map, const void* ptr, int hd, int heads, int seq, int batch,
                int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t row = (cuuint64_t)hd * sizeof(bf16);
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {(cuuint32_t)kBoxCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int b, int s_len,
                         int t_len, int h, int kv, int causal, int window, float scale,
                         cudaStream_t st) {
  using L = WgLayout<HD>;
  if (t_len == 0)  // no keys: every row writes 0
    return cudaMemsetAsync(o, 0, (size_t)b * s_len * h * HD * sizeof(bf16), st);
  for (const void* p : {q, k, v, (const void*)o})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  CUtensorMap mq, mk, mv, mo;
  if (!encode_map(&mq, q, HD, h, s_len, b, kWgRows) ||
      !encode_map(&mk, k, HD, kv, t_len, b, L::BK) ||
      !encode_map(&mv, v, HD, kv, t_len, b, L::BK) ||
      !encode_map(&mo, o, HD, h, s_len, b, kWgRows))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_wgmma_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const int n_work = (s_len + kWgBQ - 1) / kWgBQ * h * b;  // one block per SM, persistent
  flash_wgmma_kernel<HD><<<std::min(n_work, sms), kWgThreads, L::BYTES, st>>>(
      mq, mk, mv, mo, s_len, t_len, h, kv, b, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// path: 0 = simt, 1 = mma, 2 = wgmma (ops.kernel_path); dtype: 0 = float32,
// 1 = bfloat16; window <= 0 means none.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a path that does not take the input).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int b, int s_len, int t_len, int h, int kv, int hd,
                                      int causal, int window, int dtype, int path,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float scale = (float)(1.0 / std::sqrt((double)hd));
  if (path == 2 && dtype == 1) {
    switch (hd) {
      case 64:
        return (int)launch_wgmma<64>(q, k, v, o, b, s_len, t_len, h, kv, causal, window, scale,
                                     st);
      case 128:
        return (int)launch_wgmma<128>(q, k, v, o, b, s_len, t_len, h, kv, causal, window, scale,
                                      st);
      case 256:
        return (int)launch_wgmma<256>(q, k, v, o, b, s_len, t_len, h, kv, causal, window, scale,
                                      st);
    }
  } else if (path == 1 && dtype == 1) {
    switch (hd) {
      case 16:
        return (int)launch_mma<16>(q, k, v, o, b, s_len, t_len, h, kv, causal, window, scale, st);
      case 32:
        return (int)launch_mma<32>(q, k, v, o, b, s_len, t_len, h, kv, causal, window, scale, st);
    }
  } else if (path == 0 && dtype == 1) {
    return (int)launch_simt<bf16>(q, k, v, o, b, s_len, t_len, h, kv, hd, causal, window, scale,
                                  st);
  } else if (path == 0 && dtype == 0) {
    return (int)launch_simt<float>(q, k, v, o, b, s_len, t_len, h, kv, hd, causal, window, scale,
                                   st);
  }
  return (int)cudaErrorInvalidValue;
}
