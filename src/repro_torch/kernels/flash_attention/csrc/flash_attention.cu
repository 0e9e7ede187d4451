// Causal / sliding-window GQA flash attention (forward).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py
//   :: flash_attention_pallas (_kernel)
//
// q (B,S,H,hd), k/v (B,T,KV,hd), bf16 or f32; output (B,S,H,hd) in q's
// dtype.  Query head h reads KV head h / (H/KV) (flash_attention.py:145);
// query i attends to key j when j <= i (causal) and j > i - window (window);
// scale 1/sqrt(hd); denominator clamped at 1e-37.
//
// One block per (q tile, head, batch row), with the loop over KV tiles
// inside the block: it takes the place of the TPU's sequential innermost
// grid dimension (flash_attention.py:143), and the online-softmax state
// (m, l, acc) lives in registers in f32 for the whole loop.  KV tiles that
// lie wholly above the causal diagonal or wholly outside the window are
// never visited, as the Pallas kernel's `pl.when` skips them
// (flash_attention.py:99-103).  S and T need not be multiples of the tile:
// the ragged edge is masked.
//
// Two paths:
//  * bf16 with hd a multiple of 16 up to 128 (GLM-4-9B: hd 128): tensor
//    cores through `mma.sync.m16n8k16` (bf16 in, f32 accumulate).  A block
//    is 4 warps over 64 query rows, 16 rows per warp, with its Q fragments
//    in registers; each 64-key K/V tile is staged in shared memory with
//    16-byte loads.  Q K^T gives the Pallas kernel's products exactly (bf16
//    products are exact in f32) with f32 sums.  P V also runs on bf16 tensor
//    cores, so P is rounded to bf16 (relative error <= 2^-9 per weight)
//    where the Pallas kernel keeps it in f32: within the bf16 tolerance
//    (atol = rtol = 3e-2) the tests and chip_smoke.py hold it to.
//  * anything else (f32; other head dims): the f32 CUDA-core body of
//    ../../csrc/attention_tile.cuh, 16 query rows per block, which keeps
//    the Pallas kernel's all-f32 arithmetic.
//
// Bound on an H100: operations.  Causal attention at B=8, S=T=2048, H=32,
// hd=128 does about 4*B*H*S^2*hd/2 = 2.75e11 FLOP, 0.278 ms at 989 TFLOP/s
// (bf16 dense), against 0.085 ms for its 285 MB of q/k/v/o at 3.35 TB/s.
// This first version uses `mma.sync` (not `wgmma`), no TMA and no
// pipelining of the K/V tile loads behind the matrix products, so it runs
// well below the tensor cores' peak; those are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

#include "../../csrc/attention_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;  // query rows per block (16 per warp)
constexpr int kBK = 64;  // keys per tile
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

// Keys [j_begin, j_end) that query rows [q0, q0 + rows) can see.
__device__ __forceinline__ void key_range(int q0, int rows, int t_len, int causal, int window,
                                          int tile, int& j_begin, int& j_end) {
  j_end = causal ? min(t_len, q0 + rows) : t_len;
  j_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  j_begin = (j_begin / tile) * tile;
}

// ---------------------------------------------------------------- tensor cores
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; window <= 0 means none.  Returns the
// cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int b, int s_len, int t_len, int h, int kv, int hd,
                                      int causal, int window, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float scale = (float)(1.0 / std::sqrt((double)hd));
  if (dtype == 1) {
    switch (hd) {
      case 16:
        return (int)launch_mma<16>(q, k, v, o, b, s_len, t_len, h, kv, causal, window, scale, st);
      case 32:
        return (int)launch_mma<32>(q, k, v, o, b, s_len, t_len, h, kv, causal, window, scale, st);
      case 64:
        return (int)launch_mma<64>(q, k, v, o, b, s_len, t_len, h, kv, causal, window, scale, st);
      case 128:
        return (int)launch_mma<128>(q, k, v, o, b, s_len, t_len, h, kv, causal, window, scale,
                                    st);
      default:
        return (int)launch_simt<bf16>(q, k, v, o, b, s_len, t_len, h, kv, hd, causal, window,
                                      scale, st);
    }
  }
  if (dtype == 0)
    return (int)launch_simt<float>(q, k, v, o, b, s_len, t_len, h, kv, hd, causal, window,
                                   scale, st);
  return (int)cudaErrorInvalidValue;
}
