// One block's online-softmax attention over a run of keys, in f32 on CUDA
// cores: the shared body of decode_attention.cu and of flash_attention.cu's
// path for inputs the tensor-core path does not take (f32, or a head_dim
// that is not a multiple of 16 up to 128).
//
// A block holds `rows` query vectors of one KV head (the G heads of a group
// for decode, a tile of positions of one head for flash) and streams the
// keys [j_begin, j_end) through shared memory in tiles of kTileKeys, with the
// state (m, l, acc) in f32 -- the Pallas kernels' (m_scr, l_scr, acc_scr).
// Masked scores are -inf.  At the end the block either writes the output
// acc / max(l, 1e-37) (the Pallas kernels' clamp; a row whose keys are all
// masked writes 0), or, for a split over keys, its partial (acc, m, l) for
// the merge that decode_attention.cu's last block of the split does.
//
// Shared memory (f32): q [rows][hd], k [kTileKeys][hd + 1] (padded so the
// score loop's lanes, on consecutive keys, hit distinct banks), v
// [kTileKeys][hd], p [rows][kTileKeys], then m, l, alpha [rows].  K/V rows
// are read with 16-byte loads (hd is a multiple of 8).  Each of
// kTileThreads threads holds at most kMaxAcc of the rows*hd accumulators;
// its score and accumulator loops run kScoreIlp / kMaxAcc independent FMA
// chains so that shared-memory latency overlaps.
#pragma once

#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace attn {

constexpr int kTileThreads = 256;
constexpr int kTileKeys = 64;  // the softmax pass gives each lane 2 keys of a tile
constexpr int kMaxAcc = 16;
constexpr int kScoreIlp = 4;

using kern::from_f;
using kern::to_f;

// 16 bytes of T from global memory, widened to f32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

inline size_t tile_smem_bytes(int rows, int hd) {
  return sizeof(float) * ((size_t)rows * hd + (size_t)kTileKeys * (hd + 1) +
                          (size_t)kTileKeys * hd + (size_t)rows * kTileKeys + 3 * (size_t)rows);
}

// q row r at q + r * q_rs; key/value j at k/v + j * kv_rs; output row r at
// o + r * o_rs.  mask(r, j) says whether row r attends to key j.  With
// part_acc non-null the block writes its unnormalized acc [rows][hd] there
// and (m, l) [rows][2] at part_ml, instead of o.
template <typename T, typename Mask>
__device__ void tile_attention(const T* __restrict__ q, long long q_rs, int rows,
                               const T* __restrict__ k, const T* __restrict__ v,
                               long long kv_rs, int j_begin, int j_end,
                               T* __restrict__ o, long long o_rs, int hd, float scale,
                               Mask mask, float* smem, float* __restrict__ part_acc = nullptr,
                               float* __restrict__ part_ml = nullptr) {
  constexpr int VN = Vec<T>::n;
  float* qs = smem;
  float* ks = qs + rows * hd;
  float* vs = ks + kTileKeys * (hd + 1);
  float* ps = vs + kTileKeys * hd;
  float* ms = ps + rows * kTileKeys;
  float* ls = ms + rows;
  float* as = ls + rows;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  const int nout = rows * hd;
  const int hv = hd / VN;  // 16-byte vectors per row

  for (int i = tid; i < rows * hv; i += nt) {
    const int r = i / hv, d = (i % hv) * VN;
    Vec<T>::load(q + (long long)r * q_rs + d, qs + r * hd + d);
  }
  for (int r = tid; r < rows; r += nt) {
    ms[r] = -INFINITY;
    ls[r] = 0.f;
  }
  // Accumulator c of this thread is output i = tid + c * nt: row i / hd,
  // column i % hd (offsets precomputed: hd is not a compile-time constant).
  float acc[kMaxAcc];
  int prow[kMaxAcc], vcol[kMaxAcc];
#pragma unroll
  for (int c = 0; c < kMaxAcc; ++c) {
    const int i = min(tid + c * nt, nout - 1);
    acc[c] = 0.f;
    prow[c] = (i / hd) * kTileKeys;
    vcol[c] = i % hd;
  }
  __syncthreads();

  for (int j0 = j_begin; j0 < j_end; j0 += kTileKeys) {
    const int nk = min(kTileKeys, j_end - j0);
    for (int i = tid; i < nk * hv; i += nt) {
      const int j = i / hv, d = (i % hv) * VN;
      const long long off = (long long)(j0 + j) * kv_rs + d;
      float kx[VN];
      Vec<T>::load(k + off, kx);
      Vec<T>::load(v + off, vs + j * hd + d);
#pragma unroll
      for (int e = 0; e < VN; ++e) ks[j * (hd + 1) + d + e] = kx[e];
    }
    __syncthreads();
    // Scores: items i0 + u*nt share the key j (nt is a multiple of the tile).
    for (int i0 = tid; i0 < rows * kTileKeys; i0 += nt * kScoreIlp) {
      const int j = i0 % kTileKeys;
      const float* kr = ks + j * (hd + 1);
      float dot[kScoreIlp];
      const float* qr[kScoreIlp];
#pragma unroll
      for (int u = 0; u < kScoreIlp; ++u) {
        dot[u] = 0.f;
        const int r = min((i0 + u * nt) / kTileKeys, rows - 1);
        qr[u] = qs + r * hd;
      }
      for (int d = 0; d < hd; ++d) {
        const float kd = kr[d];
#pragma unroll
        for (int u = 0; u < kScoreIlp; ++u) dot[u] = fmaf(qr[u][d], kd, dot[u]);
      }
#pragma unroll
      for (int u = 0; u < kScoreIlp; ++u) {
        const int i = i0 + u * nt;
        if (i < rows * kTileKeys) {
          const int r = i / kTileKeys;
          ps[i] = (j < nk && mask(r, j0 + j)) ? dot[u] * scale : -INFINITY;
        }
      }
    }
    __syncthreads();
    // Online-softmax update, one warp per row.
    for (int r = warp; r < rows; r += nw) {
      float* pr = ps + r * kTileKeys;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      float mx = fmaxf(s0, s1);
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = expf(s0 - m_use), p1 = expf(s1 - m_use);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      float sum = p0 + p1;
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_use);
        as[r] = alpha;
        ls[r] = ls[r] * alpha + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
    // acc += P V, key by key, every accumulator of the thread per key.
#pragma unroll
    for (int c = 0; c < kMaxAcc; ++c) acc[c] *= as[prow[c] / kTileKeys];
    for (int j = 0; j < nk; ++j) {
      const float* vr = vs + j * hd;
#pragma unroll
      for (int c = 0; c < kMaxAcc; ++c)
        if (tid + c * nt < nout) acc[c] = fmaf(ps[prow[c] + j], vr[vcol[c]], acc[c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < kMaxAcc; ++c) {
    const int i = tid + c * nt;
    if (i < nout) {
      const int r = prow[c] / kTileKeys;
      if (part_acc != nullptr)
        part_acc[i] = acc[c];
      else
        o[(long long)r * o_rs + vcol[c]] = from_f<T>(acc[c] / fmaxf(ls[r], 1e-37f));
    }
  }
  if (part_ml != nullptr)
    for (int r = tid; r < rows; r += nt) {
      part_ml[2 * r] = ms[r];
      part_ml[2 * r + 1] = ls[r];
    }
}

}  // namespace attn
