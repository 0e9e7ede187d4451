// Single-token flash-decode attention over a KV cache with per-row lengths.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py
//   :: decode_attention_pallas (_kernel)
//
// q (B,1,H,hd), caches (B,T,KV,hd), kv_len (B,) int32, bf16 or f32; output
// (B,1,H,hd) in q's dtype.  A block holds all G = H/KV query heads of one
// KV group, as one Pallas grid cell does (decode_attention.py:102-109), and
// streams keys through shared memory in tiles of 64 with the f32
// online-softmax state of ../../csrc/attention_tile.cuh.  Keys at or past
// kv_len[b] are never read (the Pallas kernel's `pl.when(k_start < kv_len)`
// skip) or are masked inside the last tile.  A row with kv_len 0 writes 0.
//
// Bound on an H100: memory.  Each call must read the live K and V rows once,
// sum_b kv_len[b] * KV * hd * 2 * sizeof(T) bytes: at B=8, KV=2, hd=128,
// kv_len ~2,064, bf16, 16.9 MB, about 5.0 us at 3.35 TB/s.  One block per
// (b, KV head) would be 16 blocks on 132 SMs at GLM-4-9B's B=8, KV=2, far
// too few to draw the card's bandwidth, so the keys are split (flash-
// decoding): `nsplit` blocks per (b, KV head) each take a run of whole
// tiles of [0, kv_len) and write a partial (acc, m, l) in f32; a second
// kernel merges the partials, acc_s * exp(m_s - M) summed over splits and
// divided by sum_s l_s * exp(m_s - M), M = max_s m_s.  K/V rows are read
// with 16-byte loads.  At short cache lengths (kv_len ~100) most splits are
// empty and the call is bound by its two launches, not by bytes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

#include "../../csrc/attention_tile.cuh"

namespace {

constexpr int kMergeThreads = 128;

struct KvLenMask {
  int len;
  __device__ bool operator()(int, int j) const { return j < len; }
};

// Keys [begin, end) of split s: runs of whole 64-key tiles of [0, len).
__device__ __forceinline__ void split_range(int len, int nsplit, int s, int& begin, int& end) {
  const int per = (len + nsplit - 1) / nsplit;
  const int chunk = (per + attn::kTileKeys - 1) / attn::kTileKeys * attn::kTileKeys;
  begin = min(len, s * chunk);
  end = min(len, begin + chunk);
}

template <typename T>
__global__ void __launch_bounds__(attn::kTileThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const int* __restrict__ kv_len,
                            T* __restrict__ o, float* __restrict__ part_acc,
                            float* __restrict__ part_ml, int t_cap, int h, int kv, int hd,
                            float scale) {
  extern __shared__ float smem[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, nsplit = gridDim.x;
  const int g = h / kv;
  const int len = max(0, min(kv_len[b], t_cap));
  int begin, end;
  split_range(len, nsplit, split, begin, end);
  const long long q_off = ((long long)b * h + (long long)kvh * g) * hd;
  const long long kv_off = ((long long)b * t_cap * kv + kvh) * hd;
  const long long part = ((long long)b * kv + kvh) * nsplit + split;
  attn::tile_attention<T>(q + q_off, hd, g, k + kv_off, v + kv_off, (long long)kv * hd, begin,
                          end, o + q_off, hd, hd, scale, KvLenMask{len}, smem,
                          part_acc == nullptr ? nullptr : part_acc + part * g * hd,
                          part_ml == nullptr ? nullptr : part_ml + part * g * 2);
}

// Merge the nsplit partials of one query head (b, KV head, row r of the
// group): one block, one thread per output column.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
    merge_partials(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                   T* __restrict__ o, int h, int kv, int hd, int nsplit) {
  const int kvh = blockIdx.x, b = blockIdx.y, r = blockIdx.z;
  const int g = h / kv;
  const long long first = ((long long)b * kv + kvh) * nsplit;
  const long long o_off = ((long long)b * h + (long long)kvh * g + r) * hd;
  float m_max = -INFINITY;
  for (int s = 0; s < nsplit; ++s) m_max = fmaxf(m_max, part_ml[((first + s) * g + r) * 2]);
  const float m_use = m_max == -INFINITY ? 0.f : m_max;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float* ml = part_ml + ((first + s) * g + r) * 2;
      const float w = expf(ml[0] - m_use);
      l = fmaf(ml[1], w, l);
      acc = fmaf(part_acc[((first + s) * g + r) * hd + d], w, acc);
    }
    o[o_off + d] = attn::from_f<T>(acc / fmaxf(l, 1e-37f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_len, void* o,
                   float* part_acc, float* part_ml, int b, int t_cap, int h, int kv, int hd,
                   int nsplit, cudaStream_t s) {
  const size_t smem = attn::tile_smem_bytes(h / kv, hd);
  cudaError_t e = cudaFuncSetAttribute(decode_attention_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const float scale = (float)(1.0 / std::sqrt((double)hd));
  const bool merged = nsplit > 1;
  decode_attention_kernel<T><<<dim3(nsplit, kv, b), attn::kTileThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_len, (T*)o, merged ? part_acc : nullptr,
      merged ? part_ml : nullptr, t_cap, h, kv, hd, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || !merged) return e;
  merge_partials<T><<<dim3(kv, b, h / kv), kMergeThreads, 0, s>>>(part_acc, part_ml, (T*)o, h,
                                                                  kv, hd, nsplit);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part_acc / part_ml: f32 scratch of
// B*KV*nsplit*G*hd and B*KV*nsplit*G*2 floats (unused when nsplit is 1).
// Returns the cudaError_t of the launches.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* kv_len, void* o, void* part_acc,
                                       void* part_ml, int b, int t_cap, int h, int kv, int hd,
                                       int nsplit, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* lens = (const int*)kv_len;
  float* pa = (float*)part_acc;
  float* pm = (float*)part_ml;
  if (b == 0) return (int)cudaSuccess;
  if (nsplit < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(q, k, v, lens, o, pa, pm, b, t_cap, h, kv, hd, nsplit, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, lens, o, pa, pm, b, t_cap, h, kv, hd, nsplit, s);
  return (int)cudaErrorInvalidValue;
}
