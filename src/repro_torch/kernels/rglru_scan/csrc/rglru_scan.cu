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
// and walks the whole sequence itself, with h in a register.  Neighbouring
// threads own neighbouring w, so every load and store of a warp is one
// coalesced 128-byte (f32) row segment.
//
// Bound on an H100: bytes.  The recurrence reads a and b once and writes h
// once: at RecurrentGemma-2B's prefill, (8, 2048, 2560) f32, 503 MB, or
// 0.150 ms at 3.35 TB/s; its 2 flops per element are nothing beside that.
// Only B*W = 20,480 threads run (about 155 per SM), far too few to cover
// device-memory latency one load at a time, so the loop is unrolled kUnroll
// steps deep and issues all 2*kUnroll loads of a block of steps before the
// dependent multiply-add chain: the loads do not depend on h.
//
// Later work: a chunked two-pass scan that is parallel over S as well
// (per-chunk (prod a, local h) in a first pass, a short scan of the chunk
// carries, then a fix-up pass), which puts many more threads in flight at
// the price of a second read of a.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "../../csrc/common.cuh"

namespace {

constexpr int kThreads = 64;  // small blocks spread 20,480 channels over all SMs
constexpr int kUnroll = 16;

using kern::from_f;
using kern::to_f;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const float* __restrict__ h0, T* __restrict__ out, int batch, int s_len,
                      int width) {
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
cudaError_t launch(const void* a, const void* b, const void* h0, void* out, int batch, int s_len,
                   int width, cudaStream_t st) {
  const long long channels = (long long)batch * width;
  const int blocks = (int)((channels + kThreads - 1) / kThreads);
  rglru_scan_kernel<T><<<blocks, kThreads, 0, st>>>((const T*)a, (const T*)b, (const float*)h0,
                                                    (T*)out, batch, s_len, width);
  return cudaGetLastError();
}

}  // namespace

// dtype of a, b and out: 0 = float32, 1 = bfloat16; h0 is float32.  Returns
// the cudaError_t of the launch.
extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0, void* out,
                                 int batch, int s_len, int width, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(a, b, h0, out, batch, s_len, width, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, b, h0, out, batch, s_len, width, st);
  return (int)cudaErrorInvalidValue;
}
