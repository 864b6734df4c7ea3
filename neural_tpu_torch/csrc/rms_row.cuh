// The row scale of an RMS norm, computed one way by every kernel that
// takes one: K1's fused rms prologue (qmm4_npack.cu) and the row-norm
// kernel (rms_norm.cu), which ops/norms.py rms_norm launches on the card.
// With one routine the fused decode path and the unfused graph round
// alike, bit for bit.
//
// A row of K values (K a multiple of 8) is summed by THREADS = 128 threads,
// four warps: thread t adds the squares of the 8-value chunks c = t, t +
// 128, ... in order, each square and each sum rounded to f32 (no fused
// multiply-add); each warp adds its threads' sums by an xor butterfly (16,
// 8, 4, 2, 1); the four warp sums are added in warp order; the scale is
// rsqrtf(sum * (1 / K) + eps). A normed value is v * scale * (w + offset),
// each product rounded to f32, before the caller's rounding to bf16.
#pragma once

#include <cuda_runtime.h>

namespace rms_row {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

// s plus the squares of the 8 values of one chunk, in order
__device__ __forceinline__ float add_squares8(float s, const float v[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) s = __fadd_rn(s, __fmul_rn(v[i], v[i]));
  return s;
}

// the sum of a warp's 32 values, the same in every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

// the four warp sums, sums[0], sums[stride], ..., added in warp order
__device__ __forceinline__ float total(const float* sums, int stride) {
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t = __fadd_rn(t, sums[w * stride]);
  return t;
}

__device__ __forceinline__ float scale(float total, int K, float eps) {
  return rsqrtf(__fadd_rn(__fmul_rn(total, 1.f / (float)K), eps));
}

__device__ __forceinline__ float apply(float v, float scale, float w,
                                       float offset) {
  return __fmul_rn(__fmul_rn(v, scale), __fadd_rn(w, offset));
}

}  // namespace rms_row
