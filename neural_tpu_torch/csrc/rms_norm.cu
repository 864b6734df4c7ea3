// The RMS norm of the decoder graph on the card: out = v * rsqrt(mean(v^2)
// + eps) * (w + offset) per row, f32 inside, out in x's dtype. It replaces
// the chain of torch ops of ops/norms.py rms_norm (the JAX package's
// neural_tpu/ops/norms.py rms_norm, which XLA fuses; no Pallas kernel) so
// that the unfused graph takes the row scale exactly as K1's fused rms
// prologue takes it: both use rms_row.cuh.
//
// One block of rms_row::THREADS threads a row: the sum of squares in
// rms_row's order, the scale, then each thread writes its share of the
// row. x and out are bf16, as the residual stream is; the weight is bf16
// or f32 (the final norm's). Loads are scalar, so no alignment is asked
// of x or w.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "rms_row.cuh"

namespace {

__global__ void __launch_bounds__(rms_row::THREADS)
    rms_norm_rows(const __nv_bfloat16* __restrict__ x,
                  const void* __restrict__ w, int w_f32, float eps,
                  float offset, __nv_bfloat16* __restrict__ out, int K) {
  __shared__ float warp_sums[rms_row::WARPS];
  __shared__ float row_scale;
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * K;
  float s = 0.f;
  for (int c = tid; c < K / 8; c += rms_row::THREADS) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = __bfloat162float(x[base + (size_t)c * 8 + i]);
    s = rms_row::add_squares8(s, v);
  }
  s = rms_row::warp_sum(s);
  if (tid % 32 == 0) warp_sums[tid / 32] = s;
  __syncthreads();
  if (tid == 0)
    row_scale = rms_row::scale(rms_row::total(warp_sums, 1), K, eps);
  __syncthreads();
  const float r = row_scale;
  for (int k = tid; k < K; k += rms_row::THREADS) {
    const float wv = w_f32 ? reinterpret_cast<const float*>(w)[k]
                           : __bfloat162float(
                                 reinterpret_cast<const __nv_bfloat16*>(w)[k]);
    out[base + k] = __float2bfloat16(
        rms_row::apply(__bfloat162float(x[base + k]), r, wv, offset));
  }
}

}  // namespace

// x and out [M, K] bf16 (K a multiple of 8); w [K], bf16 or f32 (w_f32)
extern "C" int rms_norm_bf16(const void* x, const void* w, int w_f32,
                             float eps, float offset, void* out, int M,
                             int K, void* stream) {
  if (M > 0)
    rms_norm_rows<<<M, rms_row::THREADS, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const __nv_bfloat16*>(x), w, w_f32, eps, offset,
        reinterpret_cast<__nv_bfloat16*>(out), K);
  return (int)cudaGetLastError();
}
