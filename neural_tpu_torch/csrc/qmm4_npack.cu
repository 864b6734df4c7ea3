// K1 qmm4_npack: int4 native-pack weight GEMV / skinny GEMM for Hopper.
//
// Replaces neural_tpu/ops/qmatmul.py:_qmm4_kernel (launched by
// _qmatmul4_pallas): out[M, N] = x[M, K] @ (codes * s), f32 accumulation,
// for any M below 256 (decode M=1, short prompts, the prefill's one-row
// lm_head). Weights: uint8 plane [K/2, N], byte row r holds code 2r in the
// low nibble and code 2r+1 in the high nibble, centered two's complement;
// scales bf16 [K/group, N].
//
// What bounds it on the H100: the bytes. At M=1 every weight byte is used
// once for two multiply-adds, so the least time is (codes + scales) over
// the HBM rate. The design streams the plane with 16-byte loads (16 columns
// x 2 K-rows per load, neighbouring threads on neighbouring columns),
// unpacks the nibbles in registers, and applies each group's scale to the
// thread's partial sum over a 32-row chunk of that group (the TPU m1
// branch's per-group scaling). At N=4096 the N axis alone gives too few
// blocks for 132 SMs, so K is split too: each block covers 512 K rows of
// 128 columns and writes f32 partials [splits, M, N]; a second pass adds
// the splits in a fixed order. No atomics, so reruns are bit-identical.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int COLS = 16;             // columns per thread (one 16 B load)
constexpr int TX = 8;                // threads along N: 128 columns a block
constexpr int TY = 16;               // 32-row K chunks per block: 512 K
constexpr int CHUNK_ROWS = 16;       // byte rows per chunk = 32 K values
constexpr int BLOCK_COLS = TX * COLS;

__device__ __forceinline__ float nib_lo(uint32_t byte) {
  return (float)((int)((byte & 0xFu) ^ 8u) - 8);
}
__device__ __forceinline__ float nib_hi(uint32_t byte) {
  return (float)((int)(((byte >> 4) & 0xFu) ^ 8u) - 8);
}

template <int MT>
__global__ void __launch_bounds__(TX * TY)
qmm4_partial(const __nv_bfloat16* __restrict__ x,
             const uint8_t* __restrict__ planes,
             const __nv_bfloat16* __restrict__ scales,
             float* __restrict__ partial, int M, int K, int N, int group) {
  __shared__ float red[TY][MT][BLOCK_COLS];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n0 = blockIdx.x * BLOCK_COLS + tx * COLS;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int k0 = (split * TY + ty) * 32;    // first K row of the chunk

  float acc[MT][COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[m][j] = 0.f;

  if (n0 < N && k0 < K) {
    const uint8_t* wp = planes + (size_t)(k0 / 2) * N + n0;
#pragma unroll 4
    for (int r = 0; r < CHUNK_ROWS; ++r) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)r * N));
      float xlo[MT], xhi[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m0 + m < M) {
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
              x + (size_t)(m0 + m) * K + k0 + 2 * r);
          xlo[m] = __low2float(xv);
          xhi[m] = __high2float(xv);
        } else {
          xlo[m] = 0.f;
          xhi[m] = 0.f;
        }
      }
      const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t byte = (wv[q] >> (8 * b)) & 0xFFu;
          const float lo = nib_lo(byte), hi = nib_hi(byte);
#pragma unroll
          for (int m = 0; m < MT; ++m)
            acc[m][q * 4 + b] += xlo[m] * lo + xhi[m] * hi;
        }
      }
    }
    // the chunk lies inside one group: scale its partial sum
    const __nv_bfloat16* sp = scales + (size_t)(k0 / group) * N + n0;
    const uint4 s01 = __ldg(reinterpret_cast<const uint4*>(sp));
    const uint4 s23 = __ldg(reinterpret_cast<const uint4*>(sp + 8));
    const uint32_t sv[8] = {s01.x, s01.y, s01.z, s01.w,
                            s23.x, s23.y, s23.z, s23.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const __nv_bfloat162 s2 = *reinterpret_cast<const __nv_bfloat162*>(&sv[i]);
      const float slo = __low2float(s2), shi = __high2float(s2);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        acc[m][2 * i] *= slo;
        acc[m][2 * i + 1] *= shi;
      }
    }
  }

  // add the block's chunks in a fixed order
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j) red[ty][m][tx * COLS + j] = acc[m][j];
  __syncthreads();
  const int tid = ty * TX + tx;
  for (int o = tid; o < MT * BLOCK_COLS; o += TX * TY) {
    const int m = o / BLOCK_COLS, c = o % BLOCK_COLS;
    const int n = blockIdx.x * BLOCK_COLS + c;
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < TY; ++y) s += red[y][m][c];
    if (m0 + m < M && n < N)
      partial[((size_t)split * M + m0 + m) * N + n] = s;
  }
}

__global__ void qmm4_reduce(const float* __restrict__ partial, void* out,
                            int splits, long long MN, int out_f32) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[(size_t)p * MN + i];
  if (out_f32)
    reinterpret_cast<float*>(out)[i] = s;
  else
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(s);
}

}  // namespace

extern "C" int qmm4_npack(const void* x, const void* planes,
                          const void* scales, void* partial, void* out,
                          int M, int K, int N, int group, int out_f32,
                          int splits, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 block(TX, TY);
  const int ntiles = (N + BLOCK_COLS - 1) / BLOCK_COLS;
  const auto* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  const auto* pb = reinterpret_cast<const uint8_t*>(planes);
  const auto* sb = reinterpret_cast<const __nv_bfloat16*>(scales);
  auto* part = reinterpret_cast<float*>(partial);
  if (M == 1) {
    qmm4_partial<1><<<dim3(ntiles, splits, 1), block, 0, st>>>(
        xb, pb, sb, part, M, K, N, group);
  } else {
    qmm4_partial<4><<<dim3(ntiles, splits, (M + 3) / 4), block, 0, st>>>(
        xb, pb, sb, part, M, K, N, group);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long MN = (long long)M * N;
  qmm4_reduce<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(
      part, out, splits, MN, out_f32);
  return (int)cudaGetLastError();
}
