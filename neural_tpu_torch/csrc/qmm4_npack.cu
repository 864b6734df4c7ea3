// K1: native-code weight GEMV / skinny GEMM for Hopper (M <= 16).
//
// Replaces neural_tpu/ops/qmatmul.py:_qmm4_kernel (launched by
// _qmatmul4_pallas): out[M, N] = x[M, K] @ (codes * s), f32 dequant and f32
// accumulation, the group scale applied to each 32-row chunk's partial sum.
// Three code layouts, each with a symmetric entry point and an asymmetric
// one (name + "_asym"):
//   qmm4_npack       native-pack nibbles (int3/int4): uint8 [K/2, N], byte
//                    row r holds code 2r in the low nibble and 2r+1 in the
//                    high nibble, centered two's complement;
//   qmm2_npack       native-pack int2: uint8 [K/4, N], four centered 2-bit
//                    fields per byte, LSB first (code 4r in bits 0-1);
//   qmm8_native      int8 code planes [K, N] (5-8 bit at rest, centered).
// Scales are bf16 [K/group, N]. Asymmetric weights (zeros non-null) carry
// bf16 zero-points shifted like the codes; as in the TPU kernel they never
// touch the weight tile but come in as a rank-G correction
// out -= xs @ (z * s), with xs [M, K/group] the f32 per-group sums of x,
// computed outside the kernel (as _qmatmul4_pallas computes them in XLA);
// the block that holds a group's first chunk subtracts that group's term.
//
// What bounds it on the H100: the bytes. At M=1 every weight byte is used
// once for a few multiply-adds, so the least time is (codes + scales) over
// the HBM rate. The design streams the plane with 16-byte loads (16
// columns per load, neighbouring threads on neighbouring columns), unpacks
// the fields in registers, and scales each thread's partial sum over a
// 32-row chunk once (the TPU m1 branch's per-group scaling). At N=4096 the
// N axis alone gives too few blocks for 132 SMs, so K is split too: each
// block covers 512 K rows of 128 columns and writes f32 partials
// [splits, M, N]; a second pass adds the splits in a fixed order. No
// atomics, so reruns are bit-identical.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int COLS = 16;             // columns per thread (one 16 B load)
constexpr int TX = 8;                // threads along N: 128 columns a block
constexpr int TY = 16;               // 32-row K chunks per block: 512 K
constexpr int BLOCK_COLS = TX * COLS;

enum Code { C_NIB = 0, C_INT2 = 1, C_INT8 = 2 };

// K rows per byte and the centered value of field f of a byte
template <int CODE>
struct Fields;
template <>
struct Fields<C_NIB> {
  static constexpr int R = 2;
  __device__ static float at(uint32_t byte, int f) {
    return (float)((int)(((byte >> (4 * f)) & 0xFu) ^ 8u) - 8);
  }
};
template <>
struct Fields<C_INT2> {
  static constexpr int R = 4;
  __device__ static float at(uint32_t byte, int f) {
    return (float)((int)(((byte >> (2 * f)) & 0x3u) ^ 2u) - 2);
  }
};
template <>
struct Fields<C_INT8> {
  static constexpr int R = 1;
  __device__ static float at(uint32_t byte, int) {
    return (float)(int8_t)byte;
  }
};

__device__ __forceinline__ float bf16_bits(uint32_t h) {
  return __uint_as_float(h << 16);
}

template <int MT, int CODE, bool ASYM>
__global__ void __launch_bounds__(TX * TY)
qmm_native_partial(const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ planes,
                   const __nv_bfloat16* __restrict__ scales,
                   const __nv_bfloat16* __restrict__ zeros,
                   const float* __restrict__ xs, float* __restrict__ partial,
                   int M, int K, int N, int group) {
  constexpr int R = Fields<CODE>::R;
  constexpr int BR = 32 / R;             // byte rows per 32-row chunk
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
    const uint8_t* wp = planes + (size_t)(k0 / R) * N + n0;
#pragma unroll 4
    for (int r = 0; r < BR; ++r) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)r * N));
      float xv[MT][R];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const __nv_bfloat16* xp = x + (size_t)(m0 + m) * K + k0 + r * R;
        if constexpr (R == 1) {
          xv[m][0] = m0 + m < M ? __bfloat162float(*xp) : 0.f;
        } else {
#pragma unroll
          for (int f = 0; f < R; f += 2) {
            float lo = 0.f, hi = 0.f;
            if (m0 + m < M) {
              const __nv_bfloat162 v2 =
                  *reinterpret_cast<const __nv_bfloat162*>(xp + f);
              lo = __low2float(v2);
              hi = __high2float(v2);
            }
            xv[m][f] = lo;
            xv[m][f + 1] = hi;
          }
        }
      }
      const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t byte = (wv[q] >> (8 * b)) & 0xFFu;
          float v[R];
#pragma unroll
          for (int f = 0; f < R; ++f) v[f] = Fields<CODE>::at(byte, f);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            float t = xv[m][0] * v[0];
#pragma unroll
            for (int f = 1; f < R; ++f) t += xv[m][f] * v[f];
            acc[m][q * 4 + b] += t;
          }
        }
      }
    }
    // the chunk lies inside one group: scale its partial sum
    const int gi = k0 / group;
    const size_t srow = (size_t)gi * N + n0;
    const uint4 s01 = __ldg(reinterpret_cast<const uint4*>(scales + srow));
    const uint4 s23 = __ldg(reinterpret_cast<const uint4*>(scales + srow + 8));
    const uint32_t sv[8] = {s01.x, s01.y, s01.z, s01.w,
                            s23.x, s23.y, s23.z, s23.w};
    uint32_t zv[8];
    const bool first = ASYM && k0 % group == 0;   // the group's first chunk
    if (first) {
      const uint4 z01 = __ldg(reinterpret_cast<const uint4*>(zeros + srow));
      const uint4 z23 = __ldg(reinterpret_cast<const uint4*>(zeros + srow + 8));
      zv[0] = z01.x; zv[1] = z01.y; zv[2] = z01.z; zv[3] = z01.w;
      zv[4] = z23.x; zv[5] = z23.y; zv[6] = z23.z; zv[7] = z23.w;
    }
    const int G = K / group;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float s = bf16_bits(h ? sv[i] >> 16 : sv[i] & 0xFFFFu);
        float zs = 0.f;
        if (first)
          zs = __fmul_rn(bf16_bits(h ? zv[i] >> 16 : zv[i] & 0xFFFFu), s);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float a = acc[m][2 * i + h] * s;
          if (first && m0 + m < M)
            a -= xs[(size_t)(m0 + m) * G + gi] * zs;
          acc[m][2 * i + h] = a;
        }
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

template <int CODE, bool ASYM>
int launch(const void* x, const void* planes, const void* scales,
           const void* zeros, const void* xs, void* partial, void* out,
           int M, int K, int N, int group, int out_f32, int splits,
           void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 block(TX, TY);
  const int ntiles = (N + BLOCK_COLS - 1) / BLOCK_COLS;
  const auto* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  const auto* pb = reinterpret_cast<const uint8_t*>(planes);
  const auto* sb = reinterpret_cast<const __nv_bfloat16*>(scales);
  const auto* zb = reinterpret_cast<const __nv_bfloat16*>(zeros);
  const auto* xsf = reinterpret_cast<const float*>(xs);
  auto* part = reinterpret_cast<float*>(partial);
  if (M == 1) {
    qmm_native_partial<1, CODE, ASYM><<<dim3(ntiles, splits, 1), block, 0,
                                        st>>>(xb, pb, sb, zb, xsf, part, M, K,
                                              N, group);
  } else {
    qmm_native_partial<4, CODE, ASYM>
        <<<dim3(ntiles, splits, (M + 3) / 4), block, 0, st>>>(
            xb, pb, sb, zb, xsf, part, M, K, N, group);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long MN = (long long)M * N;
  qmm4_reduce<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(
      part, out, splits, MN, out_f32);
  return (int)cudaGetLastError();
}

}  // namespace

// One entry point per branch, so that the launch counts name it. zeros: bf16
// [K/group, N] shifted like the codes, xs: f32 [M, K/group]; both are
// ignored (pass null) by the symmetric entries.
#define K1_ENTRY(NAME, CODE, ASYM)                                           \
  extern "C" int NAME(const void* x, const void* planes, const void* scales, \
                      const void* zeros, const void* xs, void* partial,      \
                      void* out, int M, int K, int N, int group, int out_f32, \
                      int splits, void* stream) {                            \
    return launch<CODE, ASYM>(x, planes, scales, ASYM ? zeros : nullptr,     \
                              ASYM ? xs : nullptr, partial, out, M, K, N,    \
                              group, out_f32, splits, stream);               \
  }

K1_ENTRY(qmm4_npack, C_NIB, false)
K1_ENTRY(qmm4_npack_asym, C_NIB, true)
K1_ENTRY(qmm2_npack, C_INT2, false)
K1_ENTRY(qmm2_npack_asym, C_INT2, true)
K1_ENTRY(qmm8_native, C_INT8, false)
K1_ENTRY(qmm8_native_asym, C_INT8, true)
