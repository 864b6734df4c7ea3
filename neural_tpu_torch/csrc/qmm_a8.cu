// K2 qmm_a8: wNa8 GEMM for Hopper (int8 activations x int2/3/4/5-8 bit
// weights at rest).
//
// Replaces neural_tpu/ops/qmatmul.py:_qmm_a8_kernel (launched by
// _qmatmul_a8_pallas; picked by _pick_a8 for M >= 256, the prefill).
// Two launches:
//   1. quantize_act_i8: x [M, K] (bf16 or f32) -> int8 codes [M, K] and f32
//      scales [M, K/gd]; per row and gd-group, scale = (absmax + 1e-9)/127,
//      code = rint(x / scale) (IEEE division, round half to even). This is
//      bit-identical to ops/qmatmul.py quantize_act_i8 and to the TPU
//      kernel's in-kernel quantization, so one port kernel serves both of
//      the TPU's act-quant modes.
//   2. qmm_a8: per gd-group an int8 x int8 -> int32 dot on the tensor cores
//      (mma.sync m16n8k32 s8), then acc += d * (sa[m, g] * sw[g, n]) in f32,
//      rounded op by op (__fmul_rn/__fadd_rn, no contraction) in group
//      order, exactly as the plain version computes it.
//      qmm_a8_asym: asymmetric weights (centered nibbles, bf16 zero-points
//      shifted like them). The dots run over the centered codes and the
//      zero-points fold into the accumulator's start, as in the TPU kernel:
//      acc = -(xsa @ zwp), with xsa = sa * rowsum_gd(x_i8) [M, K/gd] and
//      zwp = z * sw [K/gd, N] in f32 from the wrapper. The kernel computes
//      that rank-K/gd product itself, in group order, before the K loop.
//
// The weight layouts at rest, one entry point each (``_asym`` beside each),
// as the TPU kernel reads them (neural_tpu/ops/qmatmul.py:248-260):
//   qmm_a8       native-pack nibbles, centered int4 or int3 codes, two a
//                byte (k = 2r low, 2r + 1 high): planes [K/2, N];
//   qmm_a8_int2  native-pack 2-bit fields, four a byte, LSB first:
//                planes [K/4, N];
//   qmm_a8_int8  centered int8 code planes of 5-8 bit weights: [K, N].
// Only the load of the weight tile differs: each widens its codes to int8
// in shared memory, [n][k], and the rest of the kernel is one body.
//
// What bounds it on the H100: the operations. At the 7B prefill shapes
// (M=1975) each weight byte is reused by ~2000 rows, far above the card's
// ops-per-byte balance, so the least time is 2*M*N*K int8 operations over
// the int8 tensor-core rate. This first kernel is the simple form: a 64x128
// block tile, 8 warps of 32x32, the int4 tile widened to int8 in shared
// memory one 128-deep K step at a time, no cp.async pipeline and no wgmma
// (those are later work). Ragged M is masked at the load and the store.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- act quant
__global__ void act_quant_kernel(const void* __restrict__ x, int x_f32,
                                 int8_t* __restrict__ xq,
                                 float* __restrict__ sa, int M, int K,
                                 int gd) {
  // one warp per (row, group)
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  const int Ga = K / gd;
  if (warp >= M * Ga) return;
  const int m = warp / Ga, ga = warp % Ga;
  const size_t base = (size_t)m * K + (size_t)ga * gd;
  float amax = 0.f;
  for (int i = lane; i < gd; i += 32) {
    const float v = x_f32
        ? reinterpret_cast<const float*>(x)[base + i]
        : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[base + i]);
    amax = fmaxf(amax, fabsf(v));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = __fdiv_rn(__fadd_rn(amax, 1e-9f), 127.0f);
  for (int i = lane; i < gd; i += 32) {
    const float v = x_f32
        ? reinterpret_cast<const float*>(x)[base + i]
        : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[base + i]);
    xq[base + i] = (int8_t)(int)rintf(__fdiv_rn(v, s));
  }
  if (lane == 0) sa[(size_t)m * Ga + ga] = s;
}

// ---------------------------------------------------------------- GEMM
constexpr int BM = 64, BN = 128, BK = 128;
constexpr int LDS = BK + 16;     // shared row stride in bytes

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t nib8(uint32_t byte, int hi) {
  // centered nibble -> int8 bit pattern
  const uint32_t n = hi ? (byte >> 4) & 0xFu : byte & 0xFu;
  return (uint32_t)(uint8_t)(int8_t)((int)(n ^ 8u) - 8);
}

__device__ __forceinline__ uint32_t f2x4(uint32_t byte) {
  // four centered 2-bit fields (LSB first) -> four int8 bit patterns
  uint32_t w = 0u;
#pragma unroll
  for (int f = 0; f < 4; ++f)
    w |= (uint32_t)(uint8_t)(int8_t)((int)(((byte >> (2 * f)) & 3u) ^ 2u) - 2)
         << (8 * f);
  return w;
}

enum Layout { NIBBLES = 0, INT2 = 1, INT8 = 2 };

// The weight tile of K rows k0 .. k0 + BK - 1 and columns n_base .. n_base +
// BN - 1, widened to int8 into Bs [n][k]. Each of the 256 threads reads 4
// neighbouring columns of a few byte rows as 32-bit words and writes each
// column's run of k as one 8- or 16-byte store.
template <int LAYOUT>
__device__ __forceinline__ void load_b(const uint8_t* __restrict__ planes,
                                       int8_t* Bs, int k0, int N,
                                       int n_base, int tid) {
  const int c4 = (tid % 32) * 4;
  if constexpr (LAYOUT == NIBBLES) {
    // 64 byte rows x 128 columns of nibbles; 4 byte rows = 8 k a thread
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int r0 = p * 32 + (tid / 32) * 4;      // byte row in the tile
      uint32_t wrow[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wrow[i] = *reinterpret_cast<const uint32_t*>(
            planes + (size_t)(k0 / 2 + r0 + i) * N + n_base + c4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t lo = 0u, hi = 0u;                  // k = 2*r0 .. 2*r0+7
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t b0 = (wrow[i] >> (8 * j)) & 0xFFu;
          const uint32_t b1 = (wrow[i + 2] >> (8 * j)) & 0xFFu;
          lo |= nib8(b0, 0) << (16 * i) | nib8(b0, 1) << (16 * i + 8);
          hi |= nib8(b1, 0) << (16 * i) | nib8(b1, 1) << (16 * i + 8);
        }
        *reinterpret_cast<uint2*>(Bs + (c4 + j) * LDS + 2 * r0) =
            make_uint2(lo, hi);
      }
    }
  } else if constexpr (LAYOUT == INT2) {
    // 32 byte rows x 128 columns of 2-bit fields; 4 byte rows = 16 k
    const int r0 = (tid / 32) * 4;
    uint32_t wrow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wrow[i] = *reinterpret_cast<const uint32_t*>(
          planes + (size_t)(k0 / 4 + r0 + i) * N + n_base + c4);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint4*>(Bs + (c4 + j) * LDS + 4 * r0) = make_uint4(
          f2x4((wrow[0] >> (8 * j)) & 0xFFu), f2x4((wrow[1] >> (8 * j)) & 0xFFu),
          f2x4((wrow[2] >> (8 * j)) & 0xFFu), f2x4((wrow[3] >> (8 * j)) & 0xFFu));
  } else {
    // 128 rows x 128 columns of int8 codes; 16 rows = 16 k a thread
    const int r0 = (tid / 32) * 16;
    uint32_t wrow[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      wrow[i] = *reinterpret_cast<const uint32_t*>(
          planes + (size_t)(k0 + r0 + i) * N + n_base + c4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {   // byte j of rows 4q .. 4q+3
        w[q] = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[q] |= ((wrow[4 * q + i] >> (8 * j)) & 0xFFu) << (8 * i);
      }
      *reinterpret_cast<uint4*>(Bs + (c4 + j) * LDS + r0) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <bool ASYM, int LAYOUT>
__global__ void __launch_bounds__(256)
qmm_a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sa,
              const uint8_t* __restrict__ planes,
              const __nv_bfloat16* __restrict__ scales,
              const float* __restrict__ zwp, const float* __restrict__ xsa,
              void* out, int M, int K, int N, int gd, int group,
              int out_f32) {
  __shared__ __align__(16) int8_t As[BM * LDS];   // [m][k]
  __shared__ __align__(16) int8_t Bs[BN * LDS];   // [n][k]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;          // warp tile 32 x 32
  const int g = lane >> 2, t = lane & 3;
  const int m_base = blockIdx.y * BM, n_base = blockIdx.x * BN;
  const int Ga = K / gd;

  float accf[2][4][4];
  int acci[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        accf[i][j][r] = 0.f;
        acci[i][j][r] = 0;
      }
  if constexpr (ASYM) {   // acc = -(xsa @ zwp) for this thread's elements
    for (int ga = 0; ga < Ga; ++ga) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int ra = m_base + wm * 32 + mt * 16 + g, rb = ra + 8;
        const float xa = ra < M ? xsa[(size_t)ra * Ga + ga] : 0.f;
        const float xb = rb < M ? xsa[(size_t)rb * Ga + ga] : 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c0 = n_base + wn * 32 + nt * 8 + t * 2;
          const float z0 = zwp[(size_t)ga * N + c0];
          const float z1 = zwp[(size_t)ga * N + c0 + 1];
          accf[mt][nt][0] -= xa * z0;
          accf[mt][nt][1] -= xa * z1;
          accf[mt][nt][2] -= xb * z0;
          accf[mt][nt][3] -= xb * z1;
        }
      }
    }
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A: 64 rows x 128 int8, 16-byte loads, rows past M are zero
    for (int i = tid; i < BM * BK / 16; i += 256) {
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      const int m = m_base + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M) v = *reinterpret_cast<const uint4*>(xq + (size_t)m * K + k0 + c);
      *reinterpret_cast<uint4*>(As + r * LDS + c) = v;
    }
    load_b<LAYOUT>(planes, Bs, k0, N, n_base, tid);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = wm * 32 + mt * 16 + g;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(As + row * LDS + kk + t * 4);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(As + (row + 8) * LDS + kk + t * 4);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(As + row * LDS + kk + 16 + t * 4);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(As + (row + 8) * LDS + kk + 16 + t * 4);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn * 32 + nt * 8 + g;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(Bs + col * LDS + kk + t * 4);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(Bs + col * LDS + kk + 16 + t * 4);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acci[mt][nt], a[mt], b[nt]);
    }

    if ((k0 + BK) % gd == 0) {       // end of a dot group: fold into f32
      const int ga = k0 / gd;
      const int gw = (ga * gd) / group;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int ra = m_base + wm * 32 + mt * 16 + g, rb = ra + 8;
        const float saa = ra < M ? sa[(size_t)ra * Ga + ga] : 0.f;
        const float sab = rb < M ? sa[(size_t)rb * Ga + ga] : 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c0 = n_base + wn * 32 + nt * 8 + t * 2;
          const float sw0 = __bfloat162float(scales[(size_t)gw * N + c0]);
          const float sw1 = __bfloat162float(scales[(size_t)gw * N + c0 + 1]);
          const float f[4] = {__fmul_rn(saa, sw0), __fmul_rn(saa, sw1),
                              __fmul_rn(sab, sw0), __fmul_rn(sab, sw1)};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            accf[mt][nt][r] = __fadd_rn(
                accf[mt][nt][r], __fmul_rn((float)acci[mt][nt][r], f[r]));
            acci[mt][nt][r] = 0;
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int ra = m_base + wm * 32 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c0 = n_base + wn * 32 + nt * 8 + t * 2;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = ra + (r >= 2 ? 8 : 0), col = c0 + (r & 1);
        if (row >= M) continue;
        const size_t o = (size_t)row * N + col;
        if (out_f32)
          reinterpret_cast<float*>(out)[o] = accf[mt][nt][r];
        else
          reinterpret_cast<__nv_bfloat16*>(out)[o] =
              __float2bfloat16(accf[mt][nt][r]);
      }
    }
  }
}

template <bool ASYM, int LAYOUT>
int launch(const void* xq, const void* sa, const void* planes,
           const void* scales, const void* zwp, const void* xsa, void* out,
           int M, int K, int N, int gd, int group, int out_f32,
           void* stream) {
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  qmm_a8_kernel<ASYM, LAYOUT><<<grid, 256, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int8_t*>(xq), reinterpret_cast<const float*>(sa),
      reinterpret_cast<const uint8_t*>(planes),
      reinterpret_cast<const __nv_bfloat16*>(scales),
      reinterpret_cast<const float*>(zwp), reinterpret_cast<const float*>(xsa),
      out, M, K, N, gd, group, out_f32);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int quantize_act_i8(const void* x, int x_f32, void* xq, void* sa,
                               int M, int K, int gd, void* stream) {
  const long long warps = (long long)M * (K / gd);
  const int threads = 256;
  const unsigned blocks = (unsigned)((warps * 32 + threads - 1) / threads);
  act_quant_kernel<<<blocks, threads, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      x, x_f32, reinterpret_cast<int8_t*>(xq), reinterpret_cast<float*>(sa),
      M, K, gd);
  return (int)cudaGetLastError();
}

// One sym and one asym entry point per layout. zwp: f32 [K/gd, N] = z * sw
// per dot group; xsa: f32 [M, K/gd].
#define QMM_A8_ENTRIES(NAME, LAYOUT)                                          \
  extern "C" int NAME(const void* xq, const void* sa, const void* planes,     \
                      const void* scales, void* out, int M, int K, int N,     \
                      int gd, int group, int out_f32, void* stream) {         \
    return launch<false, LAYOUT>(xq, sa, planes, scales, nullptr, nullptr,    \
                                 out, M, K, N, gd, group, out_f32, stream);   \
  }                                                                           \
  extern "C" int NAME##_asym(const void* xq, const void* sa,                  \
                             const void* planes, const void* scales,          \
                             const void* zwp, const void* xsa, void* out,     \
                             int M, int K, int N, int gd, int group,          \
                             int out_f32, void* stream) {                     \
    return launch<true, LAYOUT>(xq, sa, planes, scales, zwp, xsa, out, M, K,  \
                                N, gd, group, out_f32, stream);               \
  }

QMM_A8_ENTRIES(qmm_a8, NIBBLES)
QMM_A8_ENTRIES(qmm_a8_int2, INT2)
QMM_A8_ENTRIES(qmm_a8_int8, INT8)
