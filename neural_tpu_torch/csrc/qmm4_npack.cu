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
//
// The fused entry points (name + "_fused", symmetric only) are the TPU
// kernel's ``fuse`` options (qmatmul_fused), which fold a decode step's
// elementwise neighbours into the weight stream:
//   rms  (norm_w non-null) x is the raw residual stream; each row becomes
//        bf16(x * rsqrt(mean(x^2) + eps) * (w + offset)), f32 inside;
//   glu  (u non-null)      x is the gate input g, u the up input; the
//        product's input is bf16(act(g) * u), act in f32 (expf, erff,
//        tanhf: the precise library functions, not the intrinsics);
//   res  (res non-null)    the second pass adds a bf16 [M, N] residual to
//        the output as the unfused graph adds it: bf16(bf16(sum) + res).
// Each block stages the product's input for its own 512 K rows in shared
// memory as f32 (already rounded to bf16), so the prologue runs once per
// element and block, not once per thread that reads it. rms needs the
// whole row's mean square, and a block sees 512 of its K values: each
// block reads its rows in full (8 KB a row at K=4096, from L2, where the
// first blocks leave them) and reduces them in a fixed order, so every
// block of a launch computes the same scale. That costs M*K*2 bytes of L2
// reads per block and no extra launch, where a separate norm kernel costs
// a launch and an HBM round trip of its output.
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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// the fused prologue: PRO is a set of these bits
enum Pro { P_RMS = 1, P_GLU = 2 };
// the activations of the glu prologue, in f32, as torch computes them
enum Act { A_SILU = 0, A_GELU = 1, A_GELU_TANH = 2, A_RELU = 3 };

__device__ __forceinline__ float act_f32(float g, int act) {
  switch (act) {
    case A_SILU:
      return g / (1.f + expf(-g));
    case A_GELU:
      return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
    case A_GELU_TANH: {
      const float inner = 0.79788456080286536f * (g + 0.044715f * g * g * g);
      return 0.5f * g * (1.f + tanhf(inner));
    }
    default:
      return fmaxf(g, 0.f);
  }
}

// eight elements at o of the product's input before the norm: x, or
// bf16(act(g) * u), from one 16-byte load of each input
template <int PRO>
__device__ __forceinline__ void pro_in8(const __nv_bfloat16* __restrict__ x,
                                        const __nv_bfloat16* __restrict__ u,
                                        size_t o, int act, float v[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(x + o));
  const uint32_t av[4] = {a.x, a.y, a.z, a.w};
  uint32_t bv[4] = {0, 0, 0, 0};
  if constexpr ((PRO & P_GLU) != 0) {
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(u + o));
    bv[0] = b.x; bv[1] = b.y; bv[2] = b.z; bv[3] = b.w;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = bf16_bits((av[i / 2] >> (16 * (i % 2))) & 0xFFFFu);
    if constexpr ((PRO & P_GLU) != 0) {
      const float uv = bf16_bits((bv[i / 2] >> (16 * (i % 2))) & 0xFFFFu);
      v[i] = round_bf16(__fmul_rn(act_f32(v[i], act), uv));
    }
  }
}

struct Fuse {
  const __nv_bfloat16* u;   // glu: the up input [M, K] (x is the gate)
  const void* norm_w;       // rms: the norm weight [K], bf16 or f32
  int norm_f32;
  float eps, offset;
  int act;
  const __nv_bfloat16* res; // res: [M, N] bf16
};

constexpr int XS = TY * 33;          // staged K values a row, padded by one
                                     // float a chunk against bank conflicts

// The fused prologue of one block: rows m0.. m0+MT-1 of the product's
// input, K values split*512 .. +511, into xsh[m * XS + kk + kk / 32]. Every
// load is 16 bytes, and a thread issues all of its loads before it uses
// one: the prologue is latency, paid before the block's weight stream
// (which the caller has asked L2 to prefetch meanwhile).
template <int MT, int PRO>
__device__ void stage_input(const __nv_bfloat16* __restrict__ x,
                            const Fuse& f, float* xsh, int M, int K,
                            int m0, int split) {
  constexpr int NT = TX * TY;
  __shared__ float warp_ss[NT / 32][MT];
  __shared__ float rrow[MT];
  const int tid = threadIdx.y * TX + threadIdx.x;
  if constexpr ((PRO & P_RMS) != 0) {
    // the whole row's sum of squares, in a fixed order
    float ss[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) ss[m] = 0.f;
#pragma unroll 4
    for (int c = tid; c < K / 8; c += NT) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m0 + m >= M) continue;
        float v[8];
        pro_in8<PRO>(x, f.u, (size_t)(m0 + m) * K + (size_t)c * 8, f.act, v);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          ss[m] = __fadd_rn(ss[m], __fmul_rn(v[i], v[i]));
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v = ss[m];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
      if (tid % 32 == 0) warp_ss[tid / 32][m] = v;
    }
    __syncthreads();
    if (tid < MT) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) t += warp_ss[w][tid];
      rrow[tid] = rsqrtf(__fadd_rn(__fmul_rn(t, 1.f / (float)K), f.eps));
    }
    __syncthreads();
  }
  // the block's slice, eight elements a thread and pass
  constexpr int ITEMS = MT * TY * 32 / 8;
  const int kbase = split * (TY * 32);
#pragma unroll
  for (int it = 0; it < (ITEMS + NT - 1) / NT; ++it) {
    const int i = it * NT + tid;
    if (i >= ITEMS) break;
    const int m = i / (TY * 4), kk = (i % (TY * 4)) * 8, k = kbase + kk;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (m0 + m < M && k < K) {
      pro_in8<PRO>(x, f.u, (size_t)(m0 + m) * K + k, f.act, v);
      if constexpr ((PRO & P_RMS) != 0) {
        float w[8];
        if (f.norm_f32) {
          const float4* wp = reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(f.norm_w) + k);
          const float4 w0 = __ldg(wp), w1 = __ldg(wp + 1);
          w[0] = w0.x; w[1] = w0.y; w[2] = w0.z; w[3] = w0.w;
          w[4] = w1.x; w[5] = w1.y; w[6] = w1.z; w[7] = w1.w;
        } else {
          const uint4 wb = __ldg(reinterpret_cast<const uint4*>(
              reinterpret_cast<const __nv_bfloat16*>(f.norm_w) + k));
          const uint32_t wv[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            w[j] = bf16_bits((wv[j / 2] >> (16 * (j % 2))) & 0xFFFFu);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = round_bf16(__fmul_rn(__fmul_rn(v[j], rrow[m]),
                                      __fadd_rn(w[j], f.offset)));
      }
    }
    float* dst = xsh + m * XS + kk + kk / 32;
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j] = v[j];
  }
  __syncthreads();
}

template <int MT, int CODE, bool ASYM, int PRO>
__global__ void __launch_bounds__(TX * TY)
qmm_native_partial(const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ planes,
                   const __nv_bfloat16* __restrict__ scales,
                   const __nv_bfloat16* __restrict__ zeros,
                   const float* __restrict__ xs, float* __restrict__ partial,
                   int M, int K, int N, int group, Fuse fuse) {
  constexpr int R = Fields<CODE>::R;
  constexpr int BR = 32 / R;             // byte rows per 32-row chunk
  __shared__ float red[TY][MT][BLOCK_COLS];
  __shared__ float xsh[PRO ? MT * XS : 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n0 = blockIdx.x * BLOCK_COLS + tx * COLS;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int k0 = (split * TY + ty) * 32;    // first K row of the chunk
  if constexpr (PRO != 0) {
    // ask L2 for the block's weight rows, one 128-byte line a row, so the
    // stream's first loads do not wait behind the prologue
    if (n0 < N && k0 < K) {
      const uint8_t* wl = planes + (size_t)(k0 / R) * N +
                          blockIdx.x * BLOCK_COLS;
      for (int r = tx; r < BR; r += TX)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(wl + (size_t)r * N));
    }
    stage_input<MT, PRO>(x, fuse, xsh, M, K, m0, split);
  }

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
        if constexpr (PRO != 0) {
#pragma unroll
          for (int f = 0; f < R; ++f)
            xv[m][f] = xsh[m * XS + ty * 33 + r * R + f];
        } else if constexpr (R == 1) {
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

// the splits added in a fixed order; with res, the residual added as the
// unfused graph adds it (a bf16 sum of two bf16 values)
__global__ void qmm4_reduce(const float* __restrict__ partial, void* out,
                            const __nv_bfloat16* __restrict__ res,
                            int splits, long long MN, int out_f32) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[(size_t)p * MN + i];
  if (out_f32) {
    if (res != nullptr) s = __fadd_rn(s, __bfloat162float(res[i]));
    reinterpret_cast<float*>(out)[i] = s;
  } else {
    __nv_bfloat16 o = __float2bfloat16(s);
    if (res != nullptr)
      o = __float2bfloat16(
          __fadd_rn(__bfloat162float(o), __bfloat162float(res[i])));
    reinterpret_cast<__nv_bfloat16*>(out)[i] = o;
  }
}

template <int MT, int CODE, bool ASYM>
void launch_partial(int pro, dim3 grid, cudaStream_t st,
                    const __nv_bfloat16* xb, const uint8_t* pb,
                    const __nv_bfloat16* sb, const __nv_bfloat16* zb,
                    const float* xsf, float* part, int M, int K, int N,
                    int group, const Fuse& f) {
  const dim3 block(TX, TY);
#define K1_PARTIAL(P)                                                      \
  qmm_native_partial<MT, CODE, ASYM, P><<<grid, block, 0, st>>>(           \
      xb, pb, sb, zb, xsf, part, M, K, N, group, f)
  if constexpr (ASYM) {
    K1_PARTIAL(0);
  } else {
    switch (pro) {
      case P_RMS: K1_PARTIAL(P_RMS); break;
      case P_GLU: K1_PARTIAL(P_GLU); break;
      case P_RMS | P_GLU: K1_PARTIAL(P_RMS | P_GLU); break;
      default: K1_PARTIAL(0);
    }
  }
#undef K1_PARTIAL
}

template <int CODE, bool ASYM>
int launch(const void* x, const void* planes, const void* scales,
           const void* zeros, const void* xs, void* partial, void* out,
           int M, int K, int N, int group, int out_f32, int splits,
           void* stream, const Fuse& f) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int ntiles = (N + BLOCK_COLS - 1) / BLOCK_COLS;
  const auto* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  const auto* pb = reinterpret_cast<const uint8_t*>(planes);
  const auto* sb = reinterpret_cast<const __nv_bfloat16*>(scales);
  const auto* zb = reinterpret_cast<const __nv_bfloat16*>(zeros);
  const auto* xsf = reinterpret_cast<const float*>(xs);
  auto* part = reinterpret_cast<float*>(partial);
  const int pro = (f.norm_w != nullptr ? P_RMS : 0) |
                  (f.u != nullptr ? P_GLU : 0);
  if (M == 1)
    launch_partial<1, CODE, ASYM>(pro, dim3(ntiles, splits, 1), st, xb, pb,
                                  sb, zb, xsf, part, M, K, N, group, f);
  else
    launch_partial<4, CODE, ASYM>(pro, dim3(ntiles, splits, (M + 3) / 4), st,
                                  xb, pb, sb, zb, xsf, part, M, K, N, group,
                                  f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long MN = (long long)M * N;
  qmm4_reduce<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(
      part, out, f.res, splits, MN, out_f32);
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
                              group, out_f32, splits, stream, Fuse{});       \
  }

K1_ENTRY(qmm4_npack, C_NIB, false)
K1_ENTRY(qmm4_npack_asym, C_NIB, true)
K1_ENTRY(qmm2_npack, C_INT2, false)
K1_ENTRY(qmm2_npack_asym, C_INT2, true)
K1_ENTRY(qmm8_native, C_INT8, false)
K1_ENTRY(qmm8_native_asym, C_INT8, true)

// The fused entry points, symmetric only: x is the raw residual stream when
// norm_w is set (bf16 [K], or f32 with norm_f32), the gate input when u is
// set (act: 0 silu, 1 gelu, 2 tanh gelu, 3 relu); res is a bf16 [M, N]
// residual added to the output, or null.
#define K1_FUSED(NAME, CODE)                                                 \
  extern "C" int NAME(const void* x, const void* u, const void* norm_w,      \
                      int norm_f32, float eps, float offset, int act,        \
                      const void* res, const void* planes,                   \
                      const void* scales, void* partial, void* out, int M,   \
                      int K, int N, int group, int out_f32, int splits,      \
                      void* stream) {                                        \
    const Fuse f{reinterpret_cast<const __nv_bfloat16*>(u), norm_w,          \
                 norm_f32, eps, offset, act,                                 \
                 reinterpret_cast<const __nv_bfloat16*>(res)};               \
    return launch<CODE, false>(x, planes, scales, nullptr, nullptr, partial, \
                               out, M, K, N, group, out_f32, splits, stream, \
                               f);                                           \
  }

K1_FUSED(qmm4_npack_fused, C_NIB)
K1_FUSED(qmm2_npack_fused, C_INT2)
K1_FUSED(qmm8_native_fused, C_INT8)
