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
//      (wgmma m64n128k32 s8), then acc += d * (sa[m, g] * sw[g, n]) in f32,
//      rounded op by op (__fmul_rn/__fadd_rn, no contraction) in group
//      order, exactly as the plain version computes it: the same bits as
//      the plain version, and as the mma.sync kernel this one replaced.
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
// Only the widening of the weight tile differs; the rest is one body.
//
// What bounds it on the H100: the operations. At the 7B prefill shapes
// (M=1975) each weight byte is reused by ~2000 rows, far above the card's
// ops-per-byte balance, so the least time is 2*M*N*K int8 operations over
// the int8 tensor-core rate. The design: a 128 x 128 block tile, two
// warpgroups of 64 rows, 128-deep K tiles. One thread stages each tile by
// TMA into a ring of 4 stages (x codes with the 128-byte swizzle, the
// weight tile's raw bytes as they lie at rest, its scale row), completing
// on an mbarrier, two tiles ahead. All threads widen each weight tile once
// to int8 [n][k] in the wgmma layout (three buffers: one barrier a tile),
// and the warpgroups run wgmma on it. A dot group's int32 sums live in one
// of two register sets, so a group's fold reads a finished set. The fold
// (5 f32 operations an output and group, kept for exactness) is the
// largest cost left beside the tensor cores, and the x tile's L2 reads the
// next (it is re-read by every 128-column block). Ragged M is zero-filled
// by TMA and masked at the store.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "qmm_tc.cuh"

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
enum Layout { NIBBLES = 0, INT2 = 1, INT8 = 2 };

constexpr int BM = 128, BN = 128, BK = 128, THREADS = 256, STAGES = 4;
constexpr int SBO = qmm_tc::cm_sbo(BK);     // the weight tile: 128 int8 of K
constexpr int OP_BYTES = (BN / 8) * SBO;    // one widened weight tile

// One stage of the ring, filled by TMA: the x codes of the block's 128
// rows (the wgmma layout with the 128-byte swizzle), the weight tile's raw
// bytes as they lie at rest [rows][BN] and the tile's bf16 weight-scale
// row. TX: the bytes its copies bring.
template <int LAYOUT>
struct Stage {
  static constexpr int RAW_ROWS =
      LAYOUT == NIBBLES ? BK / 2 : LAYOUT == INT2 ? BK / 4 : BK;
  static constexpr int RAW = BM * BK;
  static constexpr int SW = RAW + RAW_ROWS * BN;
  static constexpr int BYTES = (SW + BN * 2 + 1023) / 1024 * 1024;
  static constexpr int TX = BM * BK + RAW_ROWS * BN + BN * 2;
};

// the ring, three widened weight tiles, and room to align the ring to
// 1024 bytes (the swizzle's)
template <int LAYOUT>
constexpr int smem_bytes() {
  return STAGES * Stage<LAYOUT>::BYTES + 3 * OP_BYTES + 1024;
}

struct A8Params {
  const int8_t* xq;
  const float* sa;
  const uint8_t* planes;
  const __nv_bfloat16* scales;
  const float* zwp;
  const float* xsa;
  void* out;
  int M, K, N, gd, group, out_f32;
  // the tensor maps of the x codes (128-byte swizzle), the weight bytes
  // and the weight scales
  CUtensorMap mx, mw, msw;
};

// Stage tile kt (one thread): x codes, weight bytes and scale row by TMA,
// completing on the stage's barrier.
template <int LAYOUT>
__device__ __forceinline__ void issue_stage(const A8Params& p, uint8_t* st,
                                            uint64_t* bar, int kt,
                                            int m_base, int n_base) {
  using S = Stage<LAYOUT>;
  const int k0 = kt * BK;
  qmm_tc::mbar_expect(bar, S::TX);
  qmm_tc::tma_load(st, &p.mx, k0, m_base, bar);
  qmm_tc::tma_load(st + S::RAW, &p.mw, n_base,
                   LAYOUT == NIBBLES ? k0 / 2 : LAYOUT == INT2 ? k0 / 4 : k0,
                   bar);
  qmm_tc::tma_load(st + S::SW, &p.msw, n_base, k0 / p.group, bar);
}

// four centered 4- or 2-bit fields, one a byte, sign-extended to int8
__device__ __forceinline__ uint32_t sext4(uint32_t v) {
  return v | ((v & 0x08080808u) * 0x1Eu);
}
__device__ __forceinline__ uint32_t sext2(uint32_t v) {
  return v | ((v & 0x02020202u) * 0x7Fu);
}

// the 4 x 4 byte transpose: out[j] = (a.j, b.j, c.j, d.j), byte 0 first
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b,
                                           uint32_t c, uint32_t d,
                                           uint32_t* out) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140), t1 = __byte_perm(a, b, 0x7362);
  const uint32_t t2 = __byte_perm(c, d, 0x5140), t3 = __byte_perm(c, d, 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// Widen the stage's raw weight bytes to int8 in the wgmma layout [n][k].
// Warp w takes K rows 16 w .. 16 w + 15 of the tile, lane q columns 4 q ..
// 4 q + 3: it reads one 32-bit word (4 columns) of each byte row, forms
// for each run of 4 K rows four words of 4 columns, transposes them into
// 4 K values of each column, and stores each column's 16 K values as one
// 16-byte run.
template <int LAYOUT>
__device__ __forceinline__ void widen(const uint8_t* st, uint8_t* op,
                                      int tid) {
  const int w = tid / 32, q = tid % 32;
  const uint8_t* raw = st + Stage<LAYOUT>::RAW + 4 * q;
  auto word = [&](int row) {
    return *reinterpret_cast<const uint32_t*>(raw + row * BN);
  };
  uint32_t o[4][4];                         // o[b][j]: column j, K 4b .. 4b+3
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    uint32_t v[4];
    if constexpr (LAYOUT == NIBBLES) {      // byte row r: K 2r low, 2r+1 high
      const uint32_t r0 = word(8 * w + 2 * b), r1 = word(8 * w + 2 * b + 1);
      v[0] = sext4(r0 & 0x0F0F0F0Fu);
      v[1] = sext4((r0 >> 4) & 0x0F0F0F0Fu);
      v[2] = sext4(r1 & 0x0F0F0F0Fu);
      v[3] = sext4((r1 >> 4) & 0x0F0F0F0Fu);
    } else if constexpr (LAYOUT == INT2) {  // byte row r: K 4r + f at bits 2f
      const uint32_t r0 = word(4 * w + b);
#pragma unroll
      for (int f = 0; f < 4; ++f) v[f] = sext2((r0 >> (2 * f)) & 0x03030303u);
    } else {                                // byte row r: K r
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = word(16 * w + 4 * b + i);
    }
    transpose4(v[0], v[1], v[2], v[3], o[b]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<uint4*>(op + qmm_tc::cm_off(4 * q + j, 16 * w, SBO)) =
        make_uint4(o[0][j], o[1][j], o[2][j], o[3][j]);
}

// an integer dot of one group as f32, exactly: |d| < 2^22 for the nibble
// and int2 layouts (gd <= 512), so the float with d added to 1.5 * 2^23
// in its mantissa, less 1.5 * 2^23; int8 codes at gd = 512 can pass 2^22
template <int LAYOUT>
__device__ __forceinline__ float dot_f32(int d) {
  if constexpr (LAYOUT == INT8) {
    return __int2float_rn(d);
  } else {
    return __fsub_rn(__int_as_float(d + 0x4B400000), 12582912.0f);
  }
}

template <bool ASYM, int LAYOUT>
__global__ void __launch_bounds__(THREADS, 1)
qmm_a8_kernel(const __grid_constant__ A8Params p) {
  using S = Stage<LAYOUT>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ float fold[3][BN];            // a dot group's weight scales
  uint8_t* smem = smem_raw + ((1024 - (qmm_tc::smem_u32(smem_raw) & 1023)) &
                              1023);
  uint8_t* ops = smem + STAGES * S::BYTES;
  const int tid = threadIdx.x, wg = tid / 128, wi = (tid / 32) % 4;
  const int lane = tid % 32;
  const int m_base = blockIdx.y * BM, n_base = blockIdx.x * BN;
  const int Ga = p.K / p.gd, KT = p.K / BK, tpg = p.gd / BK;
  // this thread's accumulator rows ra, ra + 8 of the tile and columns
  // 8 j + cq, 8 j + cq + 1 (j = 0 .. 15)
  const int ra = wg * 64 + wi * 16 + lane / 4, cq = 2 * (lane % 4);
  const int rA = m_base + ra, rB = rA + 8;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) qmm_tc::mbar_init(&full[s], 1);
    qmm_tc::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < STAGES - 2 && t < KT; ++t)
      issue_stage<LAYOUT>(p, smem + t * S::BYTES, &full[t], t, m_base,
                          n_base);

  float accf[64];
  int acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    accf[i] = 0.f;
    acc0[i] = 0;
    acc1[i] = 0;
  }
  if constexpr (ASYM) {   // acc = -(xsa @ zwp), in group order
#pragma unroll 4
    for (int ga = 0; ga < Ga; ++ga) {
      const float xa = rA < p.M ? p.xsa[(size_t)rA * Ga + ga] : 0.f;
      const float xb = rB < p.M ? p.xsa[(size_t)rB * Ga + ga] : 0.f;
      const float* zr = p.zwp + (size_t)ga * p.N + n_base + cq;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 z = *reinterpret_cast<const float2*>(zr + 8 * j);
        accf[4 * j] -= xa * z.x;
        accf[4 * j + 1] -= xa * z.y;
        accf[4 * j + 2] -= xb * z.x;
        accf[4 * j + 3] -= xb * z.y;
      }
    }
  }
  const uint32_t sbase = qmm_tc::smem_u32(smem), obase = qmm_tc::smem_u32(ops);

  // acc += d * (sa * sw) for the group whose dots d holds, rounded op by op
  auto fold_group = [&](int (&d)[64], const float (&sa)[2], const float* sw) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 w = *reinterpret_cast<const float2*>(sw + 8 * j + cq);
      const float f[4] = {__fmul_rn(sa[0], w.x), __fmul_rn(sa[0], w.y),
                          __fmul_rn(sa[1], w.x), __fmul_rn(sa[1], w.y)};
#pragma unroll
      for (int r = 0; r < 4; ++r)
        accf[4 * j + r] = __fadd_rn(
            accf[4 * j + r], __fmul_rn(dot_f32<LAYOUT>(d[4 * j + r]), f[r]));
    }
  };

  // Tile kt, the t-th of dot group G: widen its weights; one barrier;
  // stage tile kt + STAGES - 2 into the slot of tile kt - 2; issue kt's
  // wgmmas into the group's integer accumulator `cur` and wait for them;
  // on a group's first tile, fold the previous group's accumulator `prev`.
  // The act scales of a group are read on its first tile, into registers,
  // and used at its fold one group later; the widened tiles and the
  // weight scales kept for the fold rotate over three buffers, free once
  // every thread is two tiles further.
  auto tile = [&](int kt, int t, int G, int (&cur)[64], int (&prev)[64],
                  float (&sa_cur)[2], const float (&sa_prev)[2]) {
    const int slot = kt % STAGES;
    const uint8_t* st = smem + slot * S::BYTES;
    if (t == 0) {
      sa_cur[0] = rA < p.M ? p.sa[(size_t)rA * Ga + G] : 0.f;
      sa_cur[1] = rB < p.M ? p.sa[(size_t)rB * Ga + G] : 0.f;
    }
    qmm_tc::mbar_wait(&full[slot], (kt / STAGES) & 1);
    widen<LAYOUT>(st, ops + (kt % 3) * OP_BYTES, tid);
    if (t == tpg - 1 && tid < BN)
      fold[G % 3][tid] = __bfloat162float(
          reinterpret_cast<const __nv_bfloat16*>(st + S::SW)[tid]);
    qmm_tc::fence_proxy_async();
    __syncthreads();
    if (tid == 0 && kt + STAGES - 2 < KT)
      issue_stage<LAYOUT>(p, smem + ((kt + STAGES - 2) % STAGES) * S::BYTES,
                          &full[(kt + STAGES - 2) % STAGES], kt + STAGES - 2,
                          m_base, n_base);
    qmm_tc::fence_acc(cur);
    qmm_tc::wgmma_fence();
    const uint32_t a0 = sbase + slot * S::BYTES + wg * 64 * BK;
    const uint32_t b0 = obase + (kt % 3) * OP_BYTES;
#pragma unroll
    for (int s = 0; s < BK / 32; ++s)
      qmm_tc::wgmma_s8_n128(cur, qmm_tc::desc_sw128(a0 + 32 * s),
                            qmm_tc::desc(b0 + 256 * s, 128, SBO),
                            (t > 0 || s > 0) ? 1 : 0);
    qmm_tc::wgmma_commit();
    qmm_tc::wgmma_wait<0>();
    qmm_tc::fence_acc(cur);
    if (t == 0 && G > 0) {
      qmm_tc::fence_acc(prev);
      fold_group(prev, sa_prev, fold[(G - 1) % 3]);
    }
  };

  float sa0[2] = {0.f, 0.f}, sa1[2] = {0.f, 0.f};
  const int NG = Ga;
  for (int G = 0; G < NG; G += 2) {
    for (int t = 0; t < tpg; ++t) tile(G * tpg + t, t, G, acc0, acc1, sa0,
                                       sa1);
    if (G + 1 < NG)
      for (int t = 0; t < tpg; ++t) tile((G + 1) * tpg + t, t, G + 1, acc1,
                                         acc0, sa1, sa0);
  }
  qmm_tc::wgmma_wait<0>();
  qmm_tc::fence_acc(acc0);
  qmm_tc::fence_acc(acc1);
  if ((NG - 1) & 1)
    fold_group(acc1, sa1, fold[(NG - 1) % 3]);
  else
    fold_group(acc0, sa0, fold[(NG - 1) % 3]);

#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n_base + 8 * j + cq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m_base + ra + 8 * h;
      if (row >= p.M) continue;
      const size_t o = (size_t)row * p.N + col;
      const float v0 = accf[4 * j + 2 * h], v1 = accf[4 * j + 2 * h + 1];
      if (p.out_f32)
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(p.out) + o) =
            make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(
            reinterpret_cast<__nv_bfloat16*>(p.out) + o) =
            __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <bool ASYM, int LAYOUT>
int launch(const void* xq, const void* sa, const void* planes,
           const void* scales, const void* zwp, const void* xsa, void* out,
           int M, int K, int N, int gd, int group, int out_f32,
           void* stream) {
  using S = Stage<LAYOUT>;
  static bool attr_set = false;
  constexpr int smem = smem_bytes<LAYOUT>();
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_a8_kernel<ASYM, LAYOUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  A8Params p;
  p.xq = reinterpret_cast<const int8_t*>(xq);
  p.sa = reinterpret_cast<const float*>(sa);
  p.planes = reinterpret_cast<const uint8_t*>(planes);
  p.scales = reinterpret_cast<const __nv_bfloat16*>(scales);
  p.zwp = reinterpret_cast<const float*>(zwp);
  p.xsa = reinterpret_cast<const float*>(xsa);
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.gd = gd;
  p.group = group;
  p.out_f32 = out_f32;
  const int prow = LAYOUT == NIBBLES ? K / 2 : LAYOUT == INT2 ? K / 4 : K;
  using qmm_tc::make_map;
  if (!make_map(&p.mx, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, M, K, BK, BM,
                true) ||
      !make_map(&p.mw, planes, CU_TENSOR_MAP_DATA_TYPE_UINT8, N, prow, N, BN,
                S::RAW_ROWS, false) ||
      !make_map(&p.msw, scales, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, N,
                K / group, (long long)N * 2, BN, 1, false))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  qmm_a8_kernel<ASYM, LAYOUT><<<grid, THREADS, smem,
                                reinterpret_cast<cudaStream_t>(stream)>>>(p);
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
