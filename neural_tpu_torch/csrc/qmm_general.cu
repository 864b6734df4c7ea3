// K5 qmm_general: the general dequant GEMM for Hopper.
//
// Replaces neural_tpu/ops/qmatmul.py:_qmm_kernel (launched by
// _qmatmul_pallas; its tile dequant is _dequant_tile):
//     out[M, N] = bf16(x)[M, K] @ W,
// where each weight element is taken in f32 (code minus its zero-point, a
// 16-entry table value, an fp8 value, or +-1), multiplied by its group's
// scale widened to f32 and rounded once to bf16 (__float2bfloat16_rn); the
// product of two bf16 values is summed in f32 and cast to bf16 or f32 at
// the end. One entry point takes every weight layout of the port, chosen
// by a template parameter:
//   PLANES  chunk-local bit planes of 1-8 bit codes (widths from {4, 2, 1},
//           or one 8-bit plane; code = sum(plane << shift)): int sym
//           (code - 2^(b-1)), int asym (code - zero-point), int1 (2 code -
//           1) and nf4/fp4 (table lookup);
//   NPACK4  native-pack nibbles (centered int3/int4, two per byte, LSB
//           first), NPACK2 native-pack int2 (four fields per byte);
//   INT8    centered int8 code planes (5-8 bit at rest);
//   FP8     e4m3 or e5m2 bytes, widened by cuda_fp8.h (infinities and NaNs
//           kept, as ml_dtypes does).
// Scales are f32 or bf16 [G, N]; zero-points none, uint8, bf16 or f32.
//
// What bounds it on the H100: at M <= 16 (decode) the weight bytes; at the
// 1975-token prefill the bf16 operations. The entry point picks one of two
// bodies by M:
//
// gemv (M <= 16), on K1's streaming pattern: a block of 8 x 32 threads
// covers 128 columns and 512 K rows; each thread reads 16 neighbouring
// columns of 16 K rows with one 16-byte load a plane and row (neighbouring
// threads on neighbouring columns, 8 rows' loads in flight), dequantizes
// them in registers, rounds each weight to bf16 and multiplies it by
// bf16(x), staged in shared memory, in f32. No weight tile in shared
// memory and no tensor-core tile with empty rows. The 512-row splits write
// f32 partials that a second pass adds in a fixed order.
//
// tc (M > 16): 256 threads, two warpgroups, a BM x 128 output tile (BM =
// 128 rows for M <= 128, else 256: each weight tile's dequant is shared by
// that many rows) over 64-deep K tiles. One thread stages each tile by TMA
// into a ring of 4 stages in dynamic shared memory, two tiles ahead: the
// bf16 x tile with the 128-byte swizzle wgmma reads, and the weight tile's
// raw bytes as the layout stores them with its scale and zero-point rows,
// all completing on the stage's mbarrier. Each K tile is dequantized once,
// by all threads, into a bf16 operand tile [n][k] (three buffers, one
// barrier a tile); the warpgroups then issue wgmma m64n128k16 on it and on
// the x tile, and the threads dequantize the next tile while the tensor
// cores work. Few output tiles (M = 128, N = 4096) would leave SMs idle,
// so K is split as well: the splits write f32 partials, added by the same
// second pass. No atomics: reruns are bit-identical. What holds it back:
// the dequant's integer addressing and the x tile's L2 reads (re-read by
// every 128-column block) add up rather than overlap.
//
// The compile-time layout (Lay) splits the bit-plane format three ways:
// one 4-bit plane of table indices (nf4/fp4), one 1-bit plane (int1), and
// the rest, so that the decode formats' dequant is a shift, a mask and a
// table read.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include "qmm_tc.cuh"

namespace {

// The kernels' template parameter: the layout (the C entry point's fmt,
// 0-4), with the two bit-plane cases of the decode paths (one 4-bit plane
// of table indices: nf4/fp4; one 1-bit plane: int1) apart from the general
// one, so that their decode is a shift, a mask and a table read
enum Lay { L_PLANES = 0, L_NPACK4 = 1, L_NPACK2 = 2, L_INT8 = 3, L_FP8 = 4,
           L_LUT4 = 5, L_ONEBIT = 6 };

__host__ __device__ constexpr bool is_planes(int L) {
  return L == L_PLANES || L == L_LUT4 || L == L_ONEBIT;
}
enum VMode { V_INT = 0, V_ONEBIT = 1, V_LUT = 2 };
enum ZKind { Z_NONE = 0, Z_U8 = 1, Z_BF16 = 2, Z_F32 = 3 };

constexpr int BN = 128;                 // output columns a block (both)
constexpr int BK = 64;                  // tc: K rows a tile
constexpr int THREADS = 256;            // tc
constexpr int STAGES = 4;               // tc
constexpr int SBO = qmm_tc::cm_sbo(BK * 2);   // tc: 64 bf16 of K a row
constexpr int OP_BYTES = (BN / 8) * SBO;      // tc: one bf16 weight tile
constexpr int GX = 8, GY = 32;          // gemv: threads along N and K
constexpr int GCOLS = 16, GROWS = 16;   // gemv: columns and K rows a thread
constexpr int GK = GY * GROWS;          // gemv: K rows a block (512)
constexpr int SMEM_OPTIN = 227 * 1024;

struct Params {
  const __nv_bfloat16* x;
  const uint8_t* pl[3];        // planes
  int pw[3], psh[3], np;       // plane widths and left shifts (bit planes)
  const void* scales;
  const void* zeros;
  const float* lut;
  void* out;
  float* partial;
  int M, K, N, group, chunk;
  int vmode, scale_f32, zkind, fp8_e5m2, out_f32, kps;
  float zconst;                // the zero-point when zkind is Z_NONE
  // log2 of the chunk, of each plane's byte rows a chunk (sub) and of the
  // group where they are powers of two, else -1
  int chunk_sh, sub[3], sub_sh[3], group_sh;
  // tc: the stage's layout in bytes (the x tile at 0, planes, scale rows,
  // zero rows, the stage's header of each plane's first byte row), its
  // size, and the bytes its copies bring
  int st_pl[3], st_s, st_z, st_hdr, st_bytes, tx_bytes;
  // tc: the tensor maps of x (128-byte swizzle), the planes, the scales
  // and the zero-points
  CUtensorMap mx, mpl[3], ms, mz;
};

__host__ __device__ inline int udiv(int a, int d, int sh) {
  return sh >= 0 ? a >> sh : a / d;
}

// Byte rows [lo, hi) of a chunk-local plane of width pw that hold K rows
// [k0, k1): K row k = g * chunk + c * sub + r lies in byte row g * sub + r
// (sub = chunk * pw / 8). Chunks occupy consecutive byte rows, so the
// window runs from the least row used in the first chunk to the greatest
// in the last. csh, ssh: log2 of chunk and sub, or -1.
__host__ __device__ inline void plane_window(int k0, int k1, int chunk,
                                             int csh, int pw, int ssh,
                                             int& lo, int& hi) {
  if (pw == 8) {
    lo = k0;
    hi = k1;
    return;
  }
  const int sub = chunk * pw / 8;
  auto mod = [&](int a) { return ssh >= 0 ? a & (sub - 1) : a % sub; };
  const int g0 = udiv(k0, chunk, csh), g1 = udiv(k1 - 1, chunk, csh);
  const int a0 = k0 - g0 * chunk, e0 = g0 == g1 ? k1 - 1 - g0 * chunk
                                                : chunk - 1;
  const bool all0 = e0 - a0 + 1 >= sub || mod(a0) > mod(e0);
  lo = g0 * sub + (all0 ? 0 : mod(a0));
  const int a1 = g0 == g1 ? a0 : 0, e1 = k1 - 1 - g1 * chunk;
  const bool all1 = e1 - a1 + 1 >= sub || mod(a1) > mod(e1);
  hi = g1 * sub + (all1 ? sub : mod(e1) + 1);
}

// the byte row of plane i holding K row k, and the field's bit offset
template <int L>
__device__ __forceinline__ void plane_row(const Params& p, int i, int k,
                                          int& row, int& off) {
  if constexpr (is_planes(L)) {
    if (L == L_PLANES && p.pw[i] == 8) {
      row = k;
      off = 0;
    } else {
      const int gi = udiv(k, p.chunk, p.chunk_sh);
      const int kin = k - gi * p.chunk;
      const int c = udiv(kin, p.sub[i], p.sub_sh[i]);
      row = gi * p.sub[i] + kin - c * p.sub[i];
      off = (L == L_LUT4 ? 4 : L == L_ONEBIT ? 1 : p.pw[i]) * c;
    }
  } else if constexpr (L == L_NPACK4) {
    row = k >> 1;
    off = 4 * (k & 1);
  } else if constexpr (L == L_NPACK2) {
    row = k >> 2;
    off = 2 * (k & 3);
  } else {
    row = k;
    off = 0;
  }
}

// One weight's value before its scale, _dequant_tile's arithmetic: b[i]
// is the byte of plane i that holds it, at bit offset off[i]
template <int L>
__device__ __forceinline__ float code_value(const Params& p,
                                            const uint32_t* b,
                                            const int* off, float z,
                                            const float* lut) {
  if constexpr (L == L_LUT4) {
    return lut[(b[0] >> off[0]) & 0xFu];
  } else if constexpr (L == L_ONEBIT) {
    return ((b[0] >> off[0]) & 1u) ? 1.f : -1.f;   // 2 code - 1
  } else if constexpr (L == L_PLANES) {
    uint32_t code = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (i < p.np)
        code |= ((b[i] >> off[i]) & ((1u << p.pw[i]) - 1u)) << p.psh[i];
    if (p.vmode == V_LUT) return lut[code];
    if (p.vmode == V_ONEBIT) return __fsub_rn((float)(2 * code), 1.f);
    return __fsub_rn((float)code, z);
  } else if constexpr (L == L_NPACK4) {
    const uint32_t f = (b[0] >> off[0]) & 0xFu;
    return __fsub_rn((float)((int)(f ^ 8u) - 8), z);
  } else if constexpr (L == L_NPACK2) {
    const uint32_t f = (b[0] >> off[0]) & 0x3u;
    return __fsub_rn((float)((int)(f ^ 2u) - 2), z);
  } else if constexpr (L == L_INT8) {
    return __fsub_rn((float)(int8_t)b[0], z);
  } else {
    const __half_raw hr = __nv_cvt_fp8_to_halfraw(
        (__nv_fp8_storage_t)b[0], p.fp8_e5m2 ? __NV_E5M2 : __NV_E4M3);
    return __half2float(__half(hr));
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// the scales and zero-points of C neighbouring columns (C a multiple of 4)
// starting at element e (a multiple of 4) of [G, N] arrays at sbase and
// zbase, in 16-, 8- or 4-byte loads
template <int C>
__device__ __forceinline__ void load_sz(const Params& p, const void* sbase,
                                        const void* zbase, size_t e,
                                        float* s, float* z) {
#pragma unroll
  for (int j = 0; j < C; j += 4) {
    if (p.scale_f32) {
      const float4 v = *reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(sbase) + e + j);
      s[j] = v.x; s[j + 1] = v.y; s[j + 2] = v.z; s[j + 3] = v.w;
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(
          reinterpret_cast<const __nv_bfloat16*>(sbase) + e + j);
      s[j] = bf16_lo(v.x); s[j + 1] = bf16_hi(v.x);
      s[j + 2] = bf16_lo(v.y); s[j + 3] = bf16_hi(v.y);
    }
    if (p.zkind == Z_U8) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(
          reinterpret_cast<const uint8_t*>(zbase) + e + j);
#pragma unroll
      for (int i = 0; i < 4; ++i) z[j + i] = (float)((v >> (8 * i)) & 0xFFu);
    } else if (p.zkind == Z_BF16) {
      const uint2 v = *reinterpret_cast<const uint2*>(
          reinterpret_cast<const __nv_bfloat16*>(zbase) + e + j);
      z[j] = bf16_lo(v.x); z[j + 1] = bf16_hi(v.x);
      z[j + 2] = bf16_lo(v.y); z[j + 3] = bf16_hi(v.y);
    } else if (p.zkind == Z_F32) {
      const float4 v = *reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(zbase) + e + j);
      z[j] = v.x; z[j + 1] = v.y; z[j + 2] = v.z; z[j + 3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) z[j + i] = p.zconst;
    }
  }
}

// ------------------------------------------------------------------ gemv

template <int L, int MT>
__global__ void __launch_bounds__(GX * GY)
qmm_gemv_kernel(const Params p) {
  constexpr int NP = L == L_PLANES ? 3 : 1;   // planes, at most
  constexpr int B = NP == 1 ? 8 : 4;          // K rows loaded at once
  __shared__ __align__(16) __nv_bfloat16 xsh[MT * GK];
  __shared__ float red[GX * GY / 32][MT][GX * GCOLS];
  __shared__ float lut[16];
  const int tid = threadIdx.x, tx = tid % GX, ty = tid / GX;
  const int n0 = blockIdx.x * (GX * GCOLS) + tx * GCOLS;
  const int kb0 = blockIdx.y * GK, m0 = blockIdx.z * MT;
  if (tid < 16) lut[tid] = p.lut != nullptr ? p.lut[tid] : 0.f;
  for (int i = tid; i < MT * GK / 8; i += GX * GY) {   // the block's x
    const int m = i / (GK / 8), k = kb0 + (i % (GK / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + m < p.M && k < p.K)
      v = __ldg(reinterpret_cast<const uint4*>(p.x + (size_t)(m0 + m) * p.K +
                                               k));
    reinterpret_cast<uint4*>(xsh)[i] = v;
  }
  __syncthreads();

  float acc[MT][GCOLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < GCOLS; ++j) acc[m][j] = 0.f;

  // this thread's GROWS K rows (K % 32 == 0: all of them or none)
  const int ks = kb0 + ty * GROWS;
  if (n0 < p.N && ks < p.K) {
    const int np = L == L_PLANES ? p.np : 1;
    int gi = udiv(ks, p.group, p.group_sh);
    int gnext = (gi + 1) * p.group;
    float s[GCOLS], z[GCOLS];
    load_sz<GCOLS>(p, p.scales, p.zeros, (size_t)gi * p.N + n0, s, z);
    // a bit plane whose chunk and byte rows a chunk are multiples of 16
    // holds the thread's 16 rows in consecutive byte rows at one field
    int row0[NP], off0[NP];
    bool lin = true;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      row0[i] = off0[i] = 0;
      if (i < np) plane_row<L>(p, i, ks, row0[i], off0[i]);
      if (is_planes(L) && i < np)
        lin = lin && p.chunk_sh >= 4 && p.sub_sh[i] >= 4;
    }
#pragma unroll 1
    for (int kb = ks; kb < ks + GROWS; kb += B) {
      uint4 wv[B][NP];
      int off[B][NP];
#pragma unroll
      for (int r = 0; r < B; ++r)
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          wv[r][i] = make_uint4(0u, 0u, 0u, 0u);
          off[r][i] = 0;
          if (i < np) {
            int row = row0[i] + kb - ks + r;
            off[r][i] = off0[i];
            if (!is_planes(L) || !lin)
              plane_row<L>(p, i, kb + r, row, off[r][i]);
            wv[r][i] = __ldg(reinterpret_cast<const uint4*>(
                p.pl[i] + (size_t)row * p.N + n0));
          }
        }
#pragma unroll
      for (int r = 0; r < B; ++r) {
        const int k = kb + r;
        if (k == gnext) {
          ++gi;
          gnext += p.group;
          load_sz<GCOLS>(p, p.scales, p.zeros, (size_t)gi * p.N + n0, s, z);
        }
        float xv[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          xv[m] = __bfloat162float(xsh[m * GK + k - kb0]);
#pragma unroll
        for (int j = 0; j < GCOLS; j += 2) {
          float w2[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = j + h;
            uint32_t b[NP];
#pragma unroll
            for (int i = 0; i < NP; ++i) {
              const uint32_t word = c < 4 ? wv[r][i].x : c < 8 ? wv[r][i].y
                                  : c < 12 ? wv[r][i].z : wv[r][i].w;
              b[i] = (word >> (8 * (c & 3))) & 0xFFu;
            }
            w2[h] = __fmul_rn(code_value<L>(p, b, off[r], z[c], lut), s[c]);
          }
          const __nv_bfloat162 b2 = __floats2bfloat162_rn(w2[0], w2[1]);
          const float wlo = __low2float(b2), whi = __high2float(b2);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            acc[m][j] = fmaf(xv[m], wlo, acc[m][j]);
            acc[m][j + 1] = fmaf(xv[m], whi, acc[m][j + 1]);
          }
        }
      }
    }
  }

  // the GY K threads of a column: 4 in a warp by shuffles, then the warps
  // in shared memory, in a fixed order
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < GCOLS; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < GX) red[warp][m][tx * GCOLS + j] = v;
    }
  __syncthreads();
  for (int i = tid; i < MT * GX * GCOLS; i += GX * GY) {
    const int m = i / (GX * GCOLS), c = i % (GX * GCOLS);
    const int n = blockIdx.x * (GX * GCOLS) + c;
    if (n >= p.N || m0 + m >= p.M) continue;
    float v = red[0][m][c];
#pragma unroll
    for (int w = 1; w < GX * GY / 32; ++w) v += red[w][m][c];
    const size_t o = (size_t)(m0 + m) * p.N + n;
    if (gridDim.y > 1)
      p.partial[(size_t)blockIdx.y * p.M * p.N + o] = v;
    else if (p.out_f32)
      reinterpret_cast<float*>(p.out)[o] = v;
    else
      reinterpret_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(v);
  }
}

// ------------------------------------------------------------------ tc

// Stage K tile [k0, k1) of this block (one thread): the x tile, each
// plane's window of byte rows, the scale and zero-point rows, all by TMA
// into the stage, completing on its barrier. Each plane's first row goes
// to the stage's header for the dequant.
template <int L>
__device__ __forceinline__ void tc_issue(const Params& p, uint8_t* st,
                                         uint64_t* bar, int k0, int k1,
                                         int m_base, int n_base) {
  int* hdr = reinterpret_cast<int*>(st + p.st_hdr);
  qmm_tc::mbar_expect(bar, p.tx_bytes);
  qmm_tc::tma_load(st, &p.mx, k0, m_base, bar);
  const int np = L == L_PLANES ? p.np : 1;
  for (int i = 0; i < np; ++i) {
    int lo, hi;
    if constexpr (is_planes(L)) {
      plane_window(k0, k1, p.chunk, p.chunk_sh, p.pw[i], p.sub_sh[i], lo,
                   hi);
    } else {
      lo = k0 / (L == L_NPACK4 ? 2 : L == L_NPACK2 ? 4 : 1);
    }
    hdr[i] = lo;
    qmm_tc::tma_load(st + p.st_pl[i], &p.mpl[i], n_base, lo, bar);
  }
  const int g0 = udiv(k0, p.group, p.group_sh);
  qmm_tc::tma_load(st + p.st_s, &p.ms, n_base, g0, bar);
  if (p.zkind != Z_NONE) qmm_tc::tma_load(st + p.st_z, &p.mz, n_base, g0, bar);
}

// Dequantize the staged K tile [k0, k1) into the bf16 operand tile [n][k].
// Warp w takes the tile's K rows 8 w .. 8 w + 7, lane q columns 4 q .. 4 q
// + 3: one 32-bit word of each plane's byte row a K row, each weight
// scaled in f32 and rounded to bf16, and each column's 8 K values stored
// as one 16-byte run.
template <int L>
__device__ __forceinline__ void tc_dequant(const Params& p,
                                           const uint8_t* st, uint8_t* op,
                                           int k0, int k1, int n_base,
                                           const float* lut, int tid) {
  constexpr int NP = L == L_PLANES ? 3 : 1;
  const int w = tid / 32, q = tid % 32;
  // A tile's rows past k1 (the end of K) repeat its last 8 rows: x is zero
  // there (TMA fills what lies past K with zeros), so they add nothing;
  // columns past N come as zero bytes and their outputs are not stored.
  // No branch and no select: either makes ptxas serialize the wgmmas.
  const int ko = min(k0 + 8 * w, k1 - 8);
  uint8_t* dst = op + qmm_tc::cm_off(4 * q, 16 * w, SBO);
  const int* hdr = reinterpret_cast<const int*>(st + p.st_hdr);
  const int np = L == L_PLANES ? p.np : 1;
  // the 8 rows lie in one group (group % 8 == 0) and one chunk
  const int gr = udiv(ko, p.group, p.group_sh) - udiv(k0, p.group, p.group_sh);
  float s[4], z[4];
  load_sz<4>(p, st + p.st_s, st + p.st_z, (size_t)gr * BN + 4 * q, s, z);
  // each plane's word (4 columns) of the 8 rows, and their fields; a plane
  // with fewer than 8 byte rows a chunk (sub) wraps to its next field
  uint32_t word[8][NP];
  int off[8][NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    int row0 = 0, c0 = 0;
    if (i < np) plane_row<L>(p, i, ko, row0, c0);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      word[t][i] = 0u;
      off[t][i] = 0;
      if (i >= np) continue;
      int row = row0 + t;
      off[t][i] = c0;
      if constexpr (is_planes(L)) {
        const int sub = p.sub[i];
        if (p.sub_sh[i] < 0) {              // not a power of two
          plane_row<L>(p, i, ko + t, row, off[t][i]);
        } else if (sub < 8) {
          const int pw = L == L_LUT4 ? 4 : L == L_ONEBIT ? 1 : p.pw[i];
          row = row0 + (t & (sub - 1));
          off[t][i] = c0 + pw * (t >> p.sub_sh[i]);
        }
      } else if constexpr (L == L_NPACK4) {
        row = row0 + (t >> 1);
        off[t][i] = 4 * (t & 1);
      } else if constexpr (L == L_NPACK2) {
        row = row0 + (t >> 2);
        off[t][i] = 2 * (t & 3);
      }
      word[t][i] = *reinterpret_cast<const uint32_t*>(
          st + p.st_pl[i] + (row - hdr[i]) * BN + 4 * q);
    }
  }
  // each column's 8 weights, scaled in f32, rounded to bf16 in pairs and
  // stored as one 16-byte run
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t packed[4];
#pragma unroll
    for (int t = 0; t < 8; t += 2) {
      float wv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t b[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) b[i] = (word[t + h][i] >> (8 * j)) & 0xFFu;
        wv[h] = __fmul_rn(code_value<L>(p, b, off[t + h], z[j], lut), s[j]);
      }
      const __nv_bfloat162 b2 = __floats2bfloat162_rn(wv[0], wv[1]);
      packed[t / 2] = *reinterpret_cast<const uint32_t*>(&b2);
    }
    *reinterpret_cast<uint4*>(dst + 16 * j) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// MW: m64 tiles a warpgroup, BM = 128 MW rows a block
template <int L, int MW>
__global__ void __launch_bounds__(THREADS, 1)
qmm_tc_kernel(const __grid_constant__ Params p) {
  constexpr int BM = 128 * MW;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float lut[16];
  __shared__ __align__(8) uint64_t full[STAGES];
  // the ring and the operand tiles start on a 1024-byte boundary, as the
  // x tile's swizzle needs
  uint8_t* smem = smem_raw + ((1024 - (qmm_tc::smem_u32(smem_raw) & 1023)) &
                              1023);
  uint8_t* ops = smem + STAGES * p.st_bytes;
  const int tid = threadIdx.x, wg = tid / 128, wi = (tid / 32) % 4;
  const int lane = tid % 32;
  const int n_base = blockIdx.x * BN, m_base = blockIdx.z * BM;
  const int k_begin = blockIdx.y * p.kps;
  const int k_end = min(p.K, k_begin + p.kps);
  const int KT = (k_end - k_begin + BK - 1) / BK;
  if (tid < 16) lut[tid] = p.lut != nullptr ? p.lut[tid] : 0.f;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) qmm_tc::mbar_init(&full[s], 1);
    qmm_tc::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < STAGES - 2 && t < KT; ++t) {
      const int k0 = k_begin + t * BK;
      tc_issue<L>(p, smem + t * p.st_bytes, &full[t], k0,
                  min(k0 + BK, k_end), m_base, n_base);
    }

  float acc[MW][64];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[i][r] = 0.f;
  const uint32_t sbase = qmm_tc::smem_u32(smem), obase = qmm_tc::smem_u32(ops);

  // Tile kt: dequantize it while the tensor cores run tile kt - 1, one
  // barrier, then stage tile kt + STAGES - 2 into the slot of tile kt - 2
  // (whose wgmmas every warpgroup has waited for) and issue kt's wgmmas.
  // The operand tiles rotate over three buffers: tile kt's is free once
  // both warpgroups have waited for tile kt - 3.
  for (int kt = 0; kt < KT; ++kt) {
    const int slot = kt % STAGES;
    const int k0 = k_begin + kt * BK, k1 = min(k0 + BK, k_end);
    uint8_t* st = smem + slot * p.st_bytes;
    qmm_tc::mbar_wait(&full[slot], (kt / STAGES) & 1);
    tc_dequant<L>(p, st, ops + (kt % 3) * OP_BYTES, k0, k1, n_base, lut,
                  tid);
    qmm_tc::fence_proxy_async();
    __syncthreads();
    if (tid == 0 && kt + STAGES - 2 < KT) {
      const int kn = k_begin + (kt + STAGES - 2) * BK;
      const int sn = (kt + STAGES - 2) % STAGES;
      tc_issue<L>(p, smem + sn * p.st_bytes, &full[sn], kn,
                  min(kn + BK, k_end), m_base, n_base);
    }
#pragma unroll
    for (int i = 0; i < MW; ++i) qmm_tc::fence_acc(acc[i]);
    qmm_tc::wgmma_fence();
    const uint32_t b0 = obase + (kt % 3) * OP_BYTES;
#pragma unroll
    for (int s = 0; s < BK / 16; ++s) {
      const uint64_t db = qmm_tc::desc(b0 + 256 * s, 128, SBO);
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        const uint32_t a0 = sbase + slot * p.st_bytes +
                            (wg * MW + i) * 64 * 128 + 32 * s;
        qmm_tc::wgmma_bf16_n128(acc[i], qmm_tc::desc_sw128(a0), db, 1);
      }
    }
    qmm_tc::wgmma_commit();
    qmm_tc::wgmma_wait<1>();
  }
  qmm_tc::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MW; ++i) qmm_tc::fence_acc(acc[i]);

  const bool split = gridDim.y > 1;
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    const int r0 = m_base + (wg * MW + i) * 64 + wi * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n_base + 8 * j + 2 * (lane % 4);
      if (col >= p.N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row >= p.M) continue;
        const size_t o = (size_t)row * p.N + col;
        const float v0 = acc[i][4 * j + 2 * h], v1 = acc[i][4 * j + 2 * h + 1];
        if (split)
          *reinterpret_cast<float2*>(
              p.partial + (size_t)blockIdx.y * p.M * p.N + o) =
              make_float2(v0, v1);
        else if (p.out_f32)
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(p.out) + o) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(
              reinterpret_cast<__nv_bfloat16*>(p.out) + o) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

__global__ void reduce_splits(const float* __restrict__ partial, void* out,
                              int splits, long long MN, int out_f32) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int q = 0; q < splits; ++q) s += partial[(size_t)q * MN + i];
  if (out_f32)
    reinterpret_cast<float*>(out)[i] = s;
  else
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(s);
}

int log2_or_neg(int v) {
  if (v <= 0 || (v & (v - 1))) return -1;
  int s = 0;
  while ((1 << s) < v) ++s;
  return s;
}


template <int L>
cudaError_t launch_gemv(const Params& p, int splits, cudaStream_t st) {
  const int nx = (p.N + GX * GCOLS - 1) / (GX * GCOLS);
#define GEMV(MT)                                                          \
  qmm_gemv_kernel<L, MT><<<dim3(nx, splits, (p.M + MT - 1) / MT),         \
                           GX * GY, 0, st>>>(p)
  if (p.M == 1) GEMV(1);
  else if (p.M == 2) GEMV(2);
  else if (p.M <= 4) GEMV(4);
  else GEMV(8);
#undef GEMV
  return cudaGetLastError();
}

int round128(int v) { return (v + 127) / 128 * 128; }

// The tc route's stage layout for this weight (the most byte rows a plane
// and scale rows any K tile needs: the boxes of its copies), its tensor
// maps, then the launch.
template <int L>
cudaError_t launch_tc(Params p, int splits, cudaStream_t st) {
  int bm = p.M <= 128 ? 128 : 256;
  int rows[3] = {0, 0, 0}, srows = 0;
  const int np = is_planes(L) ? p.np : 1;
  const int per = L == L_NPACK4 ? 2 : L == L_NPACK2 ? 4 : 1;
  for (int k0 = 0; k0 < p.K; k0 += BK) {
    const int k1 = k0 + BK < p.K ? k0 + BK : p.K;
    for (int i = 0; i < np; ++i) {
      int lo, hi;
      if (is_planes(L)) {
        plane_window(k0, k1, p.chunk, p.chunk_sh, p.pw[i], p.sub_sh[i], lo,
                     hi);
      } else {
        lo = k0 / per;
        hi = (k1 + per - 1) / per;
      }
      rows[i] = hi - lo > rows[i] ? hi - lo : rows[i];
    }
    const int g = (k1 - 1) / p.group - k0 / p.group + 1;
    srows = g > srows ? g : srows;
  }
  const int sb = p.scale_f32 ? 4 : 2;
  const int zb = p.zkind == Z_U8 ? 1 : p.zkind == Z_BF16 ? 2
               : p.zkind == Z_F32 ? 4 : 0;
  auto layout = [&](int rows_x) {
    int off = rows_x * 128;                   // the x tile
    p.tx_bytes = rows_x * 128;
    for (int i = 0; i < 3; ++i) {
      p.st_pl[i] = off;
      off += round128(rows[i] * BN);
      p.tx_bytes += i < np ? rows[i] * BN : 0;
    }
    p.st_s = off;
    off += round128(srows * BN * sb);
    p.tx_bytes += srows * BN * sb;
    p.st_z = off;
    off += round128(srows * BN * zb);
    p.tx_bytes += srows * BN * zb;
    p.st_hdr = off;
    p.st_bytes = (off + 16 + 1023) / 1024 * 1024;
    return STAGES * p.st_bytes + 3 * OP_BYTES + 1024;
  };
  int smem = layout(bm);
  if (smem > SMEM_OPTIN - 1024 && bm == 256) {   // the widest stages: 128 rows
    bm = 128;
    smem = layout(bm);
  }
  if (smem > SMEM_OPTIN - 1024) return cudaErrorInvalidValue;
  using qmm_tc::make_map;
  bool ok = make_map(&p.mx, p.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.K, p.M,
                     (long long)p.K * 2, BK, bm, true);
  for (int i = 0; i < np; ++i) {
    const long long prow = is_planes(L) ? (long long)p.K * p.pw[i] / 8
                                        : (p.K + per - 1) / per;
    ok = ok && make_map(&p.mpl[i], p.pl[i], CU_TENSOR_MAP_DATA_TYPE_UINT8,
                        p.N, prow, p.N, BN, rows[i], false);
  }
  ok = ok && make_map(&p.ms, p.scales,
                      p.scale_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      p.N, p.K / p.group, (long long)p.N * sb, BN, srows,
                      false);
  if (zb)
    ok = ok && make_map(&p.mz, p.zeros,
                        zb == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                        : zb == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        p.N, p.K / p.group, (long long)p.N * zb, BN, srows,
                        false);
  if (!ok) return cudaErrorInvalidValue;
  const dim3 grid((p.N + BN - 1) / BN, splits, (p.M + bm - 1) / bm);
  static bool attr_set[2] = {false, false};
  if (bm == 128) {
    if (!attr_set[0]) {
      const cudaError_t e = cudaFuncSetAttribute(
          qmm_tc_kernel<L, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          SMEM_OPTIN - 1024);
      if (e != cudaSuccess) return e;
      attr_set[0] = true;
    }
    qmm_tc_kernel<L, 1><<<grid, THREADS, smem, st>>>(p);
  } else {
    if (!attr_set[1]) {
      const cudaError_t e = cudaFuncSetAttribute(
          qmm_tc_kernel<L, 2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          SMEM_OPTIN - 1024);
      if (e != cudaSuccess) return e;
      attr_set[1] = true;
    }
    qmm_tc_kernel<L, 2><<<grid, THREADS, smem, st>>>(p);
  }
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_lay(const Params& p, int splits, cudaStream_t st) {
  return p.M <= 16 ? launch_gemv<L>(p, splits, st)
                   : launch_tc<L>(p, splits, st);
}

}  // namespace

// fmt: 0 bit planes, 1 native-pack nibbles, 2 native-pack int2, 3 int8
// codes, 4 fp8. bits: the code width (bit planes: 1-8). vmode (bit planes):
// 0 int, 1 int1, 2 table. zkind: 0 none (zconst is the zero-point), 1 uint8,
// 2 bf16, 3 f32. partial: f32 [splits, M, N] when splits > 1; kps the K rows
// of each split: 512 on the gemv route (M <= 16), a multiple of 64 on the
// tc route. The group is a multiple of 8.
extern "C" int qmm_general(const void* x, const void* p0, const void* p1,
                           const void* p2, const void* scales,
                           const void* zeros, const void* lut, void* partial,
                           void* out, int M, int K, int N, int group,
                           int chunk, int fmt, int bits, int vmode,
                           int scale_f32, int zkind, float zconst,
                           int fp8_e5m2, int out_f32, int splits, int kps,
                           void* stream) {
  Params p;
  p.x = reinterpret_cast<const __nv_bfloat16*>(x);
  p.pl[0] = reinterpret_cast<const uint8_t*>(p0);
  p.pl[1] = reinterpret_cast<const uint8_t*>(p1);
  p.pl[2] = reinterpret_cast<const uint8_t*>(p2);
  // bit planes: 8 bits is one byte plane, else widths from {4, 2, 1}
  p.np = 0;
  if (bits == 8) {
    p.pw[0] = 8;
    p.psh[0] = 0;
    p.np = 1;
  } else {
    int rem = bits;
    for (int w = 4; w >= 1; w >>= 1) {
      if (rem >= w) {
        rem -= w;
        p.pw[p.np] = w;
        p.psh[p.np] = rem;
        ++p.np;
      }
    }
  }
  for (int i = p.np; i < 3; ++i) {
    p.pw[i] = 0;
    p.psh[i] = 0;
  }
  if (fmt != L_PLANES) p.np = 1;
  p.scales = scales;
  p.zeros = zeros;
  p.lut = reinterpret_cast<const float*>(lut);
  p.out = out;
  p.partial = reinterpret_cast<float*>(partial);
  p.M = M;
  p.K = K;
  p.N = N;
  p.group = group;
  p.chunk = chunk;
  p.vmode = vmode;
  p.scale_f32 = scale_f32;
  p.zkind = zkind;
  p.zconst = zconst;
  p.fp8_e5m2 = fp8_e5m2;
  p.out_f32 = out_f32;
  p.kps = kps;
  p.chunk_sh = log2_or_neg(chunk);
  p.group_sh = log2_or_neg(group);
  for (int i = 0; i < 3; ++i) {
    p.sub[i] = p.pw[i] > 0 ? chunk * p.pw[i] / 8 : 1;
    p.sub_sh[i] = log2_or_neg(p.sub[i]);
  }
  if (group % 8 || (M <= 16 && kps != GK) || (M > 16 && kps % BK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  int lay = fmt;
  if (fmt == L_PLANES && p.np == 1 && p.pw[0] == 4 && vmode == V_LUT)
    lay = L_LUT4;
  else if (fmt == L_PLANES && p.np == 1 && p.pw[0] == 1 && vmode == V_ONEBIT)
    lay = L_ONEBIT;
  switch (lay) {
    case L_PLANES: e = launch_lay<L_PLANES>(p, splits, st); break;
    case L_LUT4: e = launch_lay<L_LUT4>(p, splits, st); break;
    case L_ONEBIT: e = launch_lay<L_ONEBIT>(p, splits, st); break;
    case L_NPACK4: e = launch_lay<L_NPACK4>(p, splits, st); break;
    case L_NPACK2: e = launch_lay<L_NPACK2>(p, splits, st); break;
    case L_INT8: e = launch_lay<L_INT8>(p, splits, st); break;
    case L_FP8: e = launch_lay<L_FP8>(p, splits, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long MN = (long long)M * N;
  reduce_splits<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(
      p.partial, out, splits, MN, out_f32);
  return (int)cudaGetLastError();
}
