// K5 qmm_general: the general dequant GEMM for Hopper.
//
// Replaces neural_tpu/ops/qmatmul.py:_qmm_kernel (launched by
// _qmatmul_pallas; its tile dequant is _dequant_tile):
//     out[M, N] = bf16(x)[M, K] @ W,
// where each weight element is taken in f32 (code minus its zero-point, a
// 16-entry table value, an fp8 value, or +-1), multiplied by its group's
// scale widened to f32 and rounded once to bf16 (__float2bfloat16_rn); the
// product is bf16 x bf16 on the tensor cores (mma.sync m16n8k16) with f32
// accumulation, cast to bf16 or f32 at the end. One entry point takes every
// weight layout of the port, chosen by a template parameter:
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
// What bounds it on the H100: at M = 1 (nf4 decode) the weight bytes; at the
// 1975-token prefill the bf16 operations. The design is the simple one: a
// block computes a BM x 128 output tile over 32-row K tiles. Each thread
// dequantizes one K row of 16 columns per tile — its row's byte offsets,
// group and plane shifts are worked out once per tile, so a group edge
// inside a tile is no special case — into a bf16 tile in shared memory
// beside the bf16 x tile; 8 warps run mma.sync on them. The next tile's raw
// bytes are loaded into registers while the tensor cores work on this one.
// Few output tiles (M = 1, N = 4096) would leave most of the 132 SMs idle,
// so K is split too: the blocks of a split write f32 partials and a second
// pass adds them in a fixed order, so reruns are bit-identical. wgmma, TMA
// and a GEMV tiling are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

enum Fmt { F_PLANES = 0, F_NPACK4 = 1, F_NPACK2 = 2, F_INT8 = 3, F_FP8 = 4 };
enum VMode { V_INT = 0, V_ONEBIT = 1, V_LUT = 2 };
enum ZKind { Z_NONE = 0, Z_U8 = 1, Z_BF16 = 2, Z_F32 = 3 };

constexpr int BN = 128, BK = 32, THREADS = 256;
constexpr int LDB = BN + 8;   // bf16 row stride of the weight tile [k][n]
constexpr int LDA = BK + 8;   // bf16 row stride of the x tile [m][k]

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
};

// the raw bytes one thread dequantizes: 16 columns of one K row
struct Raw {
  uint4 w[3];                  // plane bytes (one uint4 per plane)
  uint4 s[4];                  // scales: 4 (f32) or 2 (bf16) uint4
  uint4 z[4];                  // zero-points: 1 (u8), 2 (bf16), 4 (f32)
  int off[3];                  // bit offset of the row in each plane's byte
};

__device__ __forceinline__ uint32_t byte_at(const uint4& v, int j) {
  const uint32_t w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (w >> (8 * (j & 3))) & 0xFFu;
}

__device__ __forceinline__ float f32_at(const uint4* v, int j) {
  const uint4& q = v[j >> 2];
  const uint32_t w = (j & 3) == 0 ? q.x : (j & 3) == 1 ? q.y
                   : (j & 3) == 2 ? q.z : q.w;
  return __uint_as_float(w);
}

__device__ __forceinline__ float bf16_at(const uint4* v, int j) {
  const uint4& q = v[j >> 3];
  const int h = j & 7;
  const uint32_t w = h < 2 ? q.x : h < 4 ? q.y : h < 6 ? q.z : q.w;
  return __uint_as_float(((h & 1) ? (w >> 16) : (w & 0xFFFFu)) << 16);
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// global -> registers: row k (absolute), columns n .. n + 15
template <int FMT>
__device__ __forceinline__ void fetch(const Params& p, int k, int n,
                                      Raw& r) {
  const int N = p.N;
  if constexpr (FMT == F_PLANES) {
    const int gi = k / p.chunk, kin = k - gi * p.chunk;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (i < p.np) {
        const int sub = p.chunk * p.pw[i] / 8;   // byte rows per chunk
        const int c = kin / sub;
        r.off[i] = p.pw[i] * c;
        r.w[i] = ldg16(p.pl[i] + (size_t)(gi * sub + kin - c * sub) * N + n);
      }
    }
  } else if constexpr (FMT == F_NPACK4) {
    r.w[0] = ldg16(p.pl[0] + (size_t)(k >> 1) * N + n);
    r.off[0] = 4 * (k & 1);
  } else if constexpr (FMT == F_NPACK2) {
    r.w[0] = ldg16(p.pl[0] + (size_t)(k >> 2) * N + n);
    r.off[0] = 2 * (k & 3);
  } else {
    r.w[0] = ldg16(p.pl[0] + (size_t)k * N + n);
  }
  const size_t srow = (size_t)(k / p.group) * N + n;
  if (p.scale_f32) {
    const float* s = reinterpret_cast<const float*>(p.scales) + srow;
#pragma unroll
    for (int i = 0; i < 4; ++i) r.s[i] = ldg16(s + 4 * i);
  } else {
    const __nv_bfloat16* s =
        reinterpret_cast<const __nv_bfloat16*>(p.scales) + srow;
    r.s[0] = ldg16(s);
    r.s[1] = ldg16(s + 8);
  }
  if (p.zkind == Z_U8) {
    r.z[0] = ldg16(reinterpret_cast<const uint8_t*>(p.zeros) + srow);
  } else if (p.zkind == Z_BF16) {
    const __nv_bfloat16* z =
        reinterpret_cast<const __nv_bfloat16*>(p.zeros) + srow;
    r.z[0] = ldg16(z);
    r.z[1] = ldg16(z + 8);
  } else if (p.zkind == Z_F32) {
    const float* z = reinterpret_cast<const float*>(p.zeros) + srow;
#pragma unroll
    for (int i = 0; i < 4; ++i) r.z[i] = ldg16(z + 4 * i);
  }
}

// registers -> 16 bf16 weights, _dequant_tile's rounding
template <int FMT>
__device__ __forceinline__ void dequant(const Params& p, const Raw& r,
                                        const float* lut, uint32_t* outw) {
#pragma unroll
  for (int j = 0; j < 16; j += 2) {
    float wv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = j + h;
      const float s = p.scale_f32 ? f32_at(r.s, c) : bf16_at(r.s, c);
      float z = p.zconst;
      if (p.zkind == Z_U8) z = (float)byte_at(r.z[0], c);
      else if (p.zkind == Z_BF16) z = bf16_at(r.z, c);
      else if (p.zkind == Z_F32) z = f32_at(r.z, c);
      float v;
      if constexpr (FMT == F_PLANES) {
        uint32_t code = 0;
#pragma unroll
        for (int i = 0; i < 3; ++i)
          if (i < p.np)
            code |= ((byte_at(r.w[i], c) >> r.off[i]) &
                     ((1u << p.pw[i]) - 1u)) << p.psh[i];
        if (p.vmode == V_LUT) v = lut[code];
        else if (p.vmode == V_ONEBIT) v = __fsub_rn((float)(2 * code), 1.f);
        else v = __fsub_rn((float)code, z);
      } else if constexpr (FMT == F_NPACK4) {
        const uint32_t f = (byte_at(r.w[0], c) >> r.off[0]) & 0xFu;
        v = __fsub_rn((float)((int)(f ^ 8u) - 8), z);
      } else if constexpr (FMT == F_NPACK2) {
        const uint32_t f = (byte_at(r.w[0], c) >> r.off[0]) & 0x3u;
        v = __fsub_rn((float)((int)(f ^ 2u) - 2), z);
      } else if constexpr (FMT == F_INT8) {
        v = __fsub_rn((float)(int8_t)byte_at(r.w[0], c), z);
      } else {
        const __half_raw hr = __nv_cvt_fp8_to_halfraw(
            (__nv_fp8_storage_t)byte_at(r.w[0], c),
            p.fp8_e5m2 ? __NV_E5M2 : __NV_E4M3);
        v = __half2float(__half(hr));
      }
      wv[h] = __fmul_rn(v, s);
    }
    const __nv_bfloat162 b2 = __floats2bfloat162_rn(wv[0], wv[1]);
    outw[j / 2] = *reinterpret_cast<const uint32_t*>(&b2);
  }
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int FMT, int BM>
__global__ void __launch_bounds__(THREADS)
qmm_general_kernel(const Params p) {
  constexpr int WM = BM == 16 ? 1 : 2;         // warps along M
  constexpr int WN = 8 / WM;                   // warps along N
  constexpr int MT = BM / WM / 16;             // m16 tiles per warp
  constexpr int NT = BN / WN / 8;              // n8 tiles per warp
  constexpr int XV = BM * BK / 8;              // uint4 of the x tile
  constexpr int XPT = (XV + THREADS - 1) / THREADS;

  __shared__ __align__(16) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(16) __nv_bfloat16 Bs[BK * LDB];
  __shared__ float lut[16];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int n_base = blockIdx.x * BN, m_base = blockIdx.z * BM;
  const int k_begin = blockIdx.y * p.kps;
  const int k_end = min(p.K, k_begin + p.kps);
  const int kr = tid / 8, cg = tid % 8;        // this thread's weight row/cols
  const int n = n_base + cg * 16;
  const bool n_ok = n < p.N;

  if (tid < 16) lut[tid] = p.lut != nullptr ? p.lut[tid] : 0.f;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  Raw raw;
  uint4 xr[XPT];
  auto fetch_tile = [&](int k0) {
    if (n_ok) fetch<FMT>(p, k0 + kr, n, raw);
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int e = tid + i * THREADS;
      xr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (e < XV) {
        const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
        if (m_base + r < p.M)
          xr[i] = ldg16(p.x + (size_t)(m_base + r) * p.K + k0 + c);
      }
    }
  };

  fetch_tile(k_begin);
  __syncthreads();                              // the table is in place
  const unsigned short* Bu = reinterpret_cast<const unsigned short*>(Bs);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    uint32_t wq[8];
    if (n_ok) {
      dequant<FMT>(p, raw, lut, wq);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) wq[i] = 0u;
    }
    uint4* bdst = reinterpret_cast<uint4*>(Bs + kr * LDB + cg * 16);
    bdst[0] = make_uint4(wq[0], wq[1], wq[2], wq[3]);
    bdst[1] = make_uint4(wq[4], wq[5], wq[6], wq[7]);
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int e = tid + i * THREADS;
      if (e < XV) {
        const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
        *reinterpret_cast<uint4*>(As + r * LDA + c) = xr[i];
      }
    }
    __syncthreads();
    if (k0 + BK < k_end) fetch_tile(k0 + BK);   // in flight during the mma

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = wm * (BM / WM) + mt * 16 + g;
        a[mt][0] = ld32(As + row * LDA + kk + tq * 2);
        a[mt][1] = ld32(As + (row + 8) * LDA + kk + tq * 2);
        a[mt][2] = ld32(As + row * LDA + kk + 8 + tq * 2);
        a[mt][3] = ld32(As + (row + 8) * LDA + kk + 8 + tq * 2);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = wn * (BN / WN) + nt * 8 + g;
        const int k = kk + tq * 2;
        b[nt][0] = (uint32_t)Bu[k * LDB + col] |
                   ((uint32_t)Bu[(k + 1) * LDB + col] << 16);
        b[nt][1] = (uint32_t)Bu[(k + 8) * LDB + col] |
                   ((uint32_t)Bu[(k + 9) * LDB + col] << 16);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }

  const bool split = gridDim.y > 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n_base + wn * (BN / WN) + nt * 8 + tq * 2;
      if (col >= p.N) continue;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m_base + wm * (BM / WM) + mt * 16 + g + (r >= 2 ? 8 : 0);
        if (row >= p.M) continue;
        const size_t o = (size_t)row * p.N + col + (r & 1);
        if (split)
          p.partial[(size_t)blockIdx.y * p.M * p.N + o] = acc[mt][nt][r];
        else if (p.out_f32)
          reinterpret_cast<float*>(p.out)[o] = acc[mt][nt][r];
        else
          reinterpret_cast<__nv_bfloat16*>(p.out)[o] =
              __float2bfloat16_rn(acc[mt][nt][r]);
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

template <int FMT>
cudaError_t launch_fmt(const Params& p, int splits, cudaStream_t st) {
  const int ntiles = (p.N + BN - 1) / BN;
  if (p.M <= 16) {
    qmm_general_kernel<FMT, 16><<<dim3(ntiles, splits, (p.M + 15) / 16),
                                  THREADS, 0, st>>>(p);
  } else if (p.M <= 64) {
    qmm_general_kernel<FMT, 64><<<dim3(ntiles, splits, (p.M + 63) / 64),
                                  THREADS, 0, st>>>(p);
  } else {
    qmm_general_kernel<FMT, 128><<<dim3(ntiles, splits, (p.M + 127) / 128),
                                   THREADS, 0, st>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// fmt: 0 bit planes, 1 native-pack nibbles, 2 native-pack int2, 3 int8
// codes, 4 fp8. bits: the code width (bit planes: 1-8). vmode (bit planes):
// 0 int, 1 int1, 2 table. zkind: 0 none (zconst is the zero-point), 1 uint8,
// 2 bf16, 3 f32. partial: f32 [splits, M, N] when splits > 1, kps the K rows
// of each split (a multiple of 32).
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
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (fmt) {
    case F_PLANES: e = launch_fmt<F_PLANES>(p, splits, st); break;
    case F_NPACK4: e = launch_fmt<F_NPACK4>(p, splits, st); break;
    case F_NPACK2: e = launch_fmt<F_NPACK2>(p, splits, st); break;
    case F_INT8: e = launch_fmt<F_INT8>(p, splits, st); break;
    case F_FP8: e = launch_fmt<F_FP8>(p, splits, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long MN = (long long)M * N;
  reduce_splits<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(
      p.partial, out, splits, MN, out_f32);
  return (int)cudaGetLastError();
}
