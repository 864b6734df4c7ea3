// Split-S decode attention (T = 1): the device body shared by K4
// (flash_decode.cu, a contiguous cache) and K6 (paged_decode.cu, a page
// pool read through a page table).
//
// q [B, Hq, 128] bf16; keys at positions >= lengths[b] masked; the G = Hq /
// Hkv query heads of a KV head are computed together and share each K/V
// row; output f32 [B, Hq, 128]. Key s of (b, KV head hk) lives at row
// - contiguous: (b * Hkv + hk) * S + s of a [B, Hkv, S] row space;
// - paged: (table[b, s / ps] * Hkv + hk) * ps + s % ps of a [P, Hkv, ps]
//   row space, so any page size works and pages past the fill are never
//   looked up;
// and its K/V data at row * 128, its int8 scales at row.
//
// Numerics, after the TPU kernel (neural_tpu/ops/attention.py:
// _decode_kernel):
// - bf16: bf16 operands, f32 products and sums, scores times the softmax
//   scale, P rounded to bf16 for the PV product.
// - int8 with bf16 scales: each q row is quantized, q8 = rint(q * (127 /
//   qa)) with qa = max|q| + 1e-9 (a true division); the QK dot is exact in
//   int32 (dp4a), s = d * (qa * scale / 127) * k_scale; l sums the unscaled
//   P; the v scale multiplies P in f32, and PV is an f32 product with the
//   int8 v codes.
// Softmax statistics are f32, masked scores -1e30, l floored at 1e-30.
//
// What bounds it on the H100: the bytes — each filled K and V row is read
// once (2 * 128 bytes per key and KV head at bf16, half at int8, plus 4
// bytes of scales), against ~2 * G * 128 multiply-adds. At batch 1 the 32
// KV heads of a 7B cannot fill 132 SMs, so S is split into 64-key chunks
// across blocks (flash-decoding), and at batch 8 the fills differ per row,
// so the split stays: each block writes its chunk's (max, sum, unnormalized
// output) and a combine pass merges the chunks up to the fill. A block whose
// chunk starts at or past its row's fill returns at once, so rows past the
// fill are never read, and the number of chunks comes from the capacity S
// (or MAXP * ps), never from the fill: the host never reads the fill, and
// the launch can sit in a CUDA graph.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace decode_attn {

constexpr int D = 128;
constexpr int CHUNK = 64;
constexpr int MAXG = 8;
constexpr float NEG = -1e30f;

struct Args {
  const __nv_bfloat16* q;
  const void* k;
  const void* v;
  const __nv_bfloat16* ks;   // int8 only: k scales, one per key row
  const __nv_bfloat16* vs;
  const int* table;          // paged only: [B, maxp]
  const int* lengths;
  float* part_o;             // [B * Hq, n_split, D]
  float* part_ml;            // [B * Hq, n_split, 2]
  float* out;                // [B, Hq, D]
  int B, Hq, Hkv, S, ps, maxp, n_split;
  float scale;               // bf16: the softmax scale; int8: scale / 127
};

template <bool PAGED>
__device__ __forceinline__ size_t kv_row(const Args& a, int b, int hk,
                                         int s) {
  if (PAGED) {
    const int page = a.table[(size_t)b * a.maxp + s / a.ps];
    return ((size_t)page * a.Hkv + hk) * a.ps + s % a.ps;
  }
  return ((size_t)b * a.Hkv + hk) * a.S + s;
}

template <bool I8, bool PAGED>
__global__ void __launch_bounds__(128) decode_partial(const Args a) {
  __shared__ float qs[MAXG][D];
  __shared__ uint32_t q8[MAXG][D / 4];   // int8: 4 codes a word
  __shared__ float qk[MAXG];             // int8: qa * scale / 127
  __shared__ float p[MAXG][CHUNK];
  __shared__ float ms[MAXG], ls[MAXG];
  __shared__ size_t rows[CHUNK];
  const int split = blockIdx.x, bk = blockIdx.y;
  const int b = bk / a.Hkv, hk = bk % a.Hkv, G = a.Hq / a.Hkv;
  const int len = min(a.lengths[b], a.S);
  const int s0 = split * CHUNK;
  if (s0 >= len) return;
  const int nj = min(CHUNK, len - s0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < G * D; i += 128)
    qs[i / D][i % D] = __bfloat162float(
        a.q[((size_t)b * a.Hq + hk * G + i / D) * D + i % D]);
  if (tid < nj) rows[tid] = kv_row<PAGED>(a, b, hk, s0 + tid);
  __syncthreads();

  if (I8) {   // quantize each q row, one warp per head
    for (int hg = warp; hg < G; hg += 4) {
      float x[4], mx = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = qs[hg][lane * 4 + i];
        mx = fmaxf(mx, fabsf(x[i]));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float qa = mx + 1e-9f;
      const float r = 127.f / qa;
      uint32_t w = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w |= (uint32_t)(uint8_t)(int8_t)(int)rintf(x[i] * r) << (8 * i);
      q8[hg][lane] = w;
      if (lane == 0) qk[hg] = qa * a.scale;
    }
    __syncthreads();
  }

  // scores: one warp per key, each lane 4 dims
  for (int j = warp; j < CHUNK; j += 4) {
    if (j < nj) {
      const size_t row = rows[j];
      if (I8) {
        const int kw = *reinterpret_cast<const int*>(
            reinterpret_cast<const int8_t*>(a.k) + row * D + lane * 4);
        const float ksc = __bfloat162float(a.ks[row]);
#pragma unroll
        for (int hg = 0; hg < MAXG; ++hg) {
          if (hg >= G) break;
          int d = __dp4a(kw, (int)q8[hg][lane], 0);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, o);
          if (lane == 0) p[hg][j] = (float)d * qk[hg] * ksc;
        }
      } else {
        const uint2 raw = *reinterpret_cast<const uint2*>(
            reinterpret_cast<const __nv_bfloat16*>(a.k) + row * D + lane * 4);
        const __nv_bfloat162 k01 =
            *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
        const __nv_bfloat162 k23 =
            *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
        const float kf[4] = {__low2float(k01), __high2float(k01),
                             __low2float(k23), __high2float(k23)};
#pragma unroll
        for (int hg = 0; hg < MAXG; ++hg) {
          if (hg >= G) break;
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) d += kf[i] * qs[hg][lane * 4 + i];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, o);
          if (lane == 0) p[hg][j] = d * a.scale;
        }
      }
    } else if (lane == 0) {
      for (int hg = 0; hg < G; ++hg) p[hg][j] = NEG;
    }
  }
  __syncthreads();

  // chunk softmax statistics, one warp per head
  for (int hg = warp; hg < G; hg += 4) {
    const float x = p[hg][lane], y = p[hg][lane + 32];
    float m = fmaxf(x, y);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float px = expf(x - m), py = expf(y - m);
    float l = px + py;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    p[hg][lane] = px;
    p[hg][lane + 32] = py;
    if (lane == 0) {
      ms[hg] = m;
      ls[hg] = l;
    }
  }
  __syncthreads();

  // P V: thread tid owns output dim tid for every head of the group
  float acc[MAXG];
#pragma unroll
  for (int hg = 0; hg < MAXG; ++hg) acc[hg] = 0.f;
  for (int j = 0; j < nj; ++j) {
    const size_t row = rows[j];
    if (I8) {
      const float vv =
          (float)reinterpret_cast<const int8_t*>(a.v)[row * D + tid];
      const float vsc = __bfloat162float(a.vs[row]);
#pragma unroll
      for (int hg = 0; hg < MAXG; ++hg)
        if (hg < G) acc[hg] += (p[hg][j] * vsc) * vv;
    } else {
      const float vv = __bfloat162float(
          reinterpret_cast<const __nv_bfloat16*>(a.v)[row * D + tid]);
#pragma unroll
      for (int hg = 0; hg < MAXG; ++hg)
        if (hg < G)
          acc[hg] += __bfloat162float(__float2bfloat16(p[hg][j])) * vv;
    }
  }
#pragma unroll
  for (int hg = 0; hg < MAXG; ++hg) {
    if (hg >= G) break;
    const size_t r = (size_t)b * a.Hq + hk * G + hg;
    a.part_o[(r * a.n_split + split) * D + tid] = acc[hg];
    if (tid == 0) {
      a.part_ml[(r * a.n_split + split) * 2] = ms[hg];
      a.part_ml[(r * a.n_split + split) * 2 + 1] = ls[hg];
    }
  }
}

__global__ void __launch_bounds__(128) decode_combine(const Args a) {
  const int row = blockIdx.x, b = row / a.Hq, d = threadIdx.x;
  const int len = min(a.lengths[b], a.S);
  const int nv = min((len + CHUNK - 1) / CHUNK, a.n_split);
  float m = NEG;
  for (int c = 0; c < nv; ++c)
    m = fmaxf(m, a.part_ml[((size_t)row * a.n_split + c) * 2]);
  float l = 0.f, o = 0.f;
  for (int c = 0; c < nv; ++c) {
    const size_t i = (size_t)row * a.n_split + c;
    const float w = expf(a.part_ml[i * 2] - m);
    l += w * a.part_ml[i * 2 + 1];
    o += w * a.part_o[i * D + d];
  }
  a.out[(size_t)row * D + d] = o / fmaxf(l, 1e-30f);
}

template <bool I8, bool PAGED>
int launch(const Args& a, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  decode_partial<I8, PAGED><<<dim3(a.n_split, a.B * a.Hkv), 128, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine<<<a.B * a.Hq, 128, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace decode_attn

// One exported C entry point per variant; every pointer and the stream as
// void*, the scale as float, cudaGetLastError() as the result.
#define DECODE_ATTN_ENTRY(NAME, I8, PAGED)                                    \
  extern "C" int NAME(const void* q, const void* k, const void* v,            \
                      const void* ks, const void* vs, const void* table,      \
                      const void* lengths, void* part_o, void* part_ml,       \
                      void* out, int B, int Hq, int Hkv, int S, int ps,       \
                      int maxp, int n_split, float scale, void* stream) {     \
    const decode_attn::Args a{                                                \
        reinterpret_cast<const __nv_bfloat16*>(q), k, v,                      \
        reinterpret_cast<const __nv_bfloat16*>(ks),                           \
        reinterpret_cast<const __nv_bfloat16*>(vs),                           \
        reinterpret_cast<const int*>(table),                                  \
        reinterpret_cast<const int*>(lengths),                                \
        reinterpret_cast<float*>(part_o), reinterpret_cast<float*>(part_ml),  \
        reinterpret_cast<float*>(out), B, Hq, Hkv, S, ps, maxp, n_split,      \
        scale};                                                               \
    return decode_attn::launch<I8, PAGED>(a, stream);                         \
  }
