// Split-S decode attention (T = 1): the device body of K6
// (paged_decode.cu, a page pool read through a page table). Its
// contiguous-cache form (PAGED = false) has no entry point: K4
// (flash_decode.cu) has a body of its own.
//
// q [B, Hq, D] bf16 with D = 128 or 256 (a template parameter); keys at
// positions >= lengths[b] masked, and with a sliding window (window > 0)
// keys below lengths[b] - window too; the G = Hq / Hkv query heads of a KV
// head are computed together, up to MAXG = 8 of them in one block, and
// share each K/V row; output f32 [B, Hq, D]. Any G: a third grid
// dimension walks the KV head's query heads in groups of 8 (G = 16 for
// ChatGLM-2's 32 over 2, 48 for StarCoder's multi-query 48 over 1, where the
// TPU kernel pads G up instead), each group's block reading the same K/V
// chunk, whose re-reads the 50 MB L2 serves; shared memory and registers
// stay sized for 8 heads. Key s of (b, KV head hk) lives at row
// - contiguous: (b * Hkv + hk) * S + s of a [B, Hkv, S] row space;
// - paged: (table[b, s / ps] * Hkv + hk) * ps + s % ps of a [P, Hkv, ps]
//   row space, so any page size works and pages past the fill or below
//   the window are never looked up;
// and its K/V data at row * D, its int8 scales at row.
//
// Numerics, after the TPU kernel (neural_tpu/ops/attention.py:
// _decode_kernel):
// - bf16: bf16 operands, f32 products and sums, scores times the softmax
//   scale, P rounded to bf16 for the PV product.
// - int8 with bf16 scales: each q row is quantized, q8 = rint(q * (127 /
//   qa)) with qa = max|q| + 1e-9 (a true division); the QK dot is exact in
//   int32 (dp4a; |d| <= 127 * 127 * 256 < 2^24, so the plain version's f32
//   dot is exact too), s = d * (qa * scale / 127) * k_scale; l sums the
//   unscaled P; the v scale multiplies P in f32, and PV is an f32 product
//   with the int8 v codes.
// - softcap > 0: s = softcap * tanh(s / softcap) on the scaled score,
//   before the mask.
// - slopes != nullptr (ALiBi, [Hq] f32): slopes[h] * (pos - (len - 1)) is
//   added to the (softcapped) score of query head h, a product and a sum
//   each rounded in f32 (no fused multiply-add, as the plain version
//   computes it), before the mask. The off branch is one uniform test.
// Softmax statistics are f32, masked scores -1e30, l floored at 1e-30.
//
// What bounds it on the H100: the bytes — each visible K and V row is read
// once (2 * D bytes per key and KV head at bf16, half at int8, plus 4
// bytes of scales), against ~2 * G * D multiply-adds. At batch 1 the KV
// heads of one layer cannot fill 132 SMs, so S is split into 64-key chunks
// across blocks (flash-decoding), and at batch 8 the fills differ per row,
// so the split stays: each block writes its chunk's (max, sum,
// unnormalized output) and a combine pass merges the visible chunks. A
// block whose chunk starts at or past its row's fill, or ends at or below
// its window's floor, returns at once, so those rows are never read, and
// the number of chunks comes from the capacity S (or MAXP * ps), never from
// the fill or the window: the host never reads the fill, and the launch can
// sit in a CUDA graph. In the chunk that holds the floor, rows below it are
// neither read nor looked up. Each of the 128 threads owns D / 128 output
// dims (dims tid and tid + 128 at D = 256); in the score pass each lane of
// a warp owns D / 32 consecutive dims of a key row.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace decode_attn {

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
  const float* slopes;       // ALiBi [Hq]; nullptr: off
  float* part_o;             // [B * Hq, n_split, D]
  float* part_ml;            // [B * Hq, n_split, 2]
  float* out;                // [B, Hq, D]
  int B, Hq, Hkv, S, ps, maxp, n_split;
  float scale;               // bf16: the softmax scale; int8: scale / 127
  float softcap;             // 0: off
  int window;                // 0: off
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

// first visible key position of a row of fill len
__device__ __forceinline__ int window_floor(const Args& a, int len) {
  return a.window > 0 ? max(len - a.window, 0) : 0;
}

__device__ __forceinline__ float softcap(const Args& a, float s) {
  return a.softcap > 0.f ? a.softcap * tanhf(s / a.softcap) : s;
}

// the score of query head h (of the whole Hq) at a key dist = pos - (len -
// 1) <= 0 behind the query: softcapped, then the ALiBi bias
__device__ __forceinline__ float score(const Args& a, float s, int h,
                                       float dist) {
  s = softcap(a, s);
  return a.slopes ? __fadd_rn(s, __fmul_rn(a.slopes[h], dist)) : s;
}

template <int D, bool I8, bool PAGED>
__global__ void __launch_bounds__(128) decode_partial(const Args a) {
  constexpr int VPL = D / 32;    // dims per lane in the score pass
  constexpr int WPL = VPL / 4;   // int8: code words per lane
  constexpr int DPT = D / 128;   // output dims per thread
  __shared__ float qs[MAXG][D];
  __shared__ uint32_t q8[MAXG][D / 4];   // int8: 4 codes a word
  __shared__ float qk[MAXG];             // int8: qa * scale / 127
  __shared__ float p[MAXG][CHUNK];
  __shared__ float ms[MAXG], ls[MAXG];
  __shared__ size_t rows[CHUNK];
  const int split = blockIdx.x, bk = blockIdx.y;
  const int b = bk / a.Hkv, hk = bk % a.Hkv;
  // this block's query heads: h0 .. h0 + G - 1 of the whole Hq
  const int h0 = hk * (a.Hq / a.Hkv) + blockIdx.z * MAXG;
  const int G = min(MAXG, a.Hq / a.Hkv - (int)blockIdx.z * MAXG);
  const int len = min(a.lengths[b], a.S);
  const int lo = window_floor(a, len);
  const int s0 = split * CHUNK;
  if (s0 >= len || s0 + CHUNK <= lo) return;
  const int nj = min(CHUNK, len - s0);
  const int j0 = max(lo - s0, 0);          // first visible key of the chunk
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < G * D; i += 128)
    qs[i / D][i % D] = __bfloat162float(
        a.q[((size_t)b * a.Hq + h0 + i / D) * D + i % D]);
  if (tid >= j0 && tid < nj) rows[tid] = kv_row<PAGED>(a, b, hk, s0 + tid);
  __syncthreads();

  if (I8) {   // quantize each q row, one warp per head
    for (int hg = warp; hg < G; hg += 4) {
      float x[VPL], mx = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        x[i] = qs[hg][lane * VPL + i];
        mx = fmaxf(mx, fabsf(x[i]));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float qa = mx + 1e-9f;
      const float r = 127.f / qa;
#pragma unroll
      for (int c = 0; c < WPL; ++c) {
        uint32_t w = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w |= (uint32_t)(uint8_t)(int8_t)(int)rintf(x[c * 4 + i] * r)
               << (8 * i);
        q8[hg][lane * WPL + c] = w;
      }
      if (lane == 0) qk[hg] = qa * a.scale;
    }
    __syncthreads();
  }

  // scores: one warp per key, each lane VPL consecutive dims
  for (int j = warp; j < CHUNK; j += 4) {
    if (j >= j0 && j < nj) {
      const size_t row = rows[j];
      const float dist = (float)(s0 + j - (len - 1));
      if (I8) {
        int kw[WPL];
#pragma unroll
        for (int c = 0; c < WPL; ++c)
          kw[c] = *reinterpret_cast<const int*>(
              reinterpret_cast<const int8_t*>(a.k) + row * D + lane * VPL +
              c * 4);
        const float ksc = __bfloat162float(a.ks[row]);
#pragma unroll
        for (int hg = 0; hg < MAXG; ++hg) {
          if (hg >= G) break;
          int d = 0;
#pragma unroll
          for (int c = 0; c < WPL; ++c)
            d = __dp4a(kw[c], (int)q8[hg][lane * WPL + c], d);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, o);
          if (lane == 0)
            p[hg][j] = score(a, (float)d * qk[hg] * ksc, h0 + hg, dist);
        }
      } else {
        float kf[VPL];
#pragma unroll
        for (int c = 0; c < VPL / 4; ++c) {
          const uint2 raw = *reinterpret_cast<const uint2*>(
              reinterpret_cast<const __nv_bfloat16*>(a.k) + row * D +
              lane * VPL + c * 4);
          const __nv_bfloat162 k01 =
              *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
          const __nv_bfloat162 k23 =
              *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
          kf[c * 4] = __low2float(k01);
          kf[c * 4 + 1] = __high2float(k01);
          kf[c * 4 + 2] = __low2float(k23);
          kf[c * 4 + 3] = __high2float(k23);
        }
#pragma unroll
        for (int hg = 0; hg < MAXG; ++hg) {
          if (hg >= G) break;
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < VPL; ++i) d += kf[i] * qs[hg][lane * VPL + i];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, o);
          if (lane == 0) p[hg][j] = score(a, d * a.scale, h0 + hg, dist);
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

  // P V: thread tid owns output dims tid + 128 * e for every head
  float acc[MAXG][DPT];
#pragma unroll
  for (int hg = 0; hg < MAXG; ++hg)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[hg][e] = 0.f;
  for (int j = j0; j < nj; ++j) {
    const size_t row = rows[j];
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const size_t at = row * D + tid + 128 * e;
      if (I8) {
        const float vv = (float)reinterpret_cast<const int8_t*>(a.v)[at];
        const float vsc = __bfloat162float(a.vs[row]);
#pragma unroll
        for (int hg = 0; hg < MAXG; ++hg)
          if (hg < G) acc[hg][e] += (p[hg][j] * vsc) * vv;
      } else {
        const float vv = __bfloat162float(
            reinterpret_cast<const __nv_bfloat16*>(a.v)[at]);
#pragma unroll
        for (int hg = 0; hg < MAXG; ++hg)
          if (hg < G)
            acc[hg][e] += __bfloat162float(__float2bfloat16(p[hg][j])) * vv;
      }
    }
  }
#pragma unroll
  for (int hg = 0; hg < MAXG; ++hg) {
    if (hg >= G) break;
    const size_t r = (size_t)b * a.Hq + h0 + hg;
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      a.part_o[(r * a.n_split + split) * D + tid + 128 * e] = acc[hg][e];
    if (tid == 0) {
      a.part_ml[(r * a.n_split + split) * 2] = ms[hg];
      a.part_ml[(r * a.n_split + split) * 2 + 1] = ls[hg];
    }
  }
}

// merges the chunks that decode_partial wrote: those from the window's
// floor up to the fill
template <int D>
__global__ void __launch_bounds__(128) decode_combine(const Args a) {
  const int row = blockIdx.x, b = row / a.Hq;
  const int len = min(a.lengths[b], a.S);
  const int c0 = window_floor(a, len) / CHUNK;
  const int nv = min((len + CHUNK - 1) / CHUNK, a.n_split);
  float m = NEG;
  for (int c = c0; c < nv; ++c)
    m = fmaxf(m, a.part_ml[((size_t)row * a.n_split + c) * 2]);
#pragma unroll
  for (int e = 0; e < D / 128; ++e) {
    const int d = threadIdx.x + 128 * e;
    float l = 0.f, o = 0.f;
    for (int c = c0; c < nv; ++c) {
      const size_t i = (size_t)row * a.n_split + c;
      const float w = expf(a.part_ml[i * 2] - m);
      l += w * a.part_ml[i * 2 + 1];
      o += w * a.part_o[i * D + d];
    }
    a.out[(size_t)row * D + d] = o / fmaxf(l, 1e-30f);
  }
}

template <int D, bool I8, bool PAGED>
int launch_d(const Args& a, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int G = a.Hq / a.Hkv;
  decode_partial<D, I8, PAGED>
      <<<dim3(a.n_split, a.B * a.Hkv, (G + MAXG - 1) / MAXG), 128, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine<D><<<a.B * a.Hq, 128, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool I8, bool PAGED>
int launch(const Args& a, int D, void* stream) {
  if (D == 128) return launch_d<128, I8, PAGED>(a, stream);
  if (D == 256) return launch_d<256, I8, PAGED>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace decode_attn

// One exported C entry point per variant; every pointer and the stream as
// void*, the scale and the softcap as float, cudaGetLastError() as the
// result.
#define DECODE_ATTN_ENTRY(NAME, I8, PAGED)                                    \
  extern "C" int NAME(const void* q, const void* k, const void* v,            \
                      const void* ks, const void* vs, const void* table,      \
                      const void* lengths, const void* slopes, void* part_o,  \
                      void* part_ml, void* out, int B, int Hq, int Hkv,       \
                      int S, int ps, int maxp, int n_split, int D,            \
                      float scale, float softcap, int window, void* stream) { \
    const decode_attn::Args a{                                                \
        reinterpret_cast<const __nv_bfloat16*>(q), k, v,                      \
        reinterpret_cast<const __nv_bfloat16*>(ks),                           \
        reinterpret_cast<const __nv_bfloat16*>(vs),                           \
        reinterpret_cast<const int*>(table),                                  \
        reinterpret_cast<const int*>(lengths),                                \
        reinterpret_cast<const float*>(slopes),                               \
        reinterpret_cast<float*>(part_o), reinterpret_cast<float*>(part_ml),  \
        reinterpret_cast<float*>(out), B, Hq, Hkv, S, ps, maxp, n_split,      \
        scale, softcap, window};                                              \
    return decode_attn::launch<I8, PAGED>(a, D, stream);                      \
  }
