// K4 flash_decode: split-S decode attention (T = 1) over a bf16 KV cache
// for Hopper.
//
// Replaces neural_tpu/ops/attention.py:_decode_kernel (launched by
// flash_decode). q [B, Hq, 128] bf16, caches [B, Hkv, S, 128] bf16, keys at
// positions >= lengths[b] masked; the G = Hq / Hkv query heads of a KV head
// are computed together and share each K/V row. bf16 operands with f32
// products and sums, f32 softmax statistics, P rounded to bf16 for the PV
// product, output f32 [B, Hq, 128].
//
// What bounds it on the H100: the bytes — each filled K and V row is read
// once, 2 * 2 * 128 bytes per key and KV head, against ~2 * G * 128
// multiply-adds. At batch 1 the 32 KV heads of a 7B cannot fill 132 SMs, so
// S is split into 64-key chunks across blocks (flash-decoding): each block
// writes its chunk's (max, sum, unnormalized output) and a combine pass
// merges the chunks up to the fill. A block whose chunk starts at or past
// the fill returns at once, so cache rows past the fill are never read and
// the number of chunks needs no host-side knowledge of the fill.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int CHUNK = 64;
constexpr int MAXG = 8;
constexpr float NEG = -1e30f;

__global__ void __launch_bounds__(128)
decode_partial(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const int* __restrict__ lengths, float* __restrict__ part_o,
               float* __restrict__ part_ml, int Hq, int Hkv, int S,
               int n_split, float scale) {
  __shared__ float qs[MAXG][D];
  __shared__ float p[MAXG][CHUNK];
  __shared__ float ms[MAXG], ls[MAXG];
  const int split = blockIdx.x, bk = blockIdx.y;
  const int b = bk / Hkv, hk = bk % Hkv, G = Hq / Hkv;
  const int len = min(lengths[b], S);
  const int s0 = split * CHUNK;
  if (s0 >= len) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < G * D; i += 128)
    qs[i / D][i % D] =
        __bfloat162float(q[((size_t)b * Hq + hk * G + i / D) * D + i % D]);
  __syncthreads();

  const __nv_bfloat16* kb = k + (size_t)(b * Hkv + hk) * S * D;
  const __nv_bfloat16* vb = v + (size_t)(b * Hkv + hk) * S * D;
  // scores: one warp per key, each lane 4 dims
  for (int j = warp; j < CHUNK; j += 4) {
    const int s = s0 + j;
    if (s < len) {
      const uint2 raw =
          *reinterpret_cast<const uint2*>(kb + (size_t)s * D + lane * 4);
      const __nv_bfloat162 k01 = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
      const __nv_bfloat162 k23 = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
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
        if (lane == 0) p[hg][j] = d * scale;
      }
    } else if (lane == 0) {
      for (int hg = 0; hg < G; ++hg) p[hg][j] = NEG;
    }
  }
  __syncthreads();

  // chunk softmax statistics, one warp per head
  for (int hg = warp; hg < G; hg += 4) {
    const float a = p[hg][lane], c = p[hg][lane + 32];
    float m = fmaxf(a, c);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float pa = expf(a - m), pc = expf(c - m);
    float l = pa + pc;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    p[hg][lane] = pa;
    p[hg][lane + 32] = pc;
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
  const int nj = min(CHUNK, len - s0);
  for (int j = 0; j < nj; ++j) {
    const float vv = __bfloat162float(vb[(size_t)(s0 + j) * D + tid]);
#pragma unroll
    for (int hg = 0; hg < MAXG; ++hg)
      if (hg < G)
        acc[hg] += __bfloat162float(__float2bfloat16(p[hg][j])) * vv;
  }
#pragma unroll
  for (int hg = 0; hg < MAXG; ++hg) {
    if (hg >= G) break;
    const size_t row = (size_t)b * Hq + hk * G + hg;
    part_o[(row * n_split + split) * D + tid] = acc[hg];
    if (tid == 0) {
      part_ml[(row * n_split + split) * 2] = ms[hg];
      part_ml[(row * n_split + split) * 2 + 1] = ls[hg];
    }
  }
}

__global__ void __launch_bounds__(128)
decode_combine(const float* __restrict__ part_o,
               const float* __restrict__ part_ml,
               const int* __restrict__ lengths, float* __restrict__ out,
               int Hq, int S, int n_split) {
  const int row = blockIdx.x, b = row / Hq, d = threadIdx.x;
  const int len = min(lengths[b], S);
  const int nv = min((len + CHUNK - 1) / CHUNK, n_split);
  float m = NEG;
  for (int c = 0; c < nv; ++c)
    m = fmaxf(m, part_ml[((size_t)row * n_split + c) * 2]);
  float l = 0.f, o = 0.f;
  for (int c = 0; c < nv; ++c) {
    const size_t i = (size_t)row * n_split + c;
    const float w = expf(part_ml[i * 2] - m);
    l += w * part_ml[i * 2 + 1];
    o += w * part_o[i * D + d];
  }
  out[(size_t)row * D + d] = o / fmaxf(l, 1e-30f);
}

}  // namespace

extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* lengths, void* part_o, void* part_ml,
                            void* out, int B, int Hq, int Hkv, int S,
                            int n_split, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  decode_partial<<<dim3(n_split, B * Hkv), 128, 0, st>>>(
      reinterpret_cast<const __nv_bfloat16*>(q),
      reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v),
      reinterpret_cast<const int*>(lengths),
      reinterpret_cast<float*>(part_o), reinterpret_cast<float*>(part_ml), Hq,
      Hkv, S, n_split, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine<<<B * Hq, 128, 0, st>>>(
      reinterpret_cast<const float*>(part_o),
      reinterpret_cast<const float*>(part_ml),
      reinterpret_cast<const int*>(lengths), reinterpret_cast<float*>(out),
      Hq, S, n_split);
  return (int)cudaGetLastError();
}
