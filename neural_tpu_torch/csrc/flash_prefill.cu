// K3 flash_prefill: causal flash attention over a bf16 KV cache for Hopper.
//
// Replaces neural_tpu/ops/attention.py:_prefill_kernel (launched by
// flash_prefill). q [B, T, Hq, 128] bf16; the cache k, v [B, Hkv, S, 128]
// bf16 already holds this prefill's keys; query row t sits at position
// starts[b] + t and sees keys s <= starts[b] + t; query head h reads KV
// head h / (Hq / Hkv). QK^T and PV are bf16 products with f32
// accumulation, the softmax statistics are f32, masked scores are -1e30,
// l is floored at 1e-30, and the output is f32 [B, T, Hq, 128] — the TPU
// kernel's rounding (P is rounded to bf16 for the PV product; l sums the
// unrounded P).
//
// What bounds it on the H100: the operations (4 * T * S_visible * 128 per
// head, about half of T x S under the causal mask). The design is
// FlashAttention-2 style: one block per (b * Hq + h, 64 query rows), 4
// warps of 16 rows each; K and V tiles of 64 keys go through shared memory;
// QK^T and PV run on the tensor cores with mma.sync m16n8k16 bf16; the
// score fragment is reused in registers as PV's A operand; key tiles above
// the causal diagonal of the block are never loaded. Any T and S: ragged
// edges are masked. The TPU's sequential S grid becomes the in-block loop
// over key tiles. wgmma and TMA are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int D = 128;      // head dim
constexpr int BQ = 64;      // query rows per block
constexpr int BKV = 64;     // keys per tile
constexpr int LD = D + 8;   // shared row stride in bf16
constexpr float NEG = -1e30f;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(128)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ starts, float* __restrict__ out,
                     int T, int Hq, int Hkv, int S, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BKV * LD];
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int t0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int start = starts[b];
  const int ra = t0 + warp * 16 + g, rb = ra + 8;   // this thread's rows
  const int posa = start + ra, posb = start + rb;

  // Q fragments (A operand, row-major [query][dim]) for the 8 k16 steps
  uint32_t qf[8][4];
  const __nv_bfloat16* qa = q + ((size_t)(b * T + ra) * Hq + h) * D;
  const __nv_bfloat16* qb = q + ((size_t)(b * T + rb) * Hq + h) * D;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int c = kk * 16 + tq * 2;
    qf[kk][0] = ra < T ? ld32(qa + c) : 0u;
    qf[kk][1] = rb < T ? ld32(qb + c) : 0u;
    qf[kk][2] = ra < T ? ld32(qa + c + 8) : 0u;
    qf[kk][3] = rb < T ? ld32(qb + c + 8) : 0u;
  }

  float o[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  float ma = NEG, mb = NEG, la = 0.f, lb = 0.f;

  const int last_q = start + min(t0 + BQ, T) - 1;   // causal diagonal
  const int kv_end = min(last_q + 1, S);
  const __nv_bfloat16* kbase = k + (size_t)(b * Hkv + hk) * S * D;
  const __nv_bfloat16* vbase = v + (size_t)(b * Hkv + hk) * S * D;
  const unsigned short* Vu = reinterpret_cast<const unsigned short*>(Vs);

  for (int s0 = 0; s0 < kv_end; s0 += BKV) {
    __syncthreads();                  // the previous tile is consumed
    for (int i = threadIdx.x; i < BKV * D / 8; i += 128) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (s0 + r < S) {
        kv = *reinterpret_cast<const uint4*>(kbase + (size_t)(s0 + r) * D + c);
        vv = *reinterpret_cast<const uint4*>(vbase + (size_t)(s0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + c) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LD + c) = vv;
    }
    __syncthreads();

    // scores: 16 rows x 64 keys per warp, 8 n8 tiles
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[nt][j] = 0.f;
      const __nv_bfloat16* krow = Ks + (nt * 8 + g) * LD;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t bf[2] = {ld32(krow + kk * 16 + tq * 2),
                                ld32(krow + kk * 16 + 8 + tq * 2)};
        mma_bf16(sc[nt], qf[kk], bf);
      }
    }
    // scale, mask, running max
    float mxa = ma, mxb = mb;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = s0 + nt * 8 + tq * 2 + (j & 1);
        const int qpos = j < 2 ? posa : posb;
        float x = sc[nt][j] * scale;
        if (key > qpos || key >= S) x = NEG;
        sc[nt][j] = x;
      }
      mxa = fmaxf(mxa, fmaxf(sc[nt][0], sc[nt][1]));
      mxb = fmaxf(mxb, fmaxf(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
      mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
    }
    const float alpha_a = expf(ma - mxa), alpha_b = expf(mb - mxb);
    float suma = 0.f, sumb = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      sc[nt][0] = expf(sc[nt][0] - mxa);
      sc[nt][1] = expf(sc[nt][1] - mxa);
      sc[nt][2] = expf(sc[nt][2] - mxb);
      sc[nt][3] = expf(sc[nt][3] - mxb);
      suma += sc[nt][0] + sc[nt][1];
      sumb += sc[nt][2] + sc[nt][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      suma += __shfl_xor_sync(0xffffffffu, suma, off);
      sumb += __shfl_xor_sync(0xffffffffu, sumb, off);
    }
    la = la * alpha_a + suma;
    lb = lb * alpha_b + sumb;
    ma = mxa;
    mb = mxb;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      o[nt][0] *= alpha_a;
      o[nt][1] *= alpha_a;
      o[nt][2] *= alpha_b;
      o[nt][3] *= alpha_b;
    }
    // O += P V: P (bf16) from the score fragments, V as B operand [key][dim]
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const int key0 = kk * 16 + tq * 2;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int dcol = nt * 8 + g;
        const uint32_t bf[2] = {
            (uint32_t)Vu[key0 * LD + dcol] |
                ((uint32_t)Vu[(key0 + 1) * LD + dcol] << 16),
            (uint32_t)Vu[(key0 + 8) * LD + dcol] |
                ((uint32_t)Vu[(key0 + 9) * LD + dcol] << 16)};
        mma_bf16(o[nt], pa, bf);
      }
    }
  }

  const float inva = 1.f / fmaxf(la, 1e-30f), invb = 1.f / fmaxf(lb, 1e-30f);
  float* oa = out + ((size_t)(b * T + ra) * Hq + h) * D;
  float* ob = out + ((size_t)(b * T + rb) * Hq + h) * D;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int c = nt * 8 + tq * 2;
    if (ra < T) {
      oa[c] = o[nt][0] * inva;
      oa[c + 1] = o[nt][1] * inva;
    }
    if (rb < T) {
      ob[c] = o[nt][2] * invb;
      ob[c + 1] = o[nt][3] * invb;
    }
  }
}

}  // namespace

extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const void* starts, void* out, int B, int T,
                             int Hq, int Hkv, int S, float scale,
                             void* stream) {
  const dim3 grid((T + BQ - 1) / BQ, B * Hq);
  flash_prefill_kernel<<<grid, 128, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(q),
      reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v),
      reinterpret_cast<const int*>(starts), reinterpret_cast<float*>(out), T,
      Hq, Hkv, S, scale);
  return (int)cudaGetLastError();
}
