// K3 flash_prefill: causal flash attention over a bf16 or int8 KV cache for
// Hopper.
//
// Replaces neural_tpu/ops/attention.py:_prefill_kernel (launched by
// flash_prefill). q [B, T, Hq, D] bf16 with D = 128 or 256 (a template
// parameter); the cache k, v [B, Hkv, S, D] already holds this prefill's
// keys; query row t sits at position starts[b] + t and sees keys
// s <= starts[b] + t, and with a sliding window (window > 0) only keys
// s > starts[b] + t - window; query head h reads KV head h / (Hq / Hkv).
// With softcap > 0 the scaled score becomes softcap * tanh(s / softcap)
// before the mask. With ALiBi slopes [Hq] f32 (nullptr: off), query head h
// adds slopes[h] * (kpos - qpos) to it, after the softcap and before the
// mask, a product and a sum each rounded in f32 as the plain version does.
// With the GLM prefix mask prefix_len [B] int32 (nullptr, or a row's 0:
// off), keys kpos < prefix_len[b] - 1 are visible to every query of row b
// as well: the mask is (causal and window) or prefix, the TPU kernel's.
// Masked scores are -1e30, l is floored at 1e-30 and sums
// the unrounded P, the softmax statistics are f32, and the output is f32
// [B, T, Hq, D] — the TPU kernel's rounding:
// - bf16 cache (flash_prefill): QK^T and PV are bf16 products with f32
//   accumulation; P is rounded to bf16 for the PV product.
// - int8 cache with bf16 scales [B, Hkv, S] (flash_prefill_i8): each q row
//   is quantized, q8 = rint(q * (127 / qa)) with qa = max|q| + 1e-9 (a true
//   division); QK^T is an exact int8 product (mma.sync m16n8k32 s8, int32
//   accumulation) and s = d * (qa * scale / 127) * k_scale; the v scale
//   multiplies P, which is rounded to bf16 for a bf16 PV product against the
//   int8 v codes widened to bf16 (exact).
//
// What bounds it on the H100: the operations (4 * T * S_visible * D per
// head: about half of T x S under the causal mask, T x window under a
// window). The design is FlashAttention-2 style: one block per
// (b * Hq + h, 64 query rows), 4 warps of 16 rows each; K and V tiles of 64
// keys go through dynamic shared memory (the int8 tiles at half the bytes,
// with their scales as f32 rows); QK^T and PV run on the tensor cores with
// mma.sync; the score fragment is reused in registers as PV's A operand.
// Key tiles above the causal diagonal of the block are never loaded, and
// under a window neither are the tiles wholly below the window floor of the
// block's first row, as the TPU kernel clamps its S blocks; the tile that
// holds a row's floor masks per element. Under the prefix mask the key loop
// runs up to the prefix's last visible key, prefix_len[b] - 2, where that
// lies past the causal diagonal (the TPU kernel's clamp_s). Each option is
// a uniform test per element, so a launch with both off does what it did
// before they existed. At D = 256 the output fragment is
// 128 registers a thread, so bf16 q is read from a shared tile at each k
// step instead of being held in 64 more registers (int8 q codes stay in
// registers). Any T and S: ragged edges are masked. The TPU's sequential S
// grid becomes the in-block loop over key tiles. wgmma and TMA are later
// work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;      // query rows per block
constexpr int BKV = 64;     // keys per tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four bf16 q values → floats
__device__ __forceinline__ void load4(const __nv_bfloat16* p, bool ok,
                                      float* x) {
  if (!ok) {
    x[0] = x[1] = x[2] = x[3] = 0.f;
    return;
  }
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  x[0] = __low2float(a);
  x[1] = __high2float(a);
  x[2] = __low2float(b);
  x[3] = __high2float(b);
}

// rint(x * r) of four values as int8 codes, the first in the low byte
__device__ __forceinline__ uint32_t pack_codes(const float* x, float r) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w |= (uint32_t)(uint8_t)(int8_t)(int)rintf(x[i] * r) << (8 * i);
  return w;
}

// bf16 q in a shared tile instead of registers (see the note above)
template <int D, bool I8>
__host__ __device__ constexpr bool q_in_smem() {
  return !I8 && D > 128;
}

// dynamic shared memory of one block, in bytes: bf16 K and V tiles
// [BKV][D + 8] (and the q tile [BQ][D + 8]), or int8 K and V tiles
// [BKV][D + 16] and the tile's k and v scales as f32
template <int D, bool I8>
__host__ __device__ constexpr int smem_bytes() {
  return I8 ? 2 * BKV * (D + 16) + 2 * BKV * 4
            : (2 * BKV + (q_in_smem<D, I8>() ? BQ : 0)) * (D + 8) * 2;
}

template <int D, bool I8>
__global__ void __launch_bounds__(128)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const void* __restrict__ k_, const void* __restrict__ v_,
                     const __nv_bfloat16* __restrict__ ks,
                     const __nv_bfloat16* __restrict__ vs,
                     const int* __restrict__ starts,
                     const float* __restrict__ slopes,
                     const int* __restrict__ prefix_len,
                     float* __restrict__ out, int T, int Hq, int Hkv, int S,
                     float scale, float softcap, int window) {
  constexpr int LD = D + 8;      // shared row stride in bf16
  constexpr int LD8 = D + 16;    // shared row stride in int8 (16-byte rows)
  constexpr int NK = D / 16;     // k16 steps of the bf16 QK^T
  constexpr int NK8 = D / 32;    // k32 steps of the int8 QK^T
  constexpr int NO = D / 8;      // n8 tiles of the output
  constexpr bool QSMEM = q_in_smem<D, I8>();
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BKV * LD;
  __nv_bfloat16* Qs = Vs + BKV * LD;
  int8_t* Ks8 = reinterpret_cast<int8_t*>(smem);
  int8_t* Vs8 = Ks8 + BKV * LD8;
  float* kss = reinterpret_cast<float*>(smem + 2 * BKV * LD8);
  float* vss = kss + BKV;

  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int t0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int start = starts[b];
  const int ra = t0 + warp * 16 + g, rb = ra + 8;   // this thread's rows
  const int posa = start + ra, posb = start + rb;
  const bool alibi = slopes != nullptr;
  const float slope = alibi ? slopes[h] : 0.f;
  // keys below pref_m1 are visible to every row (-2^30: none)
  const int pref = prefix_len != nullptr ? prefix_len[b] : 0;
  const int pref_m1 = pref > 0 ? pref - 1 : -(1 << 30);

  // Q fragments (A operand, row-major [query][dim]): the k16 steps of
  // bf16, or the k32 steps of int8 codes
  uint32_t qf[QSMEM ? 1 : (I8 ? NK8 : NK)][4];
  float qsa = 0.f, qsb = 0.f;   // int8: qa * scale / 127 of rows ra, rb
  const __nv_bfloat16* qa = q + ((size_t)(b * T + ra) * Hq + h) * D;
  const __nv_bfloat16* qb = q + ((size_t)(b * T + rb) * Hq + h) * D;
  if constexpr (I8) {
    // the quad of a row holds it: group i of 4 dims of this thread sits at
    // k32 step i / 2, half i % 2
    float mxa = 0.f, mxb = 0.f;
#pragma unroll
    for (int i = 0; i < 2 * NK8; ++i) {
      const int c = (i / 2) * 32 + (i % 2) * 16 + tq * 4;
      float xa[4], xb[4];
      load4(qa + c, ra < T, xa);
      load4(qb + c, rb < T, xb);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mxa = fmaxf(mxa, fabsf(xa[j]));
        mxb = fmaxf(mxb, fabsf(xb[j]));
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
      mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
    }
    const float qaa = mxa + 1e-9f, qab = mxb + 1e-9f;
    const float rA = 127.f / qaa, rB = 127.f / qab;
#pragma unroll
    for (int kk = 0; kk < NK8; ++kk) {
      const int c = kk * 32 + tq * 4;
      float x[4][4];
      load4(qa + c, ra < T, x[0]);
      load4(qb + c, rb < T, x[1]);
      load4(qa + c + 16, ra < T, x[2]);
      load4(qb + c + 16, rb < T, x[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[kk][i] = pack_codes(x[i], i % 2 ? rB : rA);
    }
    qsa = qaa * scale;
    qsb = qab * scale;
  } else if constexpr (QSMEM) {
    // made visible by the __syncthreads() that opens the key loop
    for (int i = threadIdx.x; i < BQ * D / 8; i += 128) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (t0 + r < T)
        x = *reinterpret_cast<const uint4*>(
            q + ((size_t)(b * T + t0 + r) * Hq + h) * D + c);
      *reinterpret_cast<uint4*>(Qs + r * LD + c) = x;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int c = kk * 16 + tq * 2;
      qf[kk][0] = ra < T ? ld32(qa + c) : 0u;
      qf[kk][1] = rb < T ? ld32(qb + c) : 0u;
      qf[kk][2] = ra < T ? ld32(qa + c + 8) : 0u;
      qf[kk][3] = rb < T ? ld32(qb + c + 8) : 0u;
    }
  }

  float o[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  float ma = NEG, mb = NEG, la = 0.f, lb = 0.f;

  const int last_q = start + min(t0 + BQ, T) - 1;   // causal diagonal
  const int kv_end = min(max(last_q + 1, pref_m1), S);
  // window floor of the block's first row, down to a tile edge
  const int kv_begin =
      window > 0 ? max(start + t0 - window + 1, 0) / BKV * BKV : 0;
  const size_t head = (size_t)(b * Hkv + hk) * S;   // first key row
  const unsigned short* Vu = reinterpret_cast<const unsigned short*>(Vs);
  const __nv_bfloat16* qrow = Qs + (warp * 16 + g) * LD;   // QSMEM: row ra

  for (int s0 = kv_begin; s0 < kv_end; s0 += BKV) {
    __syncthreads();                  // the previous tile is consumed
    if constexpr (I8) {
      const int8_t* kbase = reinterpret_cast<const int8_t*>(k_) + head * D;
      const int8_t* vbase = reinterpret_cast<const int8_t*>(v_) + head * D;
      for (int i = threadIdx.x; i < BKV * D / 16; i += 128) {
        const int r = i / (D / 16), c = (i % (D / 16)) * 16;
        uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
        if (s0 + r < S) {
          kv = *reinterpret_cast<const uint4*>(kbase + (size_t)(s0 + r) * D + c);
          vv = *reinterpret_cast<const uint4*>(vbase + (size_t)(s0 + r) * D + c);
        }
        *reinterpret_cast<uint4*>(Ks8 + r * LD8 + c) = kv;
        *reinterpret_cast<uint4*>(Vs8 + r * LD8 + c) = vv;
      }
      if (threadIdx.x < BKV) {
        const int s = s0 + threadIdx.x;
        kss[threadIdx.x] = s < S ? __bfloat162float(ks[head + s]) : 0.f;
        vss[threadIdx.x] = s < S ? __bfloat162float(vs[head + s]) : 0.f;
      }
    } else {
      const __nv_bfloat16* kbase =
          reinterpret_cast<const __nv_bfloat16*>(k_) + head * D;
      const __nv_bfloat16* vbase =
          reinterpret_cast<const __nv_bfloat16*>(v_) + head * D;
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
    }
    __syncthreads();

    // scores: 16 rows x 64 keys per warp, 8 n8 tiles
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if constexpr (I8) {
        int si[4] = {0, 0, 0, 0};
        const int8_t* krow = Ks8 + (nt * 8 + g) * LD8;
#pragma unroll
        for (int kk = 0; kk < NK8; ++kk) {
          const uint32_t bf[2] = {ld32(krow + kk * 32 + tq * 4),
                                  ld32(krow + kk * 32 + 16 + tq * 4)};
          mma_s8(si, qf[kk], bf);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[nt][j] = (float)si[j] * (j < 2 ? qsa : qsb) *
                      kss[nt * 8 + tq * 2 + (j & 1)];
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[nt][j] = 0.f;
        const __nv_bfloat16* krow = Ks + (nt * 8 + g) * LD;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          const uint32_t bf[2] = {ld32(krow + kk * 16 + tq * 2),
                                  ld32(krow + kk * 16 + 8 + tq * 2)};
          if constexpr (QSMEM) {
            const __nv_bfloat16* qc = qrow + kk * 16 + tq * 2;
            const uint32_t af[4] = {ld32(qc), ld32(qc + 8 * LD),
                                    ld32(qc + 8), ld32(qc + 8 * LD + 8)};
            mma_bf16(sc[nt], af, bf);
          } else {
            mma_bf16(sc[nt], qf[kk], bf);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[nt][j] *= scale;
      }
    }
    // softcap, mask, running max
    float mxa = ma, mxb = mb;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = s0 + nt * 8 + tq * 2 + (j & 1);
        const int qpos = j < 2 ? posa : posb;
        if (softcap > 0.f) sc[nt][j] = softcap * tanhf(sc[nt][j] / softcap);
        if (alibi)
          sc[nt][j] = __fadd_rn(sc[nt][j],
                                __fmul_rn(slope, (float)(key - qpos)));
        const bool hidden =
            (key > qpos || (window > 0 && key <= qpos - window)) &&
            key >= pref_m1;
        if (hidden || key >= S) sc[nt][j] = NEG;
      }
      mxa = fmaxf(mxa, fmaxf(sc[nt][0], sc[nt][1]));
      mxb = fmaxf(mxb, fmaxf(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
      mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
    }
    // A row whose keys in this tile are all masked (the tile below its own
    // window floor) sums garbage at max -1e30 here; its first visible key
    // raises the max and exp(-1e30 - max) = 0 then clears it.
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
    for (int nt = 0; nt < NO; ++nt) {
      o[nt][0] *= alpha_a;
      o[nt][1] *= alpha_a;
      o[nt][2] *= alpha_b;
      o[nt][3] *= alpha_b;
    }
    if constexpr (I8) {   // fold the v scale into P's columns
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float v0 = vss[nt * 8 + tq * 2], v1 = vss[nt * 8 + tq * 2 + 1];
        sc[nt][0] *= v0;
        sc[nt][1] *= v1;
        sc[nt][2] *= v0;
        sc[nt][3] *= v1;
      }
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
      for (int nt = 0; nt < NO; ++nt) {
        const int dcol = nt * 8 + g;
        uint32_t bf[2];
        if constexpr (I8) {
          const int8_t* vc = Vs8 + dcol;
          bf[0] = pack_bf16((float)vc[key0 * LD8], (float)vc[(key0 + 1) * LD8]);
          bf[1] = pack_bf16((float)vc[(key0 + 8) * LD8],
                            (float)vc[(key0 + 9) * LD8]);
        } else {
          bf[0] = (uint32_t)Vu[key0 * LD + dcol] |
                  ((uint32_t)Vu[(key0 + 1) * LD + dcol] << 16);
          bf[1] = (uint32_t)Vu[(key0 + 8) * LD + dcol] |
                  ((uint32_t)Vu[(key0 + 9) * LD + dcol] << 16);
        }
        mma_bf16(o[nt], pa, bf);
      }
    }
  }

  const float inva = 1.f / fmaxf(la, 1e-30f), invb = 1.f / fmaxf(lb, 1e-30f);
  float* oa = out + ((size_t)(b * T + ra) * Hq + h) * D;
  float* ob = out + ((size_t)(b * T + rb) * Hq + h) * D;
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) {
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

template <int D, bool I8>
int launch_d(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* starts, const void* slopes,
             const void* prefix_len, void* out, int B, int T, int Hq, int Hkv,
             int S, float scale, float softcap, int window, void* stream) {
  constexpr int smem = smem_bytes<D, I8>();
  // above 48 KB a block's dynamic shared memory must be allowed first;
  // once per kernel, on its first launch (never inside a graph capture:
  // every caller launches eagerly before it captures)
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<D, I8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((T + BQ - 1) / BQ, B * Hq);
  flash_prefill_kernel<D, I8><<<grid, 128, smem,
                                reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), k, v,
      reinterpret_cast<const __nv_bfloat16*>(ks),
      reinterpret_cast<const __nv_bfloat16*>(vs),
      reinterpret_cast<const int*>(starts),
      reinterpret_cast<const float*>(slopes),
      reinterpret_cast<const int*>(prefix_len), reinterpret_cast<float*>(out),
      T, Hq, Hkv, S, scale, softcap, window);
  return (int)cudaGetLastError();
}

template <bool I8>
int launch(int D, const void* q, const void* k, const void* v,
           const void* ks, const void* vs, const void* starts,
           const void* slopes, const void* prefix_len, void* out, int B,
           int T, int Hq, int Hkv, int S, float scale, float softcap,
           int window, void* stream) {
  if (D == 128)
    return launch_d<128, I8>(q, k, v, ks, vs, starts, slopes, prefix_len,
                             out, B, T, Hq, Hkv, S, scale, softcap, window,
                             stream);
  if (D == 256)
    return launch_d<256, I8>(q, k, v, ks, vs, starts, slopes, prefix_len,
                             out, B, T, Hq, Hkv, S, scale, softcap, window,
                             stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// slopes [Hq] f32 and prefix_len [B] int32 may each be null (off)
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const void* starts, const void* slopes,
                             const void* prefix_len, void* out, int B, int T,
                             int Hq, int Hkv, int S, int D, float scale,
                             float softcap, int window, void* stream) {
  return launch<false>(D, q, k, v, nullptr, nullptr, starts, slopes,
                       prefix_len, out, B, T, Hq, Hkv, S, scale, softcap,
                       window, stream);
}

// scale here is the softmax scale / 127
extern "C" int flash_prefill_i8(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* starts, const void* slopes,
                                const void* prefix_len, void* out, int B,
                                int T, int Hq, int Hkv, int S, int D,
                                float scale, float softcap, int window,
                                void* stream) {
  return launch<true>(D, q, k, v, k_scale, v_scale, starts, slopes,
                      prefix_len, out, B, T, Hq, Hkv, S, scale, softcap,
                      window, stream);
}
