// The split-S decode attention body (T = 1) of K4 (flash_decode.cu, a
// contiguous cache) and K6 (paged_decode.cu, a page pool read through a
// page table): one template, PAGED, instantiated in each.
//
// q [B, Hq, D] bf16 with D = 128 or 256 (a template parameter); keys at
// positions >= lengths[b] masked, and with a sliding window (window > 0)
// keys below lengths[b] - window too; the G = Hq / Hkv query heads of KV
// head hk are hk * G .. hk * G + G - 1; output f32 [B, Hq, D]. Key s of
// (b, hk) is row s of [B * Hkv, S, D] (contiguous), or row s % ps of page
// table[b, s / ps] of [P * Hkv, ps, D] (paged).
//
// Numerics, after the TPU kernels (neural_tpu/ops/attention.py
// _decode_kernel, neural_tpu/ops/paged_attention.py _paged_decode_kernel):
// - bf16: bf16 operands, f32 products and sums, scores times the softmax
//   scale, P rounded to bf16 for the PV product, l summed from the
//   unrounded P.
// - int8 with bf16 scales: each q row is quantized, q8 = rint(q * (127 /
//   qa)) with qa = max|q| + 1e-9 (a true division); the QK dot is exact in
//   int32, s = d * (qa * scale / 127) * k_scale; l sums the unscaled P; the
//   v scale multiplies P in f32, and PV is an f32 product with the int8 v
//   codes (no bf16 P, no TF32).
// - softcap > 0: s = softcap * tanh(s / softcap) on the scaled score,
//   before the mask; slopes != nullptr (ALiBi, [Hq] f32): slopes[h] *
//   (pos - (len - 1)) added, a product and a sum each rounded in f32,
//   before the mask.
// Softmax statistics are f32, masked scores -1e30, l floored at 1e-30.
//
// What bounds it on the H100: the bytes — each visible K and V row is read
// once (2 * D bytes per key and KV head at bf16, half at int8, plus 4
// bytes of scales), against ~2 * G * D multiply-adds. The design makes the
// reads wide and early. A block serves all G query heads of one KV head
// (up to 64; a third grid dimension takes the next 64) for one split of S,
// `chunk` keys, and streams the split's tiles of TK keys through a ring of
// NST stages: one thread asks for a tile's K and V rows together by TMA
// (3-D tensor maps over the row space, so rows past S read zeros), before
// the scores, completing on the stage's mbarrier. Paged, the producer
// looks each tile's page up in the table when it issues the tile: a tile
// is one box where the page holds it (the server's 256-key pages), or
// TK / br boxes of br rows (br the largest power of two dividing the
// page) on the same barrier, the barrier expecting all their bytes. The
// split count and the chunk come from ops/attention.py k4_schedule, from B
// * Hkv, the capacity S (MAXP * ps paged) and the card's SM count, never
// from the fill or the window: the kernel reads the lengths on the device,
// a block whose split lies past its row's fill or wholly below its window
// returns at once, and the launch sits in a CUDA graph. Per tile: QK^T on
// the tensor cores with the heads as rows (mma.sync m16n8k16 bf16, or
// m16n8k32 s8 for int8, padded to 16 or 64 heads; G = 1 pads too, the
// operand fetch dominates either way), each warp a quarter of the tile's
// keys, fragments by ldmatrix from the swizzled tiles; the scores through
// shared memory to an online softmax (a warp a head); then PV: bf16 on
// mma.sync with P from shared memory and V by ldmatrix.trans, each warp a
// quarter of the head dims; int8 in f32 on the CUDA cores, each thread 4
// dims of every head for a share of the keys (or of the heads past 16),
// the codes converted exactly without I2F. The softcap, ALiBi and the mask
// (only on a tile that holds the window floor or the fill) are each a
// whole-tile loop behind one test. Each block writes its split's (max,
// sum, unnormalized output); the visible splits are merged by the last
// block of the row (up to FOLD_HEADS heads a KV head) or by a second
// launch.
//
// Precondition of the paged form, as of the TPU kernel's whole-page DMAs:
// every row of a page that a row's table names holds finite K and V (and
// finite scales). The boxes are whole, so the rows past the fill in the
// last tile are read and masked to -1e30, their P exactly 0; a box wholly
// past the fill or below the window reads a visible page again instead of
// looking the table up there. The pool is zeroed at allocation
// (runtime/paged.py) and a freed page keeps old finite K/V, so the
// server's pools meet it. Table entries past a row's fill may point
// anywhere in the pool: they are never read.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "qmm_tc.cuh"

namespace decode_body {
// internal linkage: each source that includes the body keeps its own
// kernels and launch state (a static of a template with external linkage
// would be one object across every library loaded into the process)
namespace {

constexpr int THREADS = 128;
constexpr int NST = 2;           // stages of the K/V ring
constexpr float NEG = -1e30f;
// Up to FOLD_HEADS query heads a KV head, the last block of each (row, KV
// head) to finish merges the splits (an atomic ticket that it puts back to
// 0) instead of a second launch: on the H100 that saves ~1.5 us a launch at
// G = 1, and past 8 heads one block merging every head alone is several
// times slower than the second launch (scripts/attn_variants.py).
constexpr int FOLD_HEADS = 8;

// keys a tile: 32 KB of bf16 K and V at either head dim
template <int D>
__host__ __device__ constexpr int tile_keys() {
  return D == 128 ? 64 : 32;
}

template <int D, bool I8, int MT>
struct Smem {
  static constexpr int TK = tile_keys<D>();
  static constexpr int MP = 16 * MT;                // heads, padded
  static constexpr int KT = I8 ? TK * D : TK * D * 2;   // a K (or V) tile
  static constexpr int STAGE = 2 * KT;
  static constexpr int QLD = I8 ? D + 16 : D + 8;   // q row stride, elements
  static constexpr int PLD = TK + 8;                // bf16 P row stride
  static constexpr int QS = MP * QLD * (I8 ? 1 : 2);
  // f32 scores; at 16 heads q lives in registers after the prologue and
  // the scores take its place, so that 3 blocks fit an SM
  static constexpr int SCB = MP * TK * 4;
  static constexpr int SC_AT = MT == 1 ? 0 : QS;    // offset from q
  static constexpr int PVLD = MP + 4;              // int8 P·vs row stride
  static constexpr int PB = I8 ? TK * PVLD * 4 : MP * PLD * 2;   // P (·vs)
  static constexpr int QSC = MT == 1 ? (SCB > QS ? SCB : QS) : QS + SCB;
  static constexpr int BYTES = NST * STAGE + QSC + PB + 1024;
};

struct Params {
  CUtensorMap mk, mv;
  const __nv_bfloat16* q;
  const __nv_bfloat16* ks;       // int8 only: scales, one per key row
  const __nv_bfloat16* vs;
  const int* table;              // paged: [B, maxp] pages; nullptr: contiguous
  const int* lengths;
  const float* slopes;           // ALiBi [Hq]; nullptr: off
  float* part_o;                 // [B * Hq, n_split, D]
  float* part_ml;                // [B * Hq, n_split, 2]
  float* out;                    // [B, Hq, D]
  int* tickets;                  // [B * Hkv * head groups], zero between
                                 // launches: the splits done of each
  int B, Hq, Hkv, S, n_split, chunk;
  int ps, maxp;                  // paged: rows a page, pages a row of table
  int br;                        // key rows a TMA box: TK, or less in pages
  float scale;                   // bf16: the softmax scale; int8: scale / 127
  float softcap;                 // 0: off
  int window;                    // 0: off
};

__device__ __forceinline__ void ldsm_x2(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

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

// merges the splits decode_partial wrote for `rows` heads from row r0 of
// [B * Hq]: those from the window's floor up to the fill
template <int D>
__device__ __forceinline__ void combine_rows(const Params& p, size_t r0,
                                             int rows, int len, int lo) {
  const int c0 = lo / p.chunk;
  const int nv = min((len + p.chunk - 1) / p.chunk, p.n_split);
  for (int it = threadIdx.x; it < rows * D; it += blockDim.x) {
    const size_t row = r0 + it / D;
    const int d = it % D;
    float m = NEG;
    for (int c = c0; c < nv; ++c)
      m = fmaxf(m, __ldcg(p.part_ml + (row * p.n_split + c) * 2));
    float l = 0.f, o = 0.f;
    for (int c = c0; c < nv; ++c) {
      const size_t i = row * p.n_split + c;
      const float w = expf(__ldcg(p.part_ml + i * 2) - m);
      l += w * __ldcg(p.part_ml + i * 2 + 1);
      o += w * __ldcg(p.part_o + i * D + d);
    }
    p.out[row * D + d] = o / fmaxf(l, 1e-30f);
  }
}

// The KV row of key `key` of (batch row b, KV head hk) in the tensor maps:
// (outer, row) of [B * Hkv, S] (contiguous) or [P * Hkv, ps] (paged, through
// table[b, key / ps]). A paged key is clamped into [lo, len): a box that
// lies wholly below the window's floor or past the fill reads rows of a
// visible key's page (masked; finite by the kernel's precondition), so the
// table is never read outside the row's visible pages.
template <bool PAGED>
__device__ __forceinline__ void kv_at(const Params& p, int b, int hk,
                                      int key, int lo, int len, int& outer,
                                      int& row) {
  if constexpr (PAGED) {
    const int k = min(max(key, lo), len - 1);
    outer = p.table[(size_t)b * p.maxp + k / p.ps] * p.Hkv + hk;
    row = key % p.ps;
  } else {
    outer = b * p.Hkv + hk;
    row = key;
  }
}

template <int D, bool I8, int MT, bool PAGED>
__global__ void __launch_bounds__(THREADS)
decode_partial(const __grid_constant__ Params p) {
  using SM = Smem<D, I8, MT>;
  constexpr int TK = SM::TK, MP = SM::MP, KW = TK / 4, NTW = KW / 8;
  constexpr int ES = I8 ? 1 : 2;            // bytes of a cache element
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[NST];
  __shared__ float sm_m[MP], sm_l[MP], sm_a[MP], sm_qk[MP];
  uint8_t* smem = smem_raw + ((1024 - (qmm_tc::smem_u32(smem_raw) & 1023)) &
                              1023);
  uint8_t* qs = smem + NST * SM::STAGE;
  float* sc = reinterpret_cast<float*>(qs + SM::SC_AT);
  uint8_t* pb = qs + SM::QSC;

  const int split = blockIdx.x, bk = blockIdx.y;
  const int b = bk / p.Hkv, hk = bk % p.Hkv;
  const int G = p.Hq / p.Hkv;
  const int Gb = min(MP, G - (int)blockIdx.z * MP);   // this block's heads
  const int h0 = hk * G + blockIdx.z * MP;
  const int len = min(p.lengths[b], p.S);
  const int lo = p.window > 0 ? max(len - p.window, 0) : 0;
  const int kb = max(split * p.chunk, lo);
  const int ke = min(split * p.chunk + p.chunk, len);
  if (kb >= ke) return;
  const int t_lo = kb / TK, n = (ke + TK - 1) / TK - t_lo;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;

  // a tile's K and V rows, TK / br boxes each (one box unless a page is
  // shorter than the tile), all counted on the stage's barrier
  auto issue = [&](int i) {
    const int s = i % NST;
    uint8_t* st = smem + s * SM::STAGE;
    const int k0 = (t_lo + i) * TK;
    qmm_tc::mbar_expect(&full[s], SM::STAGE);
    for (int r0 = 0; r0 < TK; r0 += p.br) {
      int outer, row;
      kv_at<PAGED>(p, b, hk, k0 + r0, lo, len, outer, row);
      if constexpr (I8) {
        for (int c = 0; c < D / 128; ++c)
          qmm_tc::tma_load_3d(st + c * TK * 128 + r0 * 128, &p.mk, c * 128,
                              row, outer, &full[s]);
        qmm_tc::tma_load_3d(st + SM::KT + r0 * D, &p.mv, 0, row, outer,
                            &full[s]);
      } else {
        for (int c = 0; c < D / 64; ++c) {
          qmm_tc::tma_load_3d(st + c * TK * 128 + r0 * 128, &p.mk, c * 64,
                              row, outer, &full[s]);
          qmm_tc::tma_load_3d(st + SM::KT + c * TK * 128 + r0 * 128, &p.mv,
                              c * 64, row, outer, &full[s]);
        }
      }
    }
  };
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) qmm_tc::mbar_init(&full[s], 1);
    qmm_tc::mbar_init_fence();
    for (int i = 0; i < NST && i < n; ++i) issue(i);
  }

  // q rows (padded with zeros), the softmax state, P's padding rows
  const __nv_bfloat16* qg = p.q + ((size_t)b * p.Hq + h0) * D;
  if constexpr (I8) {
    constexpr int VPL = D / 32;
    for (int r = warp; r < MP; r += 4) {
      float x[VPL], mx = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i)
        x[i] = r < Gb ? __bfloat162float(qg[(size_t)r * D + lane * VPL + i])
                      : 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) mx = fmaxf(mx, fabsf(x[i]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float qa = mx + 1e-9f;
      const float rq = 127.f / qa;
#pragma unroll
      for (int c = 0; c < VPL / 4; ++c) {
        uint32_t w = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w |= (uint32_t)(uint8_t)(int8_t)(int)rintf(x[4 * c + i] * rq)
               << (8 * i);
        *reinterpret_cast<uint32_t*>(qs + r * SM::QLD + lane * VPL + 4 * c) =
            w;
      }
      if (lane == 0) sm_qk[r] = qa * p.scale;
    }
  } else {
    for (int i = tid; i < MP * D / 8; i += THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < Gb) x = *reinterpret_cast<const uint4*>(qg + (size_t)r * D + c);
      *reinterpret_cast<uint4*>(qs + (r * SM::QLD + c) * 2) = x;
    }
    for (int i = tid; i < MP * SM::PLD / 2; i += THREADS)
      reinterpret_cast<uint32_t*>(pb)[i] = 0u;
  }
  if (tid < MP) {
    sm_m[tid] = NEG;
    sm_l[tid] = 0.f;
    sm_a[tid] = 1.f;
  }
  // ALiBi slopes of this thread's score rows
  float sl[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = mt * 16 + g + 8 * e;
      sl[mt][e] = p.slopes != nullptr && r < Gb ? p.slopes[h0 + r] : 0.f;
    }
  __syncthreads();

  const uint32_t qbase = qmm_tc::smem_u32(qs);
  const uint32_t pbase = qmm_tc::smem_u32(pb);
  // ldmatrix row and 16-byte column of this lane in an A fragment (m16 x
  // 32 bytes of k: k16 of bf16, k32 of int8)
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = lane >> 4;
  auto a_addr = [&](uint32_t base, int ld_bytes, int row0, int kk) {
    return base + (row0 + arow) * ld_bytes + kk * 32 + acol * 16;
  };
  constexpr int QLDB = SM::QLD * ES;        // q row stride in bytes
  // q as the A operand of QK^T: kept in registers at 16 heads
  constexpr int QK_STEPS = I8 ? D / 32 : D / 16;   // k32 int8, k16 bf16
  uint32_t qf[MT == 1 ? QK_STEPS : 1][4];
  if constexpr (MT == 1) {
#pragma unroll
    for (int kk = 0; kk < QK_STEPS; ++kk)
      ldsm_x4(qf[kk], a_addr(qbase, QLDB, 0, kk));
    __syncthreads();                 // the scores take q's place
  }

  // PV accumulators: bf16 o[mt][nt] over this warp's D / 4 dims. int8:
  // thread t owns dims 4 dg .. 4 dg + 3 (dg = t % (D / 4)) in slice
  // sl = t / (D / 4) of NSL: at 16 heads a slice takes every NSL-th key of
  // all heads (summed over the slices at the end), at 64 heads a slice
  // takes HS heads over all keys
  constexpr int NO = D / 32;
  constexpr int NSL = 512 / D, HS = MT == 1 ? MP : MP / NSL;
  const int dg = tid % (D / 4), sl8 = tid / (D / 4);
  float o[I8 ? 1 : MT][I8 ? 1 : NO][4];
  float acc[I8 ? HS : 1][4];
#pragma unroll
  for (int a = 0; a < (I8 ? 1 : MT); ++a)
#pragma unroll
    for (int c = 0; c < (I8 ? 1 : NO); ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[a][c][e] = 0.f;
#pragma unroll
  for (int a = 0; a < (I8 ? HS : 1); ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
  // int8: the first head of this thread's slice, and its heads
  const int hs0 = MT == 1 ? 0 : sl8 * HS;
  const int nh = max(0, min(HS, Gb - hs0));

  const bool cap = p.softcap > 0.f, alibi = p.slopes != nullptr;
  // int8: a tile's scales are read into registers one tile ahead, so that
  // their latency hides under the previous tile's work
  float ksv[NTW][2], vsv[TK / 32], ksn[NTW][2], vsn[TK / 32];
  // the scale of a key: rows past S are 0 (contiguous); a paged key is
  // clamped as kv_at clamps it
  auto scale_at = [&](const __nv_bfloat16* sc, int key) {
    if constexpr (PAGED) {
      const int k = min(max(key, lo), len - 1);
      const size_t r =
          ((size_t)p.table[(size_t)b * p.maxp + k / p.ps] * p.Hkv + hk) *
              p.ps + k % p.ps;
      return __bfloat162float(sc[r]);
    } else {
      return key < p.S ? __bfloat162float(sc[(size_t)bk * p.S + key]) : 0.f;
    }
  };
  auto load_scales = [&](int i, float (&ks)[NTW][2], float (&vs)[TK / 32]) {
    if constexpr (I8) {
      const int k0 = (t_lo + i) * TK;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          ks[nt][e] = scale_at(p.ks, k0 + warp * KW + nt * 8 + 2 * tq + e);
#pragma unroll
      for (int u = 0; u < TK / 32; ++u)
        vs[u] = scale_at(p.vs, k0 + lane + 32 * u);
    }
  };
  load_scales(0, ksn, vsn);
  for (int i = 0; i < n; ++i) {
    const int s = i % NST, k0 = (t_lo + i) * TK;
    uint8_t* st = smem + s * SM::STAGE;
    if constexpr (I8) {
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        ksv[nt][0] = ksn[nt][0];
        ksv[nt][1] = ksn[nt][1];
      }
#pragma unroll
      for (int u = 0; u < TK / 32; ++u) vsv[u] = vsn[u];
      if (i + 1 < n) load_scales(i + 1, ksn, vsn);
    }
    qmm_tc::mbar_wait(&full[s], (i / NST) & 1);
    const uint32_t kbase = qmm_tc::smem_u32(st);
    const uint32_t vbase = kbase + SM::KT;
    const bool edge = k0 < lo || k0 + TK > len;

    // scores of this warp's KW keys for every head row: x[mt][nt][e] is
    // row mt * 16 + g (+ 8 for e >= 2), column warp * KW + nt * 8 + 2 tq
    // (+ 1 for odd e) of the tile
    float x[MT][NTW][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        // B rows: keys warp * KW + nt * 8 + (lane & 7); lanes 8-15 the
        // second 16 bytes
        const int brow = warp * KW + nt * 8 + (lane & 7);
        const int bsub = (lane >> 3) & 1;
        if constexpr (I8) {
          int d[4] = {0, 0, 0, 0};
#pragma unroll
          for (int kk = 0; kk < D / 32; ++kk) {
            uint32_t a[4], bf[2];
            if constexpr (MT == 1) {
#pragma unroll
              for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
            } else {
              ldsm_x4(a, a_addr(qbase, QLDB, mt * 16, kk));
            }
            ldsm_x2(bf, kbase + qmm_tc::sw128_off(brow, kk * 32 + bsub * 16,
                                                  TK));
            mma_s8(d, a, bf);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[mt][nt][e] = qmm_tc::dot_f32(d[e]) *
                           sm_qk[mt * 16 + g + 8 * (e >> 1)] * ksv[nt][e & 1];
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) x[mt][nt][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t a[4], bf[2];
            if constexpr (MT == 1) {
#pragma unroll
              for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
            } else {
              ldsm_x4(a, a_addr(qbase, QLDB, mt * 16, kk));
            }
            ldsm_x2(bf, kbase + qmm_tc::sw128_off(brow, kk * 32 + bsub * 16,
                                                  TK));
            mma_bf16(x[mt][nt], a, bf);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) x[mt][nt][e] *= p.scale;
        }
      }
    }
    // the options and the mask, each a whole-tile loop behind one test;
    // column c of this thread is key k0 + warp * KW + 2 tq + c
    const int kt = k0 + warp * KW + 2 * tq;
    if (cap) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[mt][nt][e] = p.softcap * tanhf(x[mt][nt][e] / p.softcap);
    }
    if (alibi) {
      const float dist0 = (float)(kt - (len - 1));   // exact, as the column
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[mt][nt][e] = __fadd_rn(
                x[mt][nt][e],
                __fmul_rn(sl[mt][e >> 1],
                          __fadd_rn(dist0, (float)(nt * 8 + (e & 1)))));
    }
    if (edge) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kt + nt * 8 + (e & 1);
            if (key < lo || key >= len) x[mt][nt][e] = NEG;
          }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = mt * 16 + g + 8 * (e >> 1);
          if (r < Gb)
            sc[r * TK + warp * KW + nt * 8 + 2 * tq + (e & 1)] = x[mt][nt][e];
        }
    __syncthreads();

    // online softmax over the tile, a warp per head
    for (int r = warp; r < Gb; r += 4) {
      float x[TK / 32], mx = NEG;
#pragma unroll
      for (int u = 0; u < TK / 32; ++u) {
        x[u] = sc[r * TK + lane + 32 * u];
        mx = fmaxf(mx, x[u]);
      }
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float m_old = sm_m[r], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < TK / 32; ++u) {
        const float e = expf(x[u] - m_new);
        sum += e;
        if constexpr (I8)
          reinterpret_cast<float*>(pb)[(lane + 32 * u) * SM::PVLD + r] =
              e * vsv[u];
        else
          reinterpret_cast<__nv_bfloat16*>(pb)[r * SM::PLD + lane + 32 * u] =
              __float2bfloat16(e);
      }
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o2);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sm_a[r] = alpha;
        sm_l[r] = sm_l[r] * alpha + sum;
        sm_m[r] = m_new;
      }
    }
    __syncthreads();

    if constexpr (I8) {
      // f32 PV: acc[h][.] = acc * alpha + sum_j (P·vs)[j][h] * v[j][dims]
#pragma unroll
      for (int hh = 0; hh < HS; ++hh) {
        if (hh >= nh) break;
        const float al = sm_a[hs0 + hh];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[hh][e] *= al;
      }
      const uint8_t* vt = st + SM::KT + 4 * dg;
      const float* pv = reinterpret_cast<const float*>(pb) + hs0;
      constexpr int JS = MT == 1 ? NSL : 1;     // key stride of a slice
      if (nh == 1) {             // one head (G = 1): no padded heads
#pragma unroll
        for (int j = MT == 1 ? sl8 : 0; j < TK; j += JS) {
          float v[4];
          qmm_tc::codes_f32(*reinterpret_cast<const uint32_t*>(vt + j * D),
                            v);
          const float pp = pv[j * SM::PVLD];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[0][r] += pp * v[r];
        }
      } else {
#pragma unroll
        for (int j = MT == 1 ? sl8 : 0; j < TK; j += JS) {
          float v[4];
          qmm_tc::codes_f32(*reinterpret_cast<const uint32_t*>(vt + j * D),
                            v);
          // 4 heads a load (the rows past the block's heads are never
          // read out)
#pragma unroll
          for (int h4 = 0; h4 < HS / 4; ++h4) {
            if (4 * h4 >= nh) break;
            const float4 pp =
                *reinterpret_cast<const float4*>(pv + j * SM::PVLD + 4 * h4);
            const float pq[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
            for (int q4 = 0; q4 < 4; ++q4)
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[4 * h4 + q4][r] += pq[q4] * v[r];
          }
        }
      }
    } else {
      // bf16 PV on the tensor cores: this warp's dims w * D / 4 ..
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float al_a = sm_a[mt * 16 + g], al_b = sm_a[mt * 16 + g + 8];
#pragma unroll
        for (int c = 0; c < NO; ++c) {
          o[mt][c][0] *= al_a;
          o[mt][c][1] *= al_a;
          o[mt][c][2] *= al_b;
          o[mt][c][3] *= al_b;
        }
      }
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4(pa[mt], a_addr(pbase, SM::PLD * 2, mt * 16, kk));
        // V rows: keys 16 kk + (lane & 7) (+ 8 for matrices 1, 3), dims
        // + 8 for matrices 2, 3
        const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int c = 0; c < NO; c += 2) {
          const int dim = warp * (D / 4) + c * 8 + (lane >> 4) * 8;
          uint32_t bv[4];
          ldsm_x4_t(bv, vbase + qmm_tc::sw128_off(vrow, dim * 2, TK));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][c], pa[mt], bv);
            mma_bf16(o[mt][c + 1], pa[mt], bv + 2);
          }
        }
      }
    }
    __syncthreads();               // the stage is consumed
    if (tid == 0 && i + NST < n) issue(i + NST);
  }

  // this split's (max, sum, unnormalized output) of each head
  const size_t r0 = (size_t)b * p.Hq + h0;
  if constexpr (I8) {
    if constexpr (MT == 1) {
      // sum the NSL key slices through the (now free) stages
      float* red = reinterpret_cast<float*>(smem);
#pragma unroll
      for (int hh = 0; hh < HS; ++hh) {
        if (hh >= Gb) break;
        *reinterpret_cast<float4*>(red + (sl8 * MP + hh) * D + 4 * dg) =
            make_float4(acc[hh][0], acc[hh][1], acc[hh][2], acc[hh][3]);
      }
      __syncthreads();
      for (int it = tid; it < Gb * D; it += THREADS) {
        const int hh = it / D, d = it % D;
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < NSL; ++k) v += red[(k * MP + hh) * D + d];
        p.part_o[((r0 + hh) * p.n_split + split) * D + d] = v;
      }
    } else {
#pragma unroll
      for (int hh = 0; hh < HS; ++hh) {
        if (hh >= nh) break;
        *reinterpret_cast<float4*>(
            p.part_o + ((r0 + hs0 + hh) * p.n_split + split) * D + 4 * dg) =
            make_float4(acc[hh][0], acc[hh][1], acc[hh][2], acc[hh][3]);
      }
    }
  } else {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int r = mt * 16 + g + 8 * e2;
        if (r >= Gb) continue;
        float* dst = p.part_o + ((r0 + r) * p.n_split + split) * D +
                     warp * (D / 4) + 2 * tq;
#pragma unroll
        for (int c = 0; c < NO; ++c)
          *reinterpret_cast<float2*>(dst + 8 * c) =
              make_float2(o[mt][c][2 * e2], o[mt][c][2 * e2 + 1]);
      }
  }
  if (tid < Gb) {
    p.part_ml[((r0 + tid) * p.n_split + split) * 2] = sm_m[tid];
    p.part_ml[((r0 + tid) * p.n_split + split) * 2 + 1] = sm_l[tid];
  }
  if (G <= FOLD_HEADS) {
    // the last of the row's visible splits to finish merges them all
    __shared__ int last;
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int c0 = lo / p.chunk;
      const int nv = min((len + p.chunk - 1) / p.chunk, p.n_split);
      int* ticket = p.tickets + (size_t)bk * gridDim.z + blockIdx.z;
      last = atomicAdd(ticket, 1) == nv - c0 - 1;
      if (last) *ticket = 0;     // clean for the next launch or replay
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    combine_rows<D>(p, r0, Gb, len, lo);
  }
}

// the same as a second launch, one block a row of [B * Hq]
template <int D>
__global__ void __launch_bounds__(128) decode_combine(const Params p) {
  const int b = blockIdx.x / p.Hq;
  const int len = min(p.lengths[b], p.S);
  combine_rows<D>(p, blockIdx.x, 1, len,
                  p.window > 0 ? max(len - p.window, 0) : 0);
}

template <int D, bool I8, int MT, bool PAGED>
int launch_mt(Params& p, void* stream) {
  using SM = Smem<D, I8, MT>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_partial<D, I8, MT, PAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SM::BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int G = p.Hq / p.Hkv;
  decode_partial<D, I8, MT, PAGED>
      <<<dim3(p.n_split, p.B * p.Hkv, (G + SM::MP - 1) / SM::MP), THREADS,
         SM::BYTES, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || G <= FOLD_HEADS) return (int)e;
  decode_combine<D><<<p.B * p.Hq, 128, 0, st>>>(p);
  return (int)cudaGetLastError();
}

template <int D, bool I8, bool PAGED>
int launch_d(Params& p, const void* k, const void* v, long long outer,
             int rows, void* stream) {
  constexpr int TK = tile_keys<D>();
  if (p.chunk <= 0 || p.chunk % TK || (long long)p.n_split * p.chunk < p.S)
    return (int)cudaErrorInvalidValue;
  // a box stays inside one page: the largest power of two that divides the
  // page (16 or more: pages are whole multiples of 16), up to the tile
  p.br = PAGED ? min(TK, rows & -rows) : TK;
  if (p.br < 16) return (int)cudaErrorInvalidValue;
  using qmm_tc::make_map_3d;
  const bool ok =
      I8 ? make_map_3d(&p.mk, k, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, rows,
                       outer, 128, p.br, true) &&
               make_map_3d(&p.mv, v, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D,
                           rows, outer, D, p.br, false)
         : make_map_3d(&p.mk, k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D, rows,
                       outer, 64, p.br, true) &&
               make_map_3d(&p.mv, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D,
                           rows, outer, 64, p.br, true);
  if (!ok) return (int)cudaErrorInvalidValue;
  if (p.Hq / p.Hkv <= 16) return launch_mt<D, I8, 1, PAGED>(p, stream);
  return launch_mt<D, I8, 4, PAGED>(p, stream);
}

// One launch of the body. Contiguous (PAGED false): caches [B, Hkv, S, D];
// pages, ps and maxp ignored. Paged: pools [P = pages, Hkv, ps, D] read
// through table [B, maxp], S = maxp * ps. ks / vs: the int8 scales ([B,
// Hkv, S] or [P, Hkv, ps]), null for bf16.
template <bool PAGED, bool I8>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* table, const void* lengths,
           const void* slopes, void* part_o, void* part_ml, void* tickets,
           void* out, int B, int Hq, int Hkv, int S, int pages, int ps,
           int maxp, int n_split, int chunk, int D, float scale,
           float softcap, int window, void* stream) {
  if (PAGED && (ps <= 0 || ps % 16 || maxp <= 0 || pages <= 0))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = reinterpret_cast<const __nv_bfloat16*>(q);
  p.ks = reinterpret_cast<const __nv_bfloat16*>(ks);
  p.vs = reinterpret_cast<const __nv_bfloat16*>(vs);
  p.table = reinterpret_cast<const int*>(table);
  p.lengths = reinterpret_cast<const int*>(lengths);
  p.slopes = reinterpret_cast<const float*>(slopes);
  p.part_o = reinterpret_cast<float*>(part_o);
  p.part_ml = reinterpret_cast<float*>(part_ml);
  p.out = reinterpret_cast<float*>(out);
  p.tickets = reinterpret_cast<int*>(tickets);
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.S = PAGED ? maxp * ps : S;
  p.ps = ps;
  p.maxp = maxp;
  p.n_split = n_split;
  p.chunk = chunk;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  const long long outer = (long long)(PAGED ? pages : B) * Hkv;
  const int rows = PAGED ? ps : S;
  if (D == 128) return launch_d<128, I8, PAGED>(p, k, v, outer, rows, stream);
  if (D == 256) return launch_d<256, I8, PAGED>(p, k, v, outer, rows, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace decode_body
