// K3 flash_prefill: causal flash attention over a bf16, int8 or f32 KV cache
// for Hopper.
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
//   division); QK^T is an exact int8 product (int32 accumulation) and
//   s = d * (qa * scale / 127) * k_scale; the v scale multiplies P, which
//   is rounded to bf16 for a bf16 PV product against the int8 v codes
//   widened to bf16 (exact).
// - f32 cache (flash_prefill_f32): each K and V element is rounded to bf16
//   (to nearest even) once, as the TPU kernel's astype(bf16) of an f32
//   block; from there every step is the bf16 branch's, in the same order,
//   so on a cache that holds bf16 values the two are bit-equal.
// The softmax runs on scores times log2(e), through exp2f.
//
// What bounds it on the H100: the operations (4 * T * S_visible * D per
// head: about half of T x S under the causal mask, T x window under a
// window). The design is FlashAttention-3's: blocks of three warpgroups,
// each query block 128 rows of one (b * Hq + h). Warpgroup 2 is the
// producer (setmaxnreg gives its registers to the other two): one thread
// copies the block's q tile by TMA once and then keeps a ring of NST K/V
// stages in flight, each completing on a `full` mbarrier and handed back
// on an `empty` one. Warpgroups 0 and 1 each take 64 query rows: QK^T is
// a wgmma with q and K both K-major under the 128-byte swizzle; the f32
// scores stay in registers, are rounded to bf16 as P, and PV is a wgmma
// with P from registers and V [key][dim] from shared memory as an
// MN-major operand (the transpose bit). int8: QK^T is an s8 wgmma, exact;
// each consumer warpgroup quantizes its q rows into a swizzled int8 tile
// in its prologue, and the producer warpgroup widens each stage's V codes
// to bf16 in the MN-major layout and stages the k and v scales as f32.
// f32: the producer's thread 0 copies the raw f32 rows of K, then of V, a
// piece of RAWR rows at a time into a double buffer, and its four warps
// narrow each piece to bf16 into the stage, in the layout the bf16
// branch's TMA writes (two stages: the raw buffer takes the third's room).
// The tensor maps read q as [B * T, Hq, D] and the caches as
// [B * Hkv, S, D], so a tile past S reads zeros and never the next head's
// rows. A block's key tiles run from the window floor of its first row (or
// key 0 under the prefix mask) to its causal diagonal (or the prefix's
// last visible key, prefix_len[b] - 2, the TPU kernel's clamp_s); a
// warpgroup skips the tiles its own 64 rows cannot see. The per-element
// mask runs only on the tiles that can hold a hidden key for some row of
// the warpgroup (the diagonal, the window floor, the prefix edge, past S);
// the softcap and ALiBi, which change scores, run on every tile when on,
// behind one uniform test a tile; a tile that only the causal diagonal
// masks compares each column with one bound a row. The grid runs the
// query blocks heaviest first (from the diagonal's end), so the light
// ones fill the tail; a persistent grid of one block an SM walking them
// measured slower on the H100 (PERF.md). At D = 128 the QK^T of tile i is
// issued together with the
// P V of tile i - 1, and tile i's softmax runs while that product is in
// flight (at D = 256 the second P spills, so there the tiles run one after
// another). The rule is ops/attention.py k3_schedule; the TPU's sequential
// S grid becomes the in-block loop over key tiles.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "qmm_tc.cuh"

namespace {

constexpr int BQ = 128;          // query rows a block
constexpr int WROWS = 64;        // query rows a consumer warpgroup
constexpr int THREADS = 384;     // consumer warpgroups 0, 1; producer 2
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
// the cache's element type
constexpr int KV_BF16 = 0, KV_I8 = 1, KV_F32 = 2;
// the softmax of tile i runs while P V of tile i - 1 is in flight; at
// D = 256 the second P and the in-flight products spill, so there the
// tiles run one after another
template <int D>
__host__ __device__ constexpr bool overlap() {
  return D == 128;
}

// keys a tile: at D = 256 the f32 output is 128 registers a thread, so the
// scores take 64 keys (32 more) instead of 128 (64 more)
template <int D>
__host__ __device__ constexpr int bkv() {
  return D == 128 ? 128 : 64;
}

// stages of the K/V ring: as many as the 227 KB of shared memory hold
template <int D>
__host__ __device__ constexpr int nst() {
  return D == 128 ? 3 : 2;
}

// Shared memory of one block, in bytes. bf16: the q tile [BQ][D] as D / 64
// swizzled blocks of BQ rows x 128 bytes; a stage: K, then V, each
// [BKV][D] the same way. int8: the q codes [BQ][D] in D / 128 swizzled
// blocks; a stage: the K codes (D / 128 blocks), V widened to bf16 (D / 64
// blocks, the MN-major operand), the raw V codes [BKV][D] unswizzled, and
// the tile's k and v scales as f32. f32: a stage as bf16's, and after the
// ring a double buffer of raw pieces, RAWR rows of f32 K or V each.
template <int D, int KV>
struct Smem {
  static constexpr bool I8 = KV == KV_I8, F32 = KV == KV_F32;
  static constexpr int BKV = bkv<D>(), NST = F32 ? 2 : nst<D>();
  static constexpr int Q = I8 ? BQ * D : BQ * D * 2;
  static constexpr int K = I8 ? BKV * D : BKV * D * 2;
  static constexpr int V = BKV * D * 2;
  static constexpr int VRAW = I8 ? BKV * D : 0;
  static constexpr int SC = I8 ? 2 * BKV * 4 : 0;
  static constexpr int STAGE = (K + V + VRAW + SC + 1023) / 1024 * 1024;
  static constexpr int RAWR = D == 128 ? 64 : 16;
  static constexpr int RAWP = RAWR * D * 4;
  static constexpr int RAW = F32 ? 2 * RAWP : 0;
  static constexpr int BYTES = Q + NST * STAGE + RAW + 1024;   // + alignment
  static_assert(BYTES <= 232448 - 1024, "over the H100's shared memory");
};

struct Params {
  CUtensorMap mq, mk, mv;        // bf16 q; K (codes); V (raw codes)
  const __nv_bfloat16* q;        // int8: read by the consumers
  const __nv_bfloat16* ks;       // int8 scales [B, Hkv, S]
  const __nv_bfloat16* vs;
  const int* starts;
  const float* slopes;
  const int* prefix_len;
  float* out;
  int T, Hq, Hkv, S, n_tb;
  int BH;                        // B * Hq
  float scale;                   // bf16: the softmax scale; int8: / 127
  float softcap;
  int window;
};

// The keys one consumer warpgroup can see ([lo, hi); lo >= hi: its rows
// lie past T) and the positions of its first and last valid rows.
struct WgRange {
  int lo, hi, qlo, qhi;
};

__device__ __forceinline__ WgRange wg_range(const Params& p, int t0, int w,
                                            int start, int pm1) {
  WgRange r{0, 0, 0, 0};
  const int r0 = t0 + w * WROWS;
  if (r0 >= p.T) return r;
  r.qlo = start + r0;
  r.qhi = start + min(r0 + WROWS, p.T) - 1;
  const int end = min(max(r.qhi + 1, pm1), p.S);
  const int beg = p.window > 0 && pm1 <= 0 ? max(r.qlo - p.window + 1, 0) : 0;
  r.lo = beg;
  r.hi = end;
  return r;
}

// Every (row, key) of the warpgroup's rows and the tile's keys [k0, k1) is
// visible and the tile lies inside S: no per-element mask.
__device__ __forceinline__ bool interior(const Params& p, const WgRange& r,
                                         int k0, int k1, int pm1) {
  return k1 <= p.S &&
         (k1 <= pm1 ||
          (k1 - 1 <= r.qlo && (p.window <= 0 || k0 > r.qhi - p.window)));
}

// keeps registers an in-flight wgmma reads from being reused before its
// wait (the compiler sees their last use at the issue)
template <int N>
__device__ __forceinline__ void keep_live(const uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" ::"r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3])
                 : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__device__ __forceinline__ void wgmma_qk(float* s, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (bkv<D>() == 128)
    qmm_tc::wgmma_bf16_n128(s, da, db, scale_d);
  else
    qmm_tc::wgmma_bf16_n64(s, da, db, scale_d);
}

template <int D>
__device__ __forceinline__ void wgmma_qk8(int* s, uint64_t da, uint64_t db,
                                          int scale_d) {
  if constexpr (bkv<D>() == 128)
    qmm_tc::wgmma_s8_n128(s, da, db, scale_d);
  else
    qmm_tc::wgmma_s8_n64(s, da, db, scale_d);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 128)
    qmm_tc::wgmma_bf16_rs_n128(o, a, db, 1);
  else
    qmm_tc::wgmma_bf16_rs_n256(o, a, db, 1);
}

// int8: the producer warpgroup widens a stage's raw V codes [BKV][D] to
// bf16 in the MN-major swizzled layout, 8 codes (16 bytes out) a step
template <int D>
__device__ __forceinline__ void widen_v(const uint8_t* raw, uint8_t* vb,
                                       int pt) {
  constexpr int BKV = bkv<D>();
#pragma unroll 4
  for (int it = pt; it < BKV * D / 8; it += 128) {
    const int r = it / (D / 8), c8 = it % (D / 8);
    const uint2 w = *reinterpret_cast<const uint2*>(raw + r * D + 8 * c8);
    float f[2][4];
    qmm_tc::codes_f32(w.x, f[0]);
    qmm_tc::codes_f32(w.y, f[1]);
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = qmm_tc::bf16_pair_exact(f[i / 2][2 * (i % 2)],
                                     f[i / 2][2 * (i % 2) + 1]);
    *reinterpret_cast<uint4*>(vb + qmm_tc::sw128_off(r, 16 * c8, BKV)) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// One query block of 128 rows: its (b, h), rows, the keys each consumer
// warpgroup can see and the key tiles [lo, lo + n) the block streams.
// Block w (heaviest first: the grid walks the query blocks from the
// diagonal's end) takes query block n_tb - 1 - w / (B * Hq) of
// b * Hq + h = w % (B * Hq).
struct Item {
  int b, h, bk, t0, start, pm1, lo, n;
  WgRange r[2];
};

template <int D>
__device__ __forceinline__ Item item_of(const Params& p, int w) {
  constexpr int BKV = bkv<D>();
  Item it;
  const int bh = w % p.BH;
  it.b = bh / p.Hq;
  it.h = bh % p.Hq;
  it.bk = it.b * p.Hkv + it.h / (p.Hq / p.Hkv);
  it.t0 = (p.n_tb - 1 - w / p.BH) * BQ;
  it.start = p.starts[it.b];
  const int pref = p.prefix_len != nullptr ? p.prefix_len[it.b] : 0;
  it.pm1 = pref > 0 ? pref - 1 : -(1 << 30);   // keys below: visible
  it.r[0] = wg_range(p, it.t0, 0, it.start, it.pm1);
  it.r[1] = wg_range(p, it.t0, 1, it.start, it.pm1);
  const bool two = it.r[1].lo < it.r[1].hi;
  it.lo = (two ? min(it.r[0].lo, it.r[1].lo) : it.r[0].lo) / BKV;
  it.n = ((two ? max(it.r[0].hi, it.r[1].hi) : it.r[0].hi) + BKV - 1) / BKV -
         it.lo;
  return it;
}

template <int D, int KV>
__global__ void __launch_bounds__(THREADS, 1)
flash_prefill_kernel(const __grid_constant__ Params p) {
  using SM = Smem<D, KV>;
  constexpr bool I8 = SM::I8, F32 = SM::F32;
  constexpr int BKV = SM::BKV, NST = SM::NST;
  constexpr int NS = BKV / 2;    // score registers a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t qbar, full[NST], vraw[NST], vfull[NST],
      empty[NST], rawbar[2];
  __shared__ float qsc[BQ];      // int8: qa * scale of each row
  uint8_t* smem = smem_raw + ((1024 - (qmm_tc::smem_u32(smem_raw) & 1023)) &
                              1023);
  uint8_t* sq = smem;
  auto stage = [&](int s) { return smem + SM::Q + s * SM::STAGE; };
  const int tid = threadIdx.x, wg = tid / 128;
  const Item it = item_of<D>(p, blockIdx.x);
  const int b = it.b, h = it.h, t0 = it.t0, n = it.n, lo = it.lo;

  if (tid == 0) {
    qmm_tc::mbar_init(&qbar, 1);
    for (int s = 0; s < NST; ++s) {
      qmm_tc::mbar_init(&full[s], I8 ? 33 : F32 ? 128 : 1);
      qmm_tc::mbar_init(&vraw[s], 1);
      qmm_tc::mbar_init(&vfull[s], 128);
      qmm_tc::mbar_init(&empty[s], 8);
    }
    for (int j = 0; j < 2; ++j) qmm_tc::mbar_init(&rawbar[j], 1);
    qmm_tc::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    qmm_tc::setmaxnreg_dec<PRODUCER_REGS>();
    const int pt = tid - 256, pw = pt / 32, lane = tid % 32;
    if constexpr (KV == KV_BF16) {
      if (pt == 0) {
        qmm_tc::mbar_expect(&qbar, BQ * D * 2);
        for (int c = 0; c < D / 64; ++c)
          qmm_tc::tma_load_3d(sq + c * BQ * 128, &p.mq, c * 64, h,
                              b * p.T + t0, &qbar);
        for (int i = 0; i < n; ++i) {
          const int s = i % NST;
          if (i >= NST) qmm_tc::mbar_wait(&empty[s], (i / NST - 1) & 1);
          uint8_t* st = stage(s);
          const int k0 = (lo + i) * BKV;
          qmm_tc::mbar_expect(&full[s], 2 * BKV * D * 2);
          for (int c = 0; c < D / 64; ++c) {
            qmm_tc::tma_load_3d(st + c * BKV * 128, &p.mk, c * 64, k0, it.bk,
                                &full[s]);
            qmm_tc::tma_load_3d(st + SM::K + c * BKV * 128, &p.mv, c * 64, k0,
                                it.bk, &full[s]);
          }
        }
      }
    } else if constexpr (F32) {
      // thread 0 copies q as the bf16 branch does, and piece j of the raw
      // rows (tile j / PPT: its K rows, then its V rows, RAWR a piece) into
      // buffer j % 2 (onto rawbar); the four warps narrow each piece into
      // its stage and refill the buffer two pieces ahead, then hand the
      // stage over (128 arrivals on full)
      constexpr int RAWR = SM::RAWR, PPT = 2 * BKV / RAWR, HALF = PPT / 2;
      const int total = n * PPT;
      uint8_t* raw = smem + SM::Q + NST * SM::STAGE;
      auto issue_raw = [&](int j) {
        const int pc = j % PPT;
        const int k0 = (lo + j / PPT) * BKV + (pc % HALF) * RAWR;
        qmm_tc::mbar_expect(&rawbar[j % 2], SM::RAWP);
        qmm_tc::tma_load_3d(raw + (j % 2) * SM::RAWP, pc < HALF ? &p.mk : &p.mv,
                            0, k0, it.bk, &rawbar[j % 2]);
      };
      if (pt == 0) {
        qmm_tc::mbar_expect(&qbar, BQ * D * 2);
        for (int c = 0; c < D / 64; ++c)
          qmm_tc::tma_load_3d(sq + c * BQ * 128, &p.mq, c * 64, h,
                              b * p.T + t0, &qbar);
        for (int j = 0; j < 2 && j < total; ++j) issue_raw(j);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % NST;
        uint8_t* st = stage(s);
        if (i >= NST) qmm_tc::mbar_wait(&empty[s], (i / NST - 1) & 1);
        for (int pc = 0; pc < PPT; ++pc) {
          const int j = i * PPT + pc;
          const uint8_t* src = raw + (j % 2) * SM::RAWP;
          uint8_t* dst = st + (pc < HALF ? 0 : SM::K);
          const int r0 = (pc % HALF) * RAWR;
          qmm_tc::mbar_wait(&rawbar[j % 2], (j / 2) & 1);
#pragma unroll 2
          for (int u = pt; u < RAWR * D / 8; u += 128) {
            const int r = u / (D / 8), c8 = u % (D / 8);
            *reinterpret_cast<uint4*>(
                dst + qmm_tc::sw128_off(r0 + r, 16 * c8, BKV)) =
                qmm_tc::bf16x8_rn(src + (r * D + 8 * c8) * 4);
          }
          qmm_tc::bar_sync(3, 128);        // every thread has read the piece
          if (pt == 0 && j + 2 < total) issue_raw(j + 2);
        }
        qmm_tc::fence_proxy_async();
        qmm_tc::mbar_arrive(&full[s]);
      }
    } else {
      // thread 0 copies the K codes (onto full) and the raw V codes (onto
      // vraw); warp 1 stages the scales (32 arrivals on full); all four
      // warps widen V once its codes are in (128 arrivals on vfull)
      auto issue = [&](int i) {
        const int s = i % NST;
        uint8_t* st = stage(s);
        const int k0 = (lo + i) * BKV;
        if (pt == 0) {
          qmm_tc::mbar_expect(&full[s], BKV * D);
          for (int c = 0; c < D / 128; ++c)
            qmm_tc::tma_load_3d(st + c * BKV * 128, &p.mk, c * 128, k0, it.bk,
                                &full[s]);
          qmm_tc::mbar_expect(&vraw[s], BKV * D);
          qmm_tc::tma_load_3d(st + SM::K + SM::V, &p.mv, 0, k0, it.bk,
                              &vraw[s]);
        }
        if (pw == 1) {
          float* sc = reinterpret_cast<float*>(st + SM::K + SM::V + SM::VRAW);
          const size_t row = (size_t)it.bk * p.S;
          for (int j = lane; j < BKV; j += 32) {
            const bool ok = k0 + j < p.S;
            sc[j] = ok ? __bfloat162float(p.ks[row + k0 + j]) : 0.f;
            sc[BKV + j] = ok ? __bfloat162float(p.vs[row + k0 + j]) : 0.f;
          }
          qmm_tc::mbar_arrive(&full[s]);
        }
      };
      // widen tile i as soon as its codes are in, then refill the stage
      // of tile i - 1 once the consumers hand it back
      for (int i = 0; i < NST && i < n; ++i) issue(i);
      for (int i = 0; i < n; ++i) {
        const int s = i % NST;
        uint8_t* st = stage(s);
        qmm_tc::mbar_wait(&vraw[s], (i / NST) & 1);
        widen_v<D>(st + SM::K + SM::V, st + SM::K, pt);
        qmm_tc::fence_proxy_async();
        qmm_tc::mbar_arrive(&vfull[s]);
        const int j = i - 1;
        if (j >= 0 && j + NST < n) {
          qmm_tc::mbar_wait(&empty[j % NST], (j / NST) & 1);
          issue(j + NST);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    qmm_tc::setmaxnreg_inc<CONSUMER_REGS>();
    const int tw = tid % 128, wi = tw / 32, lane = tid % 32;
    const int g = lane >> 2, tq = lane & 3;
    const int ra = wg * WROWS + wi * 16 + g, rb = ra + 8;   // block rows
    const bool cap = p.softcap > 0.f, alibi = p.slopes != nullptr;
    const float qk_scale = I8 ? LOG2E : p.scale * LOG2E;   // options off
    const uint32_t qbase = qmm_tc::smem_u32(sq) + wg * WROWS * 128;
    constexpr int QBLK = BQ * 128;       // bytes of a q column block
    using SAcc = typename std::conditional<I8, int, float>::type;
    const int pm1 = it.pm1;
    const WgRange rg = wg == 0 ? it.r[0] : it.r[1];
    const int posa = it.start + t0 + ra, posb = it.start + t0 + rb;
    const float slope = alibi ? p.slopes[h] : 0.f;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;   // m: log2 domain
    float qs_a = 0.f, qs_b = 0.f;

    // S = q K^T over 64 rows x BKV keys of stage s, issued (one commit
    // group) and left in flight
    auto issue_qk = [&](SAcc (&sa)[NS], int s) {
      const uint32_t kbase = qmm_tc::smem_u32(stage(s));
      qmm_tc::fence_acc(sa);
      qmm_tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < (I8 ? D / 32 : D / 16); ++kk) {
        const int blk = kk / 4, off = (kk % 4) * 32;
        const uint64_t da = qmm_tc::desc_sw128(qbase + blk * QBLK + off);
        const uint64_t db =
            qmm_tc::desc_sw128(kbase + blk * BKV * 128 + off);
        if constexpr (I8)
          wgmma_qk8<D>(sa, da, db, kk > 0 ? 1 : 0);
        else
          wgmma_qk<D>(sa, da, db, kk > 0 ? 1 : 0);
      }
      qmm_tc::wgmma_commit();
    };
    // O += P V over stage s (V [key][dim] at its offset K), issued
    auto issue_pv = [&](const uint32_t (&pa)[BKV / 16][4], int s) {
      const uint32_t vbase = qmm_tc::smem_u32(stage(s) + SM::K);
      qmm_tc::fence_acc(o);
      qmm_tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_pv<D>(o, pa[kk],
                    qmm_tc::desc_sw128_mn(vbase + kk * 16 * 128, BKV * 128));
      qmm_tc::wgmma_commit();
    };
    // The scores of tile i (stage s) to P: the softcap and ALiBi (when
    // on) on the scaled score, the mask on the tiles that need it, then
    // the online softmax in the log2 domain; alpha rescales O before
    // P V is added. A row whose keys in this tile are all masked sums
    // garbage at max -1e30 here; its first visible key raises the max and
    // exp2(-1e30 - max) = 0 then clears it.
    auto softmax = [&](const SAcc (&sa)[NS], int i, int s,
                       uint32_t (&pa)[BKV / 16][4], float& alpha_a,
                       float& alpha_b) {
      const uint8_t* st = stage(s);
      const int k0 = (lo + i) * BKV;
      float x[NS];
      if constexpr (I8) {
        const float2* kss = reinterpret_cast<const float2*>(
                                st + SM::K + SM::V + SM::VRAW) + tq;
#pragma unroll
        for (int c = 0; c < NS / 4; ++c) {
          const float2 k2 = kss[4 * c];      // keys 8 c + 2 tq, + 1
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[4 * c + e] = qmm_tc::dot_f32(sa[4 * c + e]) *
                           ((e & 2) ? qs_b : qs_a) * ((e & 1) ? k2.y : k2.x);
        }
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j) x[j] = sa[j];
      }
      if (cap || alibi) {    // each option a whole-tile loop of its own
        if constexpr (!I8) {
#pragma unroll
          for (int j = 0; j < NS; ++j) x[j] *= p.scale;
        }
        if (cap) {
#pragma unroll
          for (int j = 0; j < NS; ++j)
            x[j] = p.softcap * tanhf(x[j] / p.softcap);
        }
        if (alibi) {
          // kpos - qpos as a float: one conversion a row and tile, plus
          // the column, exactly (both are integers below 2^24)
          const float da = (float)(k0 + 2 * tq - posa);
          const float db = (float)(k0 + 2 * tq - posb);
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            const float dist = __fadd_rn((j & 2) ? db : da,
                                         (float)(8 * (j / 4) + (j & 1)));
            x[j] = __fadd_rn(x[j], __fmul_rn(slope, dist));
          }
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) x[j] *= LOG2E;
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j) x[j] *= qk_scale;
      }
      if (!interior(p, rg, k0, k0 + BKV, pm1)) {
        // column c = 8 (j / 4) + (j & 1) of this thread is key k0 + 2 tq + c
        const int kt = k0 + 2 * tq;
        if (p.window <= 0 && pm1 <= 0) {   // causal alone: c <= last key
          const int la = min(posa, p.S - 1) - kt, lb = min(posb, p.S - 1) - kt;
#pragma unroll
          for (int j = 0; j < NS; ++j)
            if (8 * (j / 4) + (j & 1) > ((j & 2) ? lb : la)) x[j] = NEG;
        } else {
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            const int key = kt + 8 * (j / 4) + (j & 1);
            const int qpos = (j & 2) ? posb : posa;
            const bool hidden =
                (key > qpos || (p.window > 0 && key <= qpos - p.window)) &&
                key >= pm1;
            if (hidden || key >= p.S) x[j] = NEG;
          }
        }
      }
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (j & 2)
          mx_b = fmaxf(mx_b, x[j]);
        else
          mx_a = fmaxf(mx_a, x[j]);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      alpha_a = exp2f(m_a - mx_a);
      alpha_b = exp2f(m_b - mx_b);
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (j & 2) {
          x[j] = exp2f(x[j] - mx_b);
          sum_b += x[j];
        } else {
          x[j] = exp2f(x[j] - mx_a);
          sum_a += x[j];
        }
      }
      l_a = l_a * alpha_a + sum_a;   // this thread's columns; summed at the end
      l_b = l_b * alpha_b + sum_b;
      m_a = mx_a;
      m_b = mx_b;
      if constexpr (I8) {   // the v scale multiplies P before its rounding
        const float2* vss = reinterpret_cast<const float2*>(
                                st + SM::K + SM::V + SM::VRAW + BKV * 4) + tq;
#pragma unroll
        for (int c = 0; c < NS / 4; ++c) {
          const float2 v2 = vss[4 * c];
#pragma unroll
          for (int e = 0; e < 4; ++e) x[4 * c + e] *= (e & 1) ? v2.y : v2.x;
        }
      }
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
    };
    auto rescale = [&](float alpha_a, float alpha_b) {
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        o[4 * c] *= alpha_a;
        o[4 * c + 1] *= alpha_a;
        o[4 * c + 2] *= alpha_b;
        o[4 * c + 3] *= alpha_b;
      }
    };
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) qmm_tc::mbar_arrive(&empty[s]);
    };
    // tile i: its stage and the parity of its use
    auto st_of = [&](int i) { return i % NST; };
    auto ph_of = [&](int i) { return (uint32_t)((i / NST) & 1); };
    auto pass = [&](int i) {     // a tile none of this warpgroup's rows sees
      qmm_tc::mbar_wait(&full[st_of(i)], ph_of(i));
      if constexpr (I8) qmm_tc::mbar_wait(&vfull[st_of(i)], ph_of(i));
      release(st_of(i));
    };

    if constexpr (I8) {
      // quantize this warpgroup's 64 q rows: a warp takes 16, a lane D / 32
      // values of a row
      constexpr int VPL = D / 32;
      for (int rr = 0; rr < 16; ++rr) {
        const int row = wg * WROWS + wi * 16 + rr, t = t0 + row;
        float x[VPL], mx = 0.f;
        if (t < p.T) {
          const __nv_bfloat16* src =
              p.q + ((size_t)(b * p.T + t) * p.Hq + h) * D + lane * VPL;
#pragma unroll
          for (int i = 0; i < VPL; i += 2) {
            const __nv_bfloat162 v =
                *reinterpret_cast<const __nv_bfloat162*>(src + i);
            x[i] = __low2float(v);
            x[i + 1] = __high2float(v);
          }
        } else {
#pragma unroll
          for (int i = 0; i < VPL; ++i) x[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < VPL; ++i) mx = fmaxf(mx, fabsf(x[i]));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float qa = mx + 1e-9f;
        const float rq = 127.f / qa;
        uint32_t cw[VPL / 4];
#pragma unroll
        for (int c = 0; c < VPL / 4; ++c) {
          cw[c] = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cw[c] |= (uint32_t)(uint8_t)(int8_t)(int)rintf(x[4 * c + i] * rq)
                     << (8 * i);
        }
        uint8_t* dst = sq + qmm_tc::sw128_off(row, lane * VPL, BQ);
        if constexpr (VPL == 4)
          *reinterpret_cast<uint32_t*>(dst) = cw[0];
        else
          *reinterpret_cast<uint2*>(dst) = make_uint2(cw[0], cw[1]);
        if (lane == 0) qsc[row] = qa * p.scale;
      }
      qmm_tc::fence_proxy_async();
      qmm_tc::bar_sync(1 + wg, 128);
      qs_a = qsc[ra];
      qs_b = qsc[rb];
    } else {
      qmm_tc::mbar_wait(&qbar, 0);
    }

    // this warpgroup's tiles [first, last) of the block's n: at D = 128
    // QK^T of tile i is issued with P V of tile i - 1, and tile i's
    // softmax runs while that product is in flight
    int first = n, last = n;
    if (rg.lo < rg.hi) {
      first = rg.lo / BKV - lo;
      last = (rg.hi + BKV - 1) / BKV - lo;
    }
    for (int i = 0; i < first; ++i) pass(i);
    if (first < last && overlap<D>()) {
      SAcc sa[NS];
      uint32_t pa[BKV / 16][4], pn[BKV / 16][4];
      float al_a, al_b;
      qmm_tc::mbar_wait(&full[st_of(first)], ph_of(first));
      issue_qk(sa, st_of(first));
      qmm_tc::wgmma_wait<0>();
      qmm_tc::fence_acc(sa);
      softmax(sa, first, st_of(first), pa, al_a, al_b);
      for (int i = first + 1; i < last; ++i) {
        const int s = st_of(i), sp = st_of(i - 1);
        qmm_tc::mbar_wait(&full[s], ph_of(i));
        issue_qk(sa, s);
        rescale(al_a, al_b);
        if constexpr (I8) qmm_tc::mbar_wait(&vfull[sp], ph_of(i - 1));
        issue_pv(pa, sp);
        qmm_tc::wgmma_wait<1>();
        qmm_tc::fence_acc(sa);
        softmax(sa, i, s, pn, al_a, al_b);
        qmm_tc::wgmma_wait<0>();
        qmm_tc::fence_acc(o);
        keep_live(pa);           // P of tile i - 1 was read until here
        release(sp);
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) pa[kk][e] = pn[kk][e];
      }
      const int sl = st_of(last - 1);
      rescale(al_a, al_b);
      if constexpr (I8) qmm_tc::mbar_wait(&vfull[sl], ph_of(last - 1));
      issue_pv(pa, sl);
      qmm_tc::wgmma_wait<0>();
      qmm_tc::fence_acc(o);
      release(sl);
    } else if (first < last) {
      for (int i = first; i < last; ++i) {
        const int s = st_of(i);
        SAcc sa[NS];
        uint32_t pa[BKV / 16][4];
        float al_a, al_b;
        qmm_tc::mbar_wait(&full[s], ph_of(i));
        issue_qk(sa, s);
        qmm_tc::wgmma_wait<0>();
        qmm_tc::fence_acc(sa);
        softmax(sa, i, s, pa, al_a, al_b);
        rescale(al_a, al_b);
        if constexpr (I8) qmm_tc::mbar_wait(&vfull[s], ph_of(i));
        issue_pv(pa, s);
        qmm_tc::wgmma_wait<0>();
        qmm_tc::fence_acc(o);
        release(s);
      }
    }
    for (int i = last; i < n; ++i) pass(i);

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inva = 1.f / fmaxf(l_a, 1e-30f);
    const float invb = 1.f / fmaxf(l_b, 1e-30f);
    const int ta = t0 + ra, tb = t0 + rb;
    float* oa = p.out + ((size_t)(b * p.T + ta) * p.Hq + h) * D + 2 * tq;
    float* ob = p.out + ((size_t)(b * p.T + tb) * p.Hq + h) * D + 2 * tq;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      if (ta < p.T)
        *reinterpret_cast<float2*>(oa + 8 * c) =
            make_float2(o[4 * c] * inva, o[4 * c + 1] * inva);
      if (tb < p.T)
        *reinterpret_cast<float2*>(ob + 8 * c) =
            make_float2(o[4 * c + 2] * invb, o[4 * c + 3] * invb);
    }
  }
}

template <int D, int KV>
int launch_d(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* starts, const void* slopes,
             const void* prefix_len, void* out, int B, int T, int Hq, int Hkv,
             int S, float scale, float softcap, int window, void* stream) {
  using SM = Smem<D, KV>;
  constexpr int BKV = SM::BKV;
  // above 48 KB a block's dynamic shared memory must be allowed first;
  // once per kernel, on its first launch (never inside a graph capture:
  // every caller launches eagerly before it captures)
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<D, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SM::BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  Params p{};
  p.q = reinterpret_cast<const __nv_bfloat16*>(q);
  p.ks = reinterpret_cast<const __nv_bfloat16*>(ks);
  p.vs = reinterpret_cast<const __nv_bfloat16*>(vs);
  p.starts = reinterpret_cast<const int*>(starts);
  p.slopes = reinterpret_cast<const float*>(slopes);
  p.prefix_len = reinterpret_cast<const int*>(prefix_len);
  p.out = reinterpret_cast<float*>(out);
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.S = S;
  p.n_tb = (T + BQ - 1) / BQ;
  p.BH = B * Hq;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  using qmm_tc::make_map_3d;
  bool ok;
  if constexpr (KV == KV_I8) {
    ok = make_map_3d(&p.mk, k, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, S,
                     (long long)B * Hkv, 128, BKV, true) &&
         make_map_3d(&p.mv, v, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, S,
                     (long long)B * Hkv, D, BKV, false);
  } else {
    const long long qd[3] = {D, Hq, (long long)B * T};
    const long long qs[2] = {(long long)D * 2, (long long)Hq * D * 2};
    const int qb[3] = {64, 1, BQ};
    ok = qmm_tc::make_map_nd(&p.mq, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                             qd, qs, qb, true);
    if constexpr (KV == KV_F32)        // raw pieces of whole rows
      ok = ok &&
           make_map_3d(&p.mk, k, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, D, S,
                       (long long)B * Hkv, D, SM::RAWR, false) &&
           make_map_3d(&p.mv, v, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, D, S,
                       (long long)B * Hkv, D, SM::RAWR, false);
    else
      ok = ok &&
           make_map_3d(&p.mk, k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D, S,
                       (long long)B * Hkv, 64, BKV, true) &&
           make_map_3d(&p.mv, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D, S,
                       (long long)B * Hkv, 64, BKV, true);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  flash_prefill_kernel<D, KV><<<B * Hq * p.n_tb, THREADS, SM::BYTES,
                                reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

template <int KV>
int launch(int D, const void* q, const void* k, const void* v,
           const void* ks, const void* vs, const void* starts,
           const void* slopes, const void* prefix_len, void* out, int B,
           int T, int Hq, int Hkv, int S, float scale, float softcap,
           int window, void* stream) {
  if (D == 128)
    return launch_d<128, KV>(q, k, v, ks, vs, starts, slopes, prefix_len,
                             out, B, T, Hq, Hkv, S, scale, softcap, window,
                             stream);
  if (D == 256)
    return launch_d<256, KV>(q, k, v, ks, vs, starts, slopes, prefix_len,
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
  return launch<KV_BF16>(D, q, k, v, nullptr, nullptr, starts, slopes,
                         prefix_len, out, B, T, Hq, Hkv, S, scale, softcap,
                         window, stream);
}

// an f32 cache [B, Hkv, S, D], each element rounded to bf16 as it is read;
// otherwise as flash_prefill
extern "C" int flash_prefill_f32(const void* q, const void* k, const void* v,
                                 const void* starts, const void* slopes,
                                 const void* prefix_len, void* out, int B,
                                 int T, int Hq, int Hkv, int S, int D,
                                 float scale, float softcap, int window,
                                 void* stream) {
  return launch<KV_F32>(D, q, k, v, nullptr, nullptr, starts, slopes,
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
  return launch<KV_I8>(D, q, k, v, k_scale, v_scale, starts, slopes,
                       prefix_len, out, B, T, Hq, Hkv, S, scale, softcap,
                       window, stream);
}
