// K1: native-code weight GEMV / skinny GEMM for Hopper (M <= 16).
//
// Replaces neural_tpu/ops/qmatmul.py:_qmm4_kernel (launched by
// _qmatmul4_pallas and qmatmul_fused): out[M, N] = x[M, K] @ (codes * s),
// each code's exact value times a bf16 x value with f32 accumulation, the
// group scale applied to each 32-row chunk's partial sum. Three code
// layouts, each with a symmetric entry point and an asymmetric one (name +
// "_asym"):
//   qmm4_npack       native-pack nibbles (int3/int4): uint8 [K/2, N], byte
//                    row r holds code 2r in the low nibble and 2r+1 in the
//                    high nibble, centered two's complement;
//   qmm2_npack       native-pack int2: uint8 [K/4, N], four centered 2-bit
//                    fields per byte, LSB first (code 4r in bits 0-1);
//   qmm8_native      int8 code planes [K, N] (5-8 bit at rest, centered).
// Scales are bf16 [K/group, N]. Asymmetric weights (zeros non-null) carry
// bf16 zero-points shifted like the codes; as in the TPU kernel they never
// touch the weight tile but come in as a rank-G correction
// out -= xs @ (z * s), with xs [M, K/group] the f32 per-group sums of x,
// computed outside the kernel (as _qmatmul4_pallas computes them in XLA);
// the warp that holds a group's first chunk subtracts that group's term.
//
// What bounds it on the H100: the bytes. Every weight byte is used once
// for 2 (M = 1) to 32 (M = 16) multiply-adds, so the least time is (codes
// + scales) over the HBM rate. The design:
// - One launch a product. The grid is (K splits, 128-column tiles), from
//   ops/qmatmul.py k1_schedule: about one block an SM (at most two fit),
//   all resident at once, so each block is one (column tile, K split) item
//   of a one-wave persistent schedule; no split where the column tiles
//   alone reach the SM count (the lm_head). A block
//   writes its split's f32 partial [M, 128]; the last block of a column
//   tile to finish (an atomic ticket that it puts back to 0) adds the
//   splits in split order and writes the output (with the res option), so
//   reruns are bit-identical.
// - Bytes in flight. One producer warp streams the block's slice of the
//   byte plane by TMA, 2-D boxes of 128 columns x 128 K (64 byte rows of
//   nibbles, 32 of int2, 128 of int8 codes) with the 128-byte swizzle,
//   through a ring of stages (32 KB) on full/empty mbarriers.
// - Tensor cores at every M: mma.sync m16n8k16 bf16 with the weight as the
//   A operand (16 output columns a fragment, eight fragments a warp over
//   the tile's 128 columns) and x as the B operand (n = 8 rows of x; two
//   n-tiles at M > 8). A byte row holds the codes of consecutive k of one
//   column, which are exactly the k pairs a thread holds in an A register;
//   the k order inside a 16-step is permuted (the same way for A and B) so
//   that each thread's 16-byte reads of the swizzled stage hit distinct
//   banks. Each of the four consumer warps takes one 32-row chunk of each
//   stage into a fresh f32 fragment (two k16 steps), then adds it times
//   its group scale in f32 (the TPU kernel's per-chunk scaling).
// - Codes to numbers without I2F: each code's bf16 is built exactly from
//   its bits, 128 + (field ^ bias) in the mantissa of 128.0 less 128 +
//   bias (one byte_perm, one lop3, one bf16x2 subtraction a k pair); int8
//   codes through the f32 mantissa trick (qmm_tc::codes_f32), exact in
//   bf16 since |code| <= 128.
// - x: each block stages its K slice of x (bf16) in shared memory once, so
//   that the fused prologue runs once per element and block.
//
// The fused entry points (name + "_fused", symmetric only) are the TPU
// kernel's ``fuse`` options (qmatmul_fused), which fold a decode step's
// elementwise neighbours into the weight stream:
//   rms  (norm_w non-null) x is the raw residual stream; each row becomes
//        bf16(x * rsqrt(mean(x^2) + eps) * (w + offset)), f32 inside;
//   glu  (u non-null)      x is the gate input g, u the up input; the
//        product's input is bf16(act(g) * u), act in f32 (expf, erff,
//        tanhf: the precise library functions, not the intrinsics);
//   res  (res non-null)    the output takes a bf16 [M, N] residual as the
//        unfused graph adds it: bf16(bf16(sum) + res).
// rms needs the whole row's mean square, and a block sees its K slice:
// each block reads its rows in full (from L2) while its first stages are
// in flight and reduces them in a fixed order, so every block of a launch
// computes the same scale, in the order the earlier body used.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "qmm_tc.cuh"
#include "rms_row.cuh"

namespace {

constexpr int TN = 128;              // output columns a block: a box row
constexpr int STAGE_K = 128;         // K values a stage: 4 chunks of 32
constexpr int RING_BYTES = 32768;    // the stages of the ring, together
constexpr int CONSUMERS = 4;         // warps that compute, a chunk a stage
constexpr int THREADS = 32 * CONSUMERS + 32;   // and one producer warp
constexpr int XPAD = 8;              // bf16 padding of a staged x row
constexpr int BLOCKS_PER_SM = 2;     // resident at once: k1_schedule's wave

enum Code { C_NIB = 0, C_INT2 = 1, C_INT8 = 2 };

// the 16 bytes (columns 16 g .. 16 g + 15) of byte row r of a stage that
// TMA wrote with the 128-byte swizzle
__device__ __forceinline__ uint4 row16(const uint8_t* st, int r, int g) {
  return *reinterpret_cast<const uint4*>(st + r * 128 +
                                         ((g ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// bf16 pair a - b, exact for the small integers here
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// two fields of byte q of w as an exact bf16 pair: the low field from lo
// (bits 0..), the high one from hi, each `mask` wide and centered by
// `bias` (field ^ bias in the mantissa of 128.0, less 128 + bias)
template <uint32_t MASK, uint32_t BIAS>
__device__ __forceinline__ uint32_t fields_bf16(uint32_t lo, uint32_t hi,
                                                int q) {
  const uint32_t p = __byte_perm(lo, hi, q | (q << 4) | ((q + 4) << 8) |
                                             ((q + 4) << 12));
  const uint32_t base = 0x43004300u | BIAS | (BIAS << 16);
  return bf16x2_sub((p & (MASK | (MASK << 16))) ^ base, base);
}

// A layout: its byte rows a stage (ROWS); the NW 16-byte words a thread
// reads for a k16 step of its chunk (load), the A fragment of fragment j
// from them (frag: a[0], a[1] the k slot pair tq of columns 16 g + 2 j and
// + 1, a[2], a[3] the pair tq + 4), and where the B fragment's two k pairs
// sit in the staged x row (xoff).
template <int CODE>
struct Codes;

// nibbles: a k16 step is 8 byte rows; slot pair tq is byte row 2 tq (k 4 tq,
// 4 tq + 1), slot pair tq + 4 byte row 2 tq + 1 (k 4 tq + 2, + 3)
template <>
struct Codes<C_NIB> {
  static constexpr int ROWS = STAGE_K / 2, NW = 2;
  __device__ static void load(const uint8_t* st, int chunk, int h, int g,
                              int tq, uint4 (&w)[NW]) {
    const int r = chunk * 16 + h * 8 + 2 * tq;
    w[0] = row16(st, r, g);
    w[1] = row16(st, r + 1, g);
  }
  __device__ static void frag(const uint4 (&w)[NW], int j, uint32_t (&a)[4]) {
    const uint32_t w0 = word(w[0], j / 2), w1 = word(w[1], j / 2);
    const int q = 2 * (j % 2);
    a[0] = fields_bf16<0xF, 8>(w0, w0 >> 4, q);
    a[1] = fields_bf16<0xF, 8>(w0, w0 >> 4, q + 1);
    a[2] = fields_bf16<0xF, 8>(w1, w1 >> 4, q);
    a[3] = fields_bf16<0xF, 8>(w1, w1 >> 4, q + 1);
  }
  __device__ static int xoff(int h, int tq) { return 16 * h + 4 * tq; }
};

// int2: a chunk is 8 byte rows; step h takes byte row 2 tq + h, fields 0-1
// as slot pair tq (k 8 tq + 4 h, + 1), fields 2-3 as tq + 4 (+ 2, + 3)
template <>
struct Codes<C_INT2> {
  static constexpr int ROWS = STAGE_K / 4, NW = 1;
  __device__ static void load(const uint8_t* st, int chunk, int h, int g,
                              int tq, uint4 (&w)[NW]) {
    w[0] = row16(st, chunk * 8 + 2 * tq + h, g);
  }
  __device__ static void frag(const uint4 (&w)[NW], int j, uint32_t (&a)[4]) {
    const uint32_t w0 = word(w[0], j / 2);
    const int q = 2 * (j % 2);
    a[0] = fields_bf16<0x3, 2>(w0, w0 >> 2, q);
    a[1] = fields_bf16<0x3, 2>(w0, w0 >> 2, q + 1);
    a[2] = fields_bf16<0x3, 2>(w0 >> 4, w0 >> 6, q);
    a[3] = fields_bf16<0x3, 2>(w0 >> 4, w0 >> 6, q + 1);
  }
  __device__ static int xoff(int h, int tq) { return 8 * tq + 4 * h; }
};

// int8 codes: a k16 step is 16 byte rows in natural k order; slot pair tq
// is rows 2 tq, 2 tq + 1, slot pair tq + 4 rows 8 + 2 tq, 9 + 2 tq
template <>
struct Codes<C_INT8> {
  static constexpr int ROWS = STAGE_K, NW = 4;
  __device__ static void load(const uint8_t* st, int chunk, int h, int g,
                              int tq, uint4 (&w)[NW]) {
    const int r = chunk * 32 + h * 16 + 2 * tq;
    w[0] = row16(st, r, g);
    w[1] = row16(st, r + 1, g);
    w[2] = row16(st, r + 8, g);
    w[3] = row16(st, r + 9, g);
  }
  __device__ static void frag(const uint4 (&w)[NW], int j, uint32_t (&a)[4]) {
    const int q = 2 * (j % 2);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      // codes (k even, k odd) of column 2 j, then of 2 j + 1
      float f[4];
      qmm_tc::codes_f32(__byte_perm(word(w[2 * s], j / 2),
                                    word(w[2 * s + 1], j / 2),
                                    q | ((q + 4) << 4) | ((q + 1) << 8) |
                                        ((q + 5) << 12)),
                        f);
      a[2 * s] = qmm_tc::bf16_pair_exact(f[0], f[1]);
      a[2 * s + 1] = qmm_tc::bf16_pair_exact(f[2], f[3]);
    }
  }
  // slot pair tq at 16 h + 2 tq, slot pair tq + 4 eight further
  __device__ static int xoff(int h, int tq) { return 16 * h + 2 * tq; }
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float bf16_bits(uint32_t h) {
  return __uint_as_float(h << 16);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// the fused prologue: PRO is a set of these bits
enum Pro { P_RMS = 1, P_GLU = 2 };
// the activations of the glu prologue, in f32, as torch computes them
enum Act { A_SILU = 0, A_GELU = 1, A_GELU_TANH = 2, A_RELU = 3 };

__device__ __forceinline__ float act_f32(float g, int act) {
  switch (act) {
    case A_SILU:
      return g / (1.f + expf(-g));
    case A_GELU:
      return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
    case A_GELU_TANH: {
      const float inner = 0.79788456080286536f * (g + 0.044715f * g * g * g);
      return 0.5f * g * (1.f + tanhf(inner));
    }
    default:
      return fmaxf(g, 0.f);
  }
}

// eight elements at o of the product's input before the norm: x, or
// bf16(act(g) * u), from one 16-byte load of each input
template <int PRO>
__device__ __forceinline__ void pro_in8(const __nv_bfloat16* __restrict__ x,
                                        const __nv_bfloat16* __restrict__ u,
                                        size_t o, int act, float v[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(x + o));
  const uint32_t av[4] = {a.x, a.y, a.z, a.w};
  uint32_t bv[4] = {0, 0, 0, 0};
  if constexpr ((PRO & P_GLU) != 0) {
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(u + o));
    bv[0] = b.x; bv[1] = b.y; bv[2] = b.z; bv[3] = b.w;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = bf16_bits((av[i / 2] >> (16 * (i % 2))) & 0xFFFFu);
    if constexpr ((PRO & P_GLU) != 0) {
      const float uv = bf16_bits((bv[i / 2] >> (16 * (i % 2))) & 0xFFFFu);
      v[i] = round_bf16(__fmul_rn(act_f32(v[i], act), uv));
    }
  }
}

struct Fuse {
  const __nv_bfloat16* u;   // glu: the up input [M, K] (x is the gate)
  const void* norm_w;       // rms: the norm weight [K], bf16 or f32
  int norm_f32;
  float eps, offset;
  int act;
  const __nv_bfloat16* res; // res: [M, N] bf16
};

struct Args {
  CUtensorMap map;                 // the byte plane [K / R, N]
  const __nv_bfloat16* x;          // [M, K]
  const __nv_bfloat16* scales;     // [K / group, N]
  const __nv_bfloat16* zeros;      // asym: [K / group, N]
  const float* xs;                 // asym: [M, K / group]
  float* partial;                  // [splits, M, N] when splits > 1
  int* tickets;                    // [column tiles], zero between launches
  void* out;                       // [M, N], bf16 or f32
  int M, K, N, group, out_f32, splits, spk;   // spk: stages a split
  Fuse fuse;
};

// The consumers' prologue: rows 0 .. M - 1 of the product's input, K
// values k0 .. k0 + KI - 1 (zeros past K), into xsh[m * XLD + k - k0] as
// bf16. With rms, each row's sum of squares over the whole K first, in a
// fixed order (each thread a strided share, then the warps in order:
// rms_row.cuh), the order the row-norm kernel of the unfused graph takes.
// Every load is 16 bytes.
template <int PRO>
__device__ void stage_x(const Args& p, __nv_bfloat16* xsh, int XLD, int k0,
                        int KI) {
  static_assert(32 * CONSUMERS == rms_row::THREADS,
                "the rms sums run on the consumer warps alone");
  constexpr int NT = 32 * CONSUMERS;
  __shared__ float warp_ss[CONSUMERS][16];
  __shared__ float rrow[16];
  const Fuse& f = p.fuse;
  const int tid = threadIdx.x;
  if constexpr ((PRO & P_RMS) != 0) {
    // each row's terms in the same order whatever M: the rows sit inside
    // the strided loop, so that a thread's loads of every row issue
    // together
    float ss[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) ss[m] = 0.f;
#pragma unroll 2
    for (int c = tid; c < p.K / 8; c += NT) {
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        if (m >= p.M) break;
        float v[8];
        pro_in8<PRO>(p.x, f.u, (size_t)m * p.K + (size_t)c * 8, f.act, v);
        ss[m] = rms_row::add_squares8(ss[m], v);
      }
    }
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      if (m >= p.M) break;
      const float v = rms_row::warp_sum(ss[m]);
      if (tid % 32 == 0) warp_ss[tid / 32][m] = v;
    }
    qmm_tc::bar_sync(1, NT);
    if (tid < p.M)
      rrow[tid] = rms_row::scale(rms_row::total(&warp_ss[0][tid], 16), p.K,
                                 f.eps);
    qmm_tc::bar_sync(1, NT);
  }
#pragma unroll 4
  for (int i = tid; i < p.M * (KI / 8); i += NT) {
    const int m = i / (KI / 8), kk = (i % (KI / 8)) * 8, k = k0 + kk;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (k < p.K) {
      pro_in8<PRO>(p.x, f.u, (size_t)m * p.K + k, f.act, v);
      if constexpr ((PRO & P_RMS) != 0) {
        float w[8];
        if (f.norm_f32) {
          const float4* wp = reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(f.norm_w) + k);
          const float4 w0 = __ldg(wp), w1 = __ldg(wp + 1);
          w[0] = w0.x; w[1] = w0.y; w[2] = w0.z; w[3] = w0.w;
          w[4] = w1.x; w[5] = w1.y; w[6] = w1.z; w[7] = w1.w;
        } else {
          const uint4 wb = __ldg(reinterpret_cast<const uint4*>(
              reinterpret_cast<const __nv_bfloat16*>(f.norm_w) + k));
          const uint32_t wv[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            w[j] = bf16_bits((wv[j / 2] >> (16 * (j % 2))) & 0xFFFFu);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = round_bf16(rms_row::apply(v[j], rrow[m], w[j], f.offset));
      }
    }
    uint32_t packed[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      packed[j] = qmm_tc::bf16_pair_exact(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(xsh + m * XLD + kk) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// The consumers' other prologue: the bf16 scale rows (and zero-point rows)
// of the groups that K values k0 .. k0 + KI - 1 touch, columns n0 .. n0 +
// 127 (zeros past N), into ssh[(gi - g0) * TN + col] (zsh likewise), and
// with zero-points x's group sums into xss[m * rows + gi - g0], all loaded
// at once: a read in the loop would add its latency to every stage.
template <bool ASYM>
__device__ void stage_scales(const Args& p, __nv_bfloat16* ssh,
                             __nv_bfloat16* zsh, float* xss, int g0,
                             int rows, int n0) {
  constexpr int NT = 32 * CONSUMERS;
  if constexpr (ASYM) {
    const int G = p.K / p.group;
    for (int i = threadIdx.x; i < p.M * rows; i += NT)
      xss[i] = p.xs[(size_t)(i / rows) * G + g0 + i % rows];
  }
#pragma unroll 2
  for (int i = threadIdx.x; i < rows * (TN / 8); i += NT) {
    const int r = i / (TN / 8), c = (i % (TN / 8)) * 8;
    const size_t at = (size_t)(g0 + r) * p.N + n0 + c;
    uint4 sv = make_uint4(0u, 0u, 0u, 0u), zv = sv;
    if (n0 + c < p.N) {
      sv = __ldg(reinterpret_cast<const uint4*>(p.scales + at));
      if constexpr (ASYM) zv = __ldg(reinterpret_cast<const uint4*>(p.zeros + at));
    }
    *reinterpret_cast<uint4*>(ssh + r * TN + c) = sv;
    if constexpr (ASYM) *reinterpret_cast<uint4*>(zsh + r * TN + c) = zv;
  }
}

// one output element, as the unfused graph rounds it: with res, a bf16
// sum of two bf16 values (or an f32 one for f32 outputs)
__device__ __forceinline__ void store_out(const Args& p, int m, int n,
                                          float s) {
  const size_t i = (size_t)m * p.N + n;
  const __nv_bfloat16* res = p.fuse.res;
  if (p.out_f32) {
    if (res != nullptr) s = __fadd_rn(s, __bfloat162float(res[i]));
    reinterpret_cast<float*>(p.out)[i] = s;
  } else {
    __nv_bfloat16 o = __float2bfloat16(s);
    if (res != nullptr)
      o = __float2bfloat16(
          __fadd_rn(__bfloat162float(o), __bfloat162float(res[i])));
    reinterpret_cast<__nv_bfloat16*>(p.out)[i] = o;
  }
}

// the splits of column n added in split order, the loads of every row of
// a few splits in flight together
__device__ __forceinline__ void merge_tile(const Args& p, int n) {
  float s[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) s[m] = 0.f;
#pragma unroll 8
  for (int sp = 0; sp < p.splits; ++sp)
#pragma unroll
    for (int m = 0; m < 16; ++m)
      if (m < p.M) s[m] += __ldcg(p.partial + ((size_t)sp * p.M + m) * p.N + n);
#pragma unroll
  for (int m = 0; m < 16; ++m)
    if (m < p.M) store_out(p, m, n, s[m]);
}

template <int CODE>
__host__ __device__ constexpr int stage_bytes() {
  return Codes<CODE>::ROWS * TN;
}

template <int CODE>
__host__ __device__ constexpr int ring_stages() {
  return RING_BYTES / stage_bytes<CODE>();
}

// MT: n-tiles of 8 rows of x (1 at M <= 8, 2 above)
template <int CODE, int MT, bool ASYM, int PRO>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
qmm_native(const __grid_constant__ Args p) {
  using C = Codes<CODE>;
  constexpr int SB = stage_bytes<CODE>(), NST = ring_stages<CODE>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[NST], empty[NST];
  __shared__ int last_block;
  uint8_t* ring = smem_raw + ((1024 - (qmm_tc::smem_u32(smem_raw) & 1023)) &
                              1023);
  const int split = blockIdx.x, n0 = blockIdx.y * TN;
  const int kst = (p.K + STAGE_K - 1) / STAGE_K;
  const int s0 = split * p.spk;
  const int ns = min(p.spk, kst - s0);        // this item's stages
  const int k0 = s0 * STAGE_K, KI = p.spk * STAGE_K, XLD = KI + XPAD;
  auto* xsh = reinterpret_cast<__nv_bfloat16*>(ring + NST * SB);
  float* red = reinterpret_cast<float*>(xsh + p.M * XLD);
  // the item's scale rows (and zero-point rows), TN bf16 each
  const int g0 = k0 / p.group;
  const int g_rows = (min(p.K, k0 + KI) - 1) / p.group - g0 + 1;
  auto* ssh = reinterpret_cast<__nv_bfloat16*>(red + CONSUMERS * p.M * TN);
  auto* zsh = ssh + g_rows * TN;
  float* xss = reinterpret_cast<float*>(zsh + g_rows * TN);   // asym
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      qmm_tc::mbar_init(&full[s], 1);
      qmm_tc::mbar_init(&empty[s], CONSUMERS);
    }
    qmm_tc::mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMERS) {
    // the producer: the item's stages, NST in flight
    if (lane == 0) {
      for (int i = 0; i < ns; ++i) {
        const int s = i % NST;
        if (i >= NST) qmm_tc::mbar_wait(&empty[s], (i / NST - 1) & 1);
        qmm_tc::mbar_expect(&full[s], SB);
        qmm_tc::tma_load(ring + s * SB, &p.map, n0, (s0 + i) * C::ROWS,
                         &full[s]);
      }
    }
    return;
  }

  stage_scales<ASYM>(p, ssh, zsh, xss, g0, g_rows, n0);
  stage_x<PRO>(p, xsh, XLD, k0, KI);
  qmm_tc::bar_sync(1, 32 * CONSUMERS);

  const int g = lane >> 2, tq = lane & 3;
  const bool col_ok = n0 + 16 * g < p.N;
  float acc[8][MT][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][t][e] = 0.f;
  for (int i = 0; i < ns; ++i) {
    const int s = i % NST;
    qmm_tc::mbar_wait(&full[s], (i / NST) & 1);
    const int kc = k0 + i * STAGE_K + 32 * warp;   // this warp's chunk
    if (kc < p.K) {
      const uint8_t* st = ring + s * SB;
      // the chunk's two k16 steps: the weight words and x's B fragments
      uint4 wd[2][C::NW];
      uint32_t b[2][MT][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        C::load(st, warp, h, g, tq, wd[h]);
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          const int m = 8 * t + g;
          b[h][t][0] = b[h][t][1] = 0u;
          if (m < p.M) {
            const __nv_bfloat16* xr =
                xsh + m * XLD + (kc - k0) + C::xoff(h, tq);
            b[h][t][0] = *reinterpret_cast<const uint32_t*>(xr);
            b[h][t][1] = *reinterpret_cast<const uint32_t*>(
                xr + (CODE == C_INT8 ? 8 : 2));
          }
        }
      }
      // the chunk lies inside one group: its scale, and with zero-points
      // the group's rank-1 term at its first chunk
      const int gi = kc / p.group;
      uint32_t sv[8];                // bf16 scales of columns 16 g .. + 15
      {
        const uint4* sp = reinterpret_cast<const uint4*>(
            ssh + (gi - g0) * TN + 16 * g);
        const uint4 s01 = sp[0], s23 = sp[1];
        sv[0] = s01.x; sv[1] = s01.y; sv[2] = s01.z; sv[3] = s01.w;
        sv[4] = s23.x; sv[5] = s23.y; sv[6] = s23.z; sv[7] = s23.w;
      }
      // fragment j: columns 16 g + 2 j (c[0], c[1]) and + 1 (c[2], c[3]),
      // its chunk sum in a fresh fragment, then times the group scale
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t a[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) Codes<CODE>::frag(wd[h], j, a[h]);
        const float sa = bf16_bits(sv[j] & 0xFFFFu), sb = bf16_bits(sv[j] >> 16);
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(c, a[0], b[0][t]);
          mma_bf16(c, a[1], b[1][t]);
          acc[j][t][0] = fmaf(c[0], sa, acc[j][t][0]);
          acc[j][t][1] = fmaf(c[1], sa, acc[j][t][1]);
          acc[j][t][2] = fmaf(c[2], sb, acc[j][t][2]);
          acc[j][t][3] = fmaf(c[3], sb, acc[j][t][3]);
        }
      }
      if (ASYM && kc % p.group == 0 && col_ok) {
        const uint4* zp = reinterpret_cast<const uint4*>(
            zsh + (gi - g0) * TN + 16 * g);
        const uint4 z01 = zp[0], z23 = zp[1];
        const uint32_t zv[8] = {z01.x, z01.y, z01.z, z01.w,
                                z23.x, z23.y, z23.z, z23.w};
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          // rows 8 t + 2 tq (c[0], c[2]) and + 1 (c[1], c[3])
          const int m = 8 * t + 2 * tq;
          const float x0 = m < p.M ? xss[m * g_rows + gi - g0] : 0.f;
          const float x1 = m + 1 < p.M ? xss[(m + 1) * g_rows + gi - g0] : 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float za = __fmul_rn(bf16_bits(zv[j] & 0xFFFFu),
                                       bf16_bits(sv[j] & 0xFFFFu));
            const float zb = __fmul_rn(bf16_bits(zv[j] >> 16),
                                       bf16_bits(sv[j] >> 16));
            acc[j][t][0] -= x0 * za;
            acc[j][t][1] -= x1 * za;
            acc[j][t][2] -= x0 * zb;
            acc[j][t][3] -= x1 * zb;
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) qmm_tc::mbar_arrive(&empty[s]);
  }

  // the warps' chunks added in warp order: thread tid owns column tid
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 8 * t + 2 * tq + (e & 1);
        if (m < p.M)
          red[(warp * p.M + m) * TN + 16 * g + 2 * j + (e >> 1)] =
              acc[j][t][e];
      }
  qmm_tc::bar_sync(1, 32 * CONSUMERS);
  const int n = n0 + tid;
  if (p.splits == 1) {
    if (n < p.N)
      for (int m = 0; m < p.M; ++m) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < CONSUMERS; ++w) v += red[(w * p.M + m) * TN + tid];
        store_out(p, m, n, v);
      }
    return;
  }
  if (n < p.N)
    for (int m = 0; m < p.M; ++m) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < CONSUMERS; ++w) v += red[(w * p.M + m) * TN + tid];
      p.partial[((size_t)split * p.M + m) * p.N + n] = v;
    }
  // the last of the column tile's splits to finish merges them all: the
  // block's partial stores are released, and the others' acquired, by one
  // acq_rel ticket after the block's barrier (the barrier orders every
  // thread's stores before thread 0's release, and its acquire before the
  // merge's loads)
  qmm_tc::bar_sync(1, 32 * CONSUMERS);
  if (tid == 0) {
    int* ticket = p.tickets + blockIdx.y;
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(ticket)
                 : "memory");
    last_block = old == p.splits - 1;
    if (last_block) *ticket = 0;     // clean for the next launch or replay
  }
  qmm_tc::bar_sync(1, 32 * CONSUMERS);
  if (!last_block) return;
  if (n < p.N) merge_tile(p, n);
}

// dynamic shared memory of a launch: the ring (1024-aligned), the staged x,
// the warps' sums and the scale (and zero-point) rows (k1_schedule keeps
// it to two blocks an SM; the attribute allows more)
constexpr int MAX_SMEM = 192 * 1024;
size_t smem_bytes(int M, int spk, int group, bool asym) {
  const int g_rows = spk * STAGE_K / group + 2;     // the most a split touches
  return 1024 + RING_BYTES + (size_t)M * (spk * STAGE_K + XPAD) * 2 +
         (size_t)CONSUMERS * M * TN * 4 +
         (asym ? (size_t)g_rows * (TN * 4 + M * 4) : (size_t)g_rows * TN * 2);
}

template <int CODE, int MT, bool ASYM, int PRO>
int launch_k(const Args& p, int tiles, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_native<CODE, MT, ASYM, PRO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  qmm_native<CODE, MT, ASYM, PRO>
      <<<dim3(p.splits, tiles), THREADS,
         smem_bytes(p.M, p.spk, p.group, ASYM), st>>>(p);
  return (int)cudaGetLastError();
}

template <int CODE, int MT, bool ASYM>
int launch_pro(const Args& p, int pro, int tiles, cudaStream_t st) {
  if constexpr (ASYM) {
    return launch_k<CODE, MT, true, 0>(p, tiles, st);
  } else {
    switch (pro) {
      case P_RMS: return launch_k<CODE, MT, false, P_RMS>(p, tiles, st);
      case P_GLU: return launch_k<CODE, MT, false, P_GLU>(p, tiles, st);
      case P_RMS | P_GLU:
        return launch_k<CODE, MT, false, P_RMS | P_GLU>(p, tiles, st);
      default: return launch_k<CODE, MT, false, 0>(p, tiles, st);
    }
  }
}

// splits from ops/qmatmul.py k1_schedule: the stages a split are ceil(K /
// STAGE_K / splits), and no split is empty
template <int CODE, bool ASYM>
int launch(const void* x, const void* planes, const void* scales,
           const void* zeros, const void* xs, void* partial, void* tickets,
           void* out, int M, int K, int N, int group, int out_f32, int splits,
           void* stream, const Fuse& f) {
  const int kst = (K + STAGE_K - 1) / STAGE_K;
  if (M < 1 || M > 16 || K % 32 || group % 32 || K % group || N % 16 ||
      splits < 1 || splits > kst)
    return (int)cudaErrorInvalidValue;
  Args p{};
  p.spk = (kst + splits - 1) / splits;
  if ((long long)(splits - 1) * p.spk >= kst ||
      smem_bytes(M, p.spk, group, ASYM) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  constexpr int R = STAGE_K / Codes<CODE>::ROWS;   // K values a byte row
  if (!qmm_tc::make_map(&p.map, planes, CU_TENSOR_MAP_DATA_TYPE_UINT8, N,
                        K / R, N, TN, Codes<CODE>::ROWS, true))
    return (int)cudaErrorInvalidValue;
  p.x = reinterpret_cast<const __nv_bfloat16*>(x);
  p.scales = reinterpret_cast<const __nv_bfloat16*>(scales);
  p.zeros = reinterpret_cast<const __nv_bfloat16*>(zeros);
  p.xs = reinterpret_cast<const float*>(xs);
  p.partial = reinterpret_cast<float*>(partial);
  p.tickets = reinterpret_cast<int*>(tickets);
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.group = group;
  p.out_f32 = out_f32;
  p.splits = splits;
  p.fuse = f;
  const int pro = (f.norm_w != nullptr ? P_RMS : 0) |
                  (f.u != nullptr ? P_GLU : 0);
  const int tiles = (N + TN - 1) / TN;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 8) return launch_pro<CODE, 1, ASYM>(p, pro, tiles, st);
  return launch_pro<CODE, 2, ASYM>(p, pro, tiles, st);
}

}  // namespace

// One entry point per branch, so that the launch counts name it. zeros: bf16
// [K/group, N] shifted like the codes, xs: f32 [M, K/group]; both are
// ignored (pass null) by the symmetric entries. partial: f32 [splits, M, N]
// scratch; tickets: int32 [ceil(N / 128)] zeros that the kernel leaves zero.
#define K1_ENTRY(NAME, CODE, ASYM)                                           \
  extern "C" int NAME(const void* x, const void* planes, const void* scales, \
                      const void* zeros, const void* xs, void* partial,      \
                      void* tickets, void* out, int M, int K, int N,         \
                      int group, int out_f32, int splits, void* stream) {    \
    return launch<CODE, ASYM>(x, planes, scales, ASYM ? zeros : nullptr,     \
                              ASYM ? xs : nullptr, partial, tickets, out, M, \
                              K, N, group, out_f32, splits, stream, Fuse{}); \
  }

K1_ENTRY(qmm4_npack, C_NIB, false)
K1_ENTRY(qmm4_npack_asym, C_NIB, true)
K1_ENTRY(qmm2_npack, C_INT2, false)
K1_ENTRY(qmm2_npack_asym, C_INT2, true)
K1_ENTRY(qmm8_native, C_INT8, false)
K1_ENTRY(qmm8_native_asym, C_INT8, true)

// The fused entry points, symmetric only: x is the raw residual stream when
// norm_w is set (bf16 [K], or f32 with norm_f32), the gate input when u is
// set (act: 0 silu, 1 gelu, 2 tanh gelu, 3 relu); res is a bf16 [M, N]
// residual added to the output, or null.
#define K1_FUSED(NAME, CODE)                                                 \
  extern "C" int NAME(const void* x, const void* u, const void* norm_w,      \
                      int norm_f32, float eps, float offset, int act,        \
                      const void* res, const void* planes,                   \
                      const void* scales, void* partial, void* tickets,      \
                      void* out, int M, int K, int N, int group,             \
                      int out_f32, int splits, void* stream) {               \
    const Fuse f{reinterpret_cast<const __nv_bfloat16*>(u), norm_w,          \
                 norm_f32, eps, offset, act,                                 \
                 reinterpret_cast<const __nv_bfloat16*>(res)};               \
    return launch<CODE, false>(x, planes, scales, nullptr, nullptr, partial, \
                               tickets, out, M, K, N, group, out_f32,        \
                               splits, stream, f);                           \
  }

K1_FUSED(qmm4_npack_fused, C_NIB)
K1_FUSED(qmm2_npack_fused, C_INT2)
K1_FUSED(qmm8_native_fused, C_INT8)
