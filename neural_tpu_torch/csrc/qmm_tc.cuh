// Building blocks of the port's pipelined tensor-core mainloops (K2
// qmm_a8.cu, K5 qmm_general.cu, K3 flash_prefill.cu, K4 flash_decode.cu):
// tensor maps and TMA copies into a ring of shared memory completing on
// mbarriers, the wgmma operand layouts and descriptors, the wgmma shapes
// the kernels issue, the exact integer-to-float conversions, and the
// warp-specialisation helpers (setmaxnreg, a named barrier).
//
// Operand layouts. Every wgmma operand here is K-major. The x tile comes
// from TMA with the 128-byte swizzle (desc_sw128). The weight tile, which
// the kernels' own threads write after dequantizing, is unswizzled: a
// tile of R rows (N columns of the weight) by 16-byte runs of K is a grid
// of "core matrices", 8 rows x 16 bytes, each 128 contiguous bytes. The
// core matrices of one row group sit next to each other along K (the
// descriptor's leading byte offset, LBO = 128), and row group g starts at
// g * SBO with SBO = 8 * (bytes of K a row) + 16: the 16 extra bytes turn
// the 16-byte stores of neighbouring row groups onto other banks, so the
// stores of one quarter-warp never collide. cm_off gives the byte of
// (row, kbyte) in that layout.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qmm_tc {

// ------------------------------------------------------------ TMA (host)

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found once through the runtime (no
// link against the driver library)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                            &q);
#endif
    fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A tensor map of `rank` (1-3) dimensions, innermost first: dims[i]
// elements, strides[i - 1] bytes between steps of dimension i, copied in
// boxes of box[i] elements; reads past any edge come back as zeros.
// Returns false on failure.
inline bool make_map_nd(CUtensorMap* map, const void* base,
                        CUtensorMapDataType type, int rank,
                        const long long* dims, const long long* strides,
                        const int* box, bool swizzle128) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || rank < 1 || rank > 3) return false;
  cuuint64_t dim[3], stride[2];
  cuuint32_t bx[3], estride[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    dim[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
    if (i > 0) stride[i - 1] = (cuuint64_t)strides[i - 1];
  }
  return fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), dim, stride,
            bx, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D tensor map over a row-major [rows][cols] array, `pitch` bytes a
// row, copied in boxes of box_cols x box_rows.
inline bool make_map(CUtensorMap* map, const void* base,
                     CUtensorMapDataType type, long long cols,
                     long long rows, long long pitch, int box_cols,
                     int box_rows, bool swizzle128) {
  const long long dims[2] = {cols, rows}, strides[1] = {pitch};
  const int box[2] = {box_cols, box_rows};
  return make_map_nd(map, base, type, 2, dims, strides, box, swizzle128);
}

// A 3-D tensor map over a row-major [outer][rows][cols] array of `es`-byte
// elements (a cache [B * Hkv][S][D], or q [B * T][Hq][D]), copied in boxes
// of box_cols x box_rows x 1: a box past `rows` reads zeros and never the
// next outer index's rows.
inline bool make_map_3d(CUtensorMap* map, const void* base,
                        CUtensorMapDataType type, int es, long long cols,
                        long long rows, long long outer, int box_cols,
                        int box_rows, bool swizzle128) {
  const long long dims[3] = {cols, rows, outer};
  const long long strides[2] = {cols * es, rows * cols * es};
  const int box[3] = {box_cols, box_rows, 1};
  return make_map_nd(map, base, type, 3, dims, strides, box, swizzle128);
}

// ---------------------------------------------------- TMA and mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
               "r"(count));
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive on the barrier and expect `bytes` more of asynchronous copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
      "r"(bytes)
      : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(a),
      "r"(parity)
      : "memory");
}

// copy the box at (col, row) of `map` to shared memory at dst, completing
// on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
      : "memory");
}

// the same for a 3-D map, at (col, row, outer)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int col, int row, int outer,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(outer),
      "r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
      : "memory");
}

// a plain arrival on the barrier (release: this thread's earlier shared
// memory writes are visible to the threads its phase releases)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
               : "memory");
}

// a barrier among `count` threads (a multiple of 32) of the block, apart
// from __syncthreads' barrier 0
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Warp specialisation: the warpgroup's register budget a thread, moved
// between warpgroups (all four warps of a warpgroup execute it together)
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// The x tile as TMA writes it with the 128-byte swizzle: rows of 128 bytes
// of K, 8 rows an atom of 1024 bytes, each row's 16-byte chunks permuted
// by the row's index in its atom. Its wgmma descriptor: layout type 1
// (128-byte swizzle), stride byte offset 1024 between atoms; the start
// address of a K step moves by its bytes within the row.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// An MN-major operand under the 128-byte swizzle (the transpose bit of a
// bf16 wgmma): rows of 128 bytes along MN (64 bf16), one row per K index, 8
// rows an atom of 1024 bytes; `lbo` bytes between the 64-wide MN blocks,
// 1024 (the stride byte offset) between the 8-row K groups. A K step of 16
// moves the start address by 16 rows, 2048 bytes.
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t addr,
                                                  uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// byte of (row, kbyte) in a tile TMA wrote with the 128-byte swizzle from
// boxes 128 bytes wide: one block of `rows` x 128 bytes per 128 bytes of
// the row, the 16-byte chunks of each row permuted by the row's index in
// its 8-row atom
__device__ __forceinline__ int sw128_off(int row, int kbyte, int rows) {
  return (kbyte >> 7) * rows * 128 + row * 128 +
         ((((kbyte & 127) >> 4) ^ (row & 7)) << 4) + (kbyte & 15);
}

__host__ __device__ constexpr int cm_sbo(int row_bytes) {
  return 8 * row_bytes + 16;
}

__device__ __forceinline__ int cm_off(int row, int kbyte, int sbo) {
  return (row >> 3) * sbo + (kbyte >> 4) * 128 + (row & 7) * 16 +
         (kbyte & 15);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Exact conversions that keep off the quarter-rate I2F pipe. The four
// int8 codes of w as floats: each byte, biased to unsigned, in the
// mantissa of 2^23, less 2^23 + 128.
__device__ __forceinline__ void codes_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + k)) -
           8388736.f;
}

// an int32 dot |d| < 2^22 as a float: d in the mantissa of 1.5 * 2^23,
// less 1.5 * 2^23
__device__ __forceinline__ float dot_f32(int d) {
  return __int_as_float(d + 0x4B400000) - 12582912.f;
}

// two floats that are exact in bf16 (|x| <= 256 integers, say) as a bf16
// pair, the first in the low half: their high halves
__device__ __forceinline__ uint32_t bf16_pair_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// eight f32 values at src (16-byte aligned shared memory) rounded to bf16
// to nearest even (__float2bfloat16, torch's .to(torch.bfloat16)), as the
// 16 bytes of eight bf16 values in order: the f32-cache branches of the
// attention kernels narrow their raw K/V tiles with it
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint4 bf16x8_rn(const uint8_t* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 16);
  return make_uint4(bf16x2_rn(a.x, a.y), bf16x2_rn(a.z, a.w),
                    bf16x2_rn(b.x, b.y), bf16x2_rn(b.z, b.w));
}

// makes this thread's plain shared-memory stores visible to the async
// proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// an unswizzled K-major operand descriptor (layout type 0, base offset 0)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the wgmma issue and wait around it
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x 128] (f32) += A[64 x 16] (bf16) * B[16 x 128] (bf16), both from
// shared memory. Thread t of the warpgroup holds rows 16 (t / 32) + (t %
// 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1) in d[4 j .. 4 j + 3].
// scale_d == 0 ignores D's old value.
__device__ __forceinline__ void wgmma_bf16_n128(float* d, uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (s32) += A[64 x 32] (s8) * B[32 x 128] (s8), both from shared
// memory, the same register layout as above
__device__ __forceinline__ void wgmma_s8_n128(int* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] (f32) += A[64 x 16] (bf16) * B[16 x 64] (bf16), both K-major
// from shared memory; the register layout of wgmma_bf16_n128
__device__ __forceinline__ void wgmma_bf16_n64(
    float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] (s32) += A[64 x 32] (s8) * B[32 x 64] (s8), both K-major from
// shared memory
__device__ __forceinline__ void wgmma_s8_n64(
    int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (f32) += A[64 x 16] (bf16, registers) * B[16 x 128] (bf16,
// MN-major in shared memory: the transpose bit set). a[0..3] hold the A
// fragment of mma.sync m16n8k16 for the thread's warp's 16 rows: rows
// 16 (t / 32) + (t % 32) / 4 (+ 8), columns 2 (t % 4) (+ 1) (+ 8).
__device__ __forceinline__ void wgmma_bf16_rs_n128(
    float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 256] (f32) += A[64 x 16] (bf16, registers) * B[16 x 256] (bf16,
// MN-major), as wgmma_bf16_rs_n128; d[4 j .. 4 j + 3] for j = 0 .. 31
__device__ __forceinline__ void wgmma_bf16_rs_n256(
    float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

}  // namespace qmm_tc
