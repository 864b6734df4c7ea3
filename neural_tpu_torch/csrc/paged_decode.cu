// K6 paged_decode: split-S decode attention (T = 1) over a page pool of a
// bf16, int8 or f32 KV cache for Hopper.
//
// Replaces neural_tpu/ops/paged_attention.py:_paged_decode_kernel (launched
// by paged_flash_decode). Pool [P, Hkv, ps, D] of one layer with D = 128
// or 256, bf16, int8 with bf16 scales [P, Hkv, ps], or f32 (each element
// rounded to bf16 as it is read); table [B, MAXP]
// int32 maps a row's page ordinal to its physical page; ps a multiple of
// 16. The TPU kernel reaches the pages through its block index maps (a
// prefetched table, pages past the fill or below the window floor clamped
// so their DMAs are elided); here K4's body (decode_body.cuh) runs over
// the pool's row space [P * Hkv, ps, D], its TMA producer looking each
// tile's page up in the table, with the pool's capacity MAXP * ps as S.
// The numerics, the options (softcap, ALiBi, window), the bound, the
// design and the precondition on the pool's rows are the body's.
#include "decode_body.cuh"

// as flash_decode, over pools [P, Hkv, ps, D] read through table [B, maxp]
// (n_split and chunk from k4_schedule at S = maxp * ps)
extern "C" int paged_decode(const void* q, const void* k, const void* v,
                            const void* table, const void* lengths,
                            const void* slopes, void* part_o, void* part_ml,
                            void* tickets, void* out, int B, int Hq, int Hkv,
                            int P, int ps, int maxp, int n_split, int chunk,
                            int D, float scale, float softcap, int window,
                            void* stream) {
  return decode_body::launch<true, decode_body::KV_BF16>(
      q, k, v, nullptr, nullptr, table, lengths, slopes, part_o, part_ml,
      tickets, out, B, Hq, Hkv, 0, P, ps, maxp, n_split, chunk, D, scale,
      softcap, window, stream);
}

// scale here is the softmax scale / 127; scales [P, Hkv, ps] bf16
extern "C" int paged_decode_i8(const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const void* table, const void* lengths,
                               const void* slopes, void* part_o,
                               void* part_ml, void* tickets, void* out, int B,
                               int Hq, int Hkv, int P, int ps, int maxp,
                               int n_split, int chunk, int D, float scale,
                               float softcap, int window, void* stream) {
  return decode_body::launch<true, decode_body::KV_I8>(
      q, k, v, k_scale, v_scale, table, lengths, slopes, part_o, part_ml,
      tickets, out, B, Hq, Hkv, 0, P, ps, maxp, n_split, chunk, D, scale,
      softcap, window, stream);
}

// an f32 pool, its elements rounded to bf16 as they are read; otherwise as
// paged_decode (the same schedule)
extern "C" int paged_decode_f32(const void* q, const void* k, const void* v,
                                const void* table, const void* lengths,
                                const void* slopes, void* part_o,
                                void* part_ml, void* tickets, void* out,
                                int B, int Hq, int Hkv, int P, int ps,
                                int maxp, int n_split, int chunk, int D,
                                float scale, float softcap, int window,
                                void* stream) {
  return decode_body::launch<true, decode_body::KV_F32>(
      q, k, v, nullptr, nullptr, table, lengths, slopes, part_o, part_ml,
      tickets, out, B, Hq, Hkv, 0, P, ps, maxp, n_split, chunk, D, scale,
      softcap, window, stream);
}
