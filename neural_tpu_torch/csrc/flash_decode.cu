// K4 flash_decode: split-S decode attention (T = 1) over a contiguous bf16
// or int8 KV cache for Hopper.
//
// Replaces neural_tpu/ops/attention.py:_decode_kernel (launched by
// flash_decode). q [B, Hq, D] bf16 with D = 128 or 256; caches [B, Hkv, S,
// D], bf16, or int8 with bf16 scales [B, Hkv, S]; output f32 [B, Hq, D].
// The device body, its numerics, its options (softcap, ALiBi, window), its
// bound and its design are in decode_body.cuh, which K6 (paged_decode.cu)
// instantiates over a page pool.
#include "decode_body.cuh"

// n_split splits of `chunk` keys each (a multiple of the tile, from
// k4_schedule) cover S; part_o [B * Hq, n_split, D] and part_ml
// [B * Hq, n_split, 2] f32 are the wrapper's scratch, tickets int32
// [B * Hkv * head groups] zeros that the kernel leaves zero; slopes may be
// null
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* lengths, const void* slopes,
                            void* part_o, void* part_ml, void* tickets,
                            void* out, int B, int Hq, int Hkv, int S,
                            int n_split, int chunk, int D, float scale,
                            float softcap, int window, void* stream) {
  return decode_body::launch<false, false>(
      q, k, v, nullptr, nullptr, nullptr, lengths, slopes, part_o, part_ml,
      tickets, out, B, Hq, Hkv, S, 0, 0, 0, n_split, chunk, D, scale,
      softcap, window, stream);
}

// scale here is the softmax scale / 127
extern "C" int flash_decode_i8(const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const void* lengths, const void* slopes,
                               void* part_o, void* part_ml, void* tickets,
                               void* out, int B, int Hq, int Hkv, int S,
                               int n_split, int chunk, int D, float scale,
                               float softcap, int window, void* stream) {
  return decode_body::launch<false, true>(
      q, k, v, k_scale, v_scale, nullptr, lengths, slopes, part_o, part_ml,
      tickets, out, B, Hq, Hkv, S, 0, 0, 0, n_split, chunk, D, scale,
      softcap, window, stream);
}
