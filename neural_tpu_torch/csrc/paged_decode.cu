// K6 paged_decode: split-S decode attention (T = 1) over a page pool of a
// bf16 or int8 KV cache for Hopper.
//
// Replaces neural_tpu/ops/paged_attention.py:_paged_decode_kernel (launched
// by paged_flash_decode). Pool [P, Hkv, ps, D] of one layer with D = 128
// or 256, bf16, or int8 with bf16 scales [P, Hkv, ps]; table [B, MAXP]
// int32 maps a row's page ordinal to its physical page. The TPU kernel
// reaches the pages through its block index maps (a prefetched table,
// pages past the fill or below the window floor clamped so their DMAs are
// elided); here each key's row is looked up once per chunk from
// table[b, s / ps], and keys past the fill or below the window floor are
// never looked up, so any page size works. The device body, its numerics,
// its options (softcap, ALiBi, window) and its design are K4's
// (decode_attn.cuh).
#include "decode_attn.cuh"

DECODE_ATTN_ENTRY(paged_decode, false, true)
DECODE_ATTN_ENTRY(paged_decode_i8, true, true)
