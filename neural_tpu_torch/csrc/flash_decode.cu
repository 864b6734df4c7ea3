// K4 flash_decode: split-S decode attention (T = 1) over a contiguous bf16
// or int8 KV cache for Hopper.
//
// Replaces neural_tpu/ops/attention.py:_decode_kernel (launched by
// flash_decode). Caches [B, Hkv, S, D] with D = 128 or 256, bf16, or int8
// with bf16 scales [B, Hkv, S]; the tanh softcap, the ALiBi slopes and the
// sliding window of the TPU kernel. The device body, its numerics and its design are in
// decode_attn.cuh, which K6 (paged_decode.cu) shares.
#include "decode_attn.cuh"

DECODE_ATTN_ENTRY(flash_decode, false, false)
DECODE_ATTN_ENTRY(flash_decode_i8, true, false)
