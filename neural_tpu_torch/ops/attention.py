"""Attention over the bf16 KV cache: the K3 and K4 kernels, their plain
versions, the f32 reference and the dispatch.

Port of ``neural_tpu/ops/attention.py`` for the main path. The cache is
head-major ``[B, Hkv, S, Dh]`` per layer.

- **K4** :func:`flash_decode` (``csrc/flash_decode.cu``) replaces the TPU's
  ``_decode_kernel``: T = 1, split over S with a combine pass.
- **K3** :func:`flash_prefill` (``csrc/flash_prefill.cu``) replaces
  ``_prefill_kernel``: causal flash attention for T > 1 queries against a
  cache that already holds them.

Both follow the TPU kernels' rounding: bf16 QK^T and PV operands, f32
softmax statistics, P rounded to bf16 before PV, masked scores at -1e30, l
floored at 1e-30, f32 output. Head dim 128 only; int8 KV, sliding windows,
ALiBi, softcaps and the GLM prefix mask are later slices.
"""
from __future__ import annotations

import torch

from . import _cuda

NEG = -1e30


def attend_xla(q, k_cache, v_cache, positions, cfg):
    """Reference attention, all f32 (the JAX package's ``attend_xla`` for a
    bf16 cache). q [B, T, Hq, Dh]; caches [B, Hkv, S, Dh]; positions [B, T]
    → [B, T, Hq*Dh] f32."""
    B, T, Hq, Dh = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qh = q.reshape(B, T, Hkv, G, Dh).permute(0, 2, 3, 1, 4)
    scale = cfg.attn_scale if cfg.attn_scale is not None else Dh ** -0.5
    scores = torch.einsum("bhgtd,bhsd->bhgts", qh.to(torch.float32) * scale,
                          k_cache.to(torch.float32))
    s_idx = torch.arange(S, device=q.device)[None, None, :]
    mask = s_idx <= positions[:, :, None]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bhsd->bhgtd", probs, v_cache.to(torch.float32))
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq * Dh)


def _softmax_pv(s: torch.Tensor, v: torch.Tensor, eq: str) -> torch.Tensor:
    """f32 softmax statistics over the last axis, P rounded to bf16 for the
    PV product, l summed from the unrounded P."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum(eq, p.to(torch.bfloat16).to(torch.float32),
                      v.to(torch.float32))
    return pv / l.clamp_min(1e-30)


# ---------------------------------------------------------------------------
# K4: decode (T = 1)
# ---------------------------------------------------------------------------


def flash_decode_plain(q, k_cache, v_cache, lengths, scale: float):
    """Plain version of K4. q [B, Hq, Dh] bf16; caches [B, Hkv, S, Dh];
    keys at positions >= lengths[b] masked → [B, Hq, Dh] f32."""
    B, Hq, Dh = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    qh = q.to(torch.bfloat16).reshape(B, Hkv, Hq // Hkv, Dh)
    s = torch.einsum("bhgd,bhsd->bhgs", qh.to(torch.float32),
                     k_cache.to(torch.float32)) * scale
    mask = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG))
    return _softmax_pv(s, v_cache, "bhgs,bhsd->bhgd").reshape(B, Hq, Dh)


DECODE_CHUNK = 64     # keys per block of K4's first pass


def flash_decode(q, k_cache, v_cache, lengths, scale: float):
    """K4. Same contract as :func:`flash_decode_plain`."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, lengths, scale)
    B, Hq, Dh = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    q = q.to(torch.bfloat16).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    _check_attention(q, k_cache, v_cache, Hq, Hkv, Dh, B)
    _cuda.check(lengths, "lengths", torch.int32, (B,))
    if Hq // Hkv > 8:
        raise ValueError(f"flash_decode takes at most 8 query heads per KV "
                         f"head, got {Hq // Hkv}")
    n_split = -(-S // DECODE_CHUNK)
    part_o = torch.empty((B * Hq, n_split, Dh), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((B * Hq, n_split, 2), dtype=torch.float32,
                          device=q.device)
    out = torch.empty((B, Hq, Dh), dtype=torch.float32, device=q.device)
    _cuda.FLASH_DECODE.call(
        "flash_decode", _cuda.ptr(q), _cuda.ptr(k_cache), _cuda.ptr(v_cache),
        _cuda.ptr(lengths), _cuda.ptr(part_o), _cuda.ptr(part_ml),
        _cuda.ptr(out), B, Hq, Hkv, S, n_split, float(scale),
        _cuda.stream_ptr())
    _cuda.FLASH_DECODE.launches += 1
    return out


# ---------------------------------------------------------------------------
# K3: prefill (T > 1, causal)
# ---------------------------------------------------------------------------


def flash_prefill_plain(q, k_cache, v_cache, starts, scale: float):
    """Plain version of K3. q [B, T, Hq, Dh] bf16; caches [B, Hkv, S, Dh]
    already holding these keys; query t at position starts[b] + t sees keys
    s <= starts[b] + t → [B, T, Hq, Dh] f32."""
    B, T, Hq, Dh = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    qh = q.to(torch.bfloat16).reshape(B, T, Hkv, Hq // Hkv, Dh) \
        .permute(0, 2, 3, 1, 4)
    s = torch.einsum("bhgtd,bhsd->bhgts", qh.to(torch.float32),
                     k_cache.to(torch.float32)) * scale
    qpos = starts[:, None] + torch.arange(T, device=q.device)[None, :]
    mask = torch.arange(S, device=q.device)[None, None, :] <= qpos[:, :, None]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG))
    out = _softmax_pv(s, v_cache, "bhgts,bhsd->bhgtd")
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, Dh)


def flash_prefill(q, k_cache, v_cache, starts, scale: float):
    """K3. Same contract as :func:`flash_prefill_plain`."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k_cache, v_cache, starts, scale)
    B, T, Hq, Dh = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    q = q.to(torch.bfloat16).contiguous()
    starts = starts.to(torch.int32).contiguous()
    _check_attention(q, k_cache, v_cache, Hq, Hkv, Dh, B)
    _cuda.check(starts, "starts", torch.int32, (B,))
    out = torch.empty((B, T, Hq, Dh), dtype=torch.float32, device=q.device)
    _cuda.FLASH_PREFILL.call(
        "flash_prefill", _cuda.ptr(q), _cuda.ptr(k_cache), _cuda.ptr(v_cache),
        _cuda.ptr(starts), _cuda.ptr(out), B, T, Hq, Hkv, S, float(scale),
        _cuda.stream_ptr())
    _cuda.FLASH_PREFILL.launches += 1
    return out


def _check_attention(q, k_cache, v_cache, Hq, Hkv, Dh, B):
    if Dh != 128:
        raise ValueError(f"the attention kernels take head_dim 128, got {Dh}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    S = k_cache.shape[2]
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        _cuda.check(c, name, torch.bfloat16, (B, Hkv, S, Dh))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def attend(q, k_cache, v_cache, positions, cfg):
    """q [B, T, Hq, Dh] at ``positions`` [B, T] against one layer's cache
    [B, Hkv, S, Dh] (already holding these keys) → [B, T, Hq*Dh] f32.
    T == 1 goes to K4, T > 1 to K3."""
    if cfg.attn_softcap or cfg.sliding_window or cfg.use_alibi \
            or cfg.prefix_lm:
        raise NotImplementedError(
            "softcap, sliding-window, ALiBi and prefix-LM attention are "
            "later slices")
    if k_cache.dtype != torch.bfloat16:
        raise NotImplementedError("int8 KV cache is a later slice")
    B, T, Hq, Dh = q.shape
    scale = cfg.attn_scale if cfg.attn_scale is not None else Dh ** -0.5
    if T == 1:
        out = flash_decode(q[:, 0], k_cache, v_cache, positions[:, 0] + 1,
                           scale)
    else:
        out = flash_prefill(q, k_cache, v_cache, positions[:, 0], scale)
    return out.reshape(B, T, Hq * Dh)
