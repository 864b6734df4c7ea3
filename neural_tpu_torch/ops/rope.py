"""Position encodings (port of ``neural_tpu/ops/rope.py``: the frequency
table, unscaled or with any of the JAX package's scalings; the NeoX-style
rotation Llama uses and the GPT-J one, which the StreamingLLM shift
takes; ChatGLM-1's 2-D GLM rotation; the ALiBi slopes of Bloom and MPT).

Conventions: q/k are [..., T, H, Dh]; ``positions`` is [..., T] int.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def rope_freqs(head_dim: int, rope_dim: Optional[int], theta: float,
               scaling: Optional[dict] = None,
               max_seq_len: Optional[int] = None) -> np.ndarray:
    """Per-pair inverse frequencies [rope_dim//2] (host-side constant),
    computed in float64 and stored as float32 like the JAX table, with
    every scaling the JAX package has: "linear", "longrope"/"su", its
    simplified "yarn" (no mscale), "llama3" and "dynamic" NTK.
    ``max_seq_len``: the context length the table must serve, which the
    "dynamic" kind reads; the others ignore it."""
    d = rope_dim or head_dim
    inv = 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
    if scaling:
        kind = scaling.get("type", scaling.get("rope_type", "linear"))
        if kind == "linear":
            inv = inv / scaling["factor"]
        elif kind in ("longrope", "su"):
            # Phi-3 longrope: per-dim rescale factors (the long set)
            inv = inv / np.asarray(scaling["long_factor"], np.float64)
        elif kind == "yarn":
            # the simplified yarn: low-frequency dims interpolated by factor
            factor = scaling["factor"]
            orig = scaling.get("original_max_position_embeddings", 4096)
            low = scaling.get("beta_fast", 32)
            high = scaling.get("beta_slow", 1)
            wavelen = 2 * np.pi / inv
            ramp = np.clip((wavelen - orig / high)
                           / (orig / low - orig / high), 0, 1)
            inv = inv / (factor * ramp + (1 - ramp))
        elif kind == "llama3":
            # Llama-3.1 band scaling: long wavelengths divided by factor,
            # short kept, a smooth band between low/high_freq_factor
            factor = scaling["factor"]
            orig = scaling.get("original_max_position_embeddings", 8192)
            lo_f = scaling.get("low_freq_factor", 1.0)
            hi_f = scaling.get("high_freq_factor", 4.0)
            wavelen = 2 * np.pi / inv
            smooth = np.clip((orig / wavelen - lo_f) / (hi_f - lo_f), 0, 1)
            inv = np.where(wavelen < orig / hi_f, inv,
                           (1 - smooth) * inv / factor + smooth * inv)
        elif kind == "dynamic":
            # NTK "dynamic", evaluated once for the table's serving length:
            # theta grows only when max_seq_len passes the trained window
            orig = (scaling.get("original_max_position_embeddings")
                    or scaling.get("max_position_embeddings")
                    or max_seq_len or 4096)
            target = max(max_seq_len or orig, orig)
            factor = scaling.get("factor", 1.0)
            alpha = (factor * target / orig) - (factor - 1)
            if target > orig and alpha > 1.0:
                theta_d = theta * alpha ** (d / max(d - 2, 1))
                inv = 1.0 / (theta_d **
                             (np.arange(0, d, 2, dtype=np.float64) / d))
        else:
            raise ValueError(f"unknown rope scaling {kind}")
    return inv.astype(np.float32)


def rope_cos_sin(positions: torch.Tensor, inv_freqs: torch.Tensor):
    """cos/sin tables [..., T, rope_dim//2] in f32 for the given positions."""
    ang = positions[..., None].to(torch.float32) * inv_freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               style: str = "neox",
               rope_dim: Optional[int] = None) -> torch.Tensor:
    """Rotate the first ``rope_dim`` (all, by default) of [..., T, H, Dh]
    in f32, then cast back to x's dtype. ``style`` "neox" pairs (i, i +
    d/2), the halves Llama uses; "gptj" pairs (2i, 2i + 1)."""
    Dh = x.shape[-1]
    d = rope_dim or Dh
    xr = x[..., :d]
    c = cos[..., None, :]
    s = sin[..., None, :]
    if style == "neox":
        x1, x2 = xr[..., : d // 2], xr[..., d // 2:]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    elif style == "gptj":
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                          dim=-1).reshape(xr.shape)
    else:
        raise ValueError(f"rope style {style!r}")
    if d != Dh:
        out = torch.cat([out, x[..., d:].to(out.dtype)], dim=-1)
    return out.to(x.dtype)


def glm1_cos_sin(positions: torch.Tensor, prompt_len: torch.Tensor,
                 inv_freqs: torch.Tensor):
    """The two cos/sin tables of ChatGLM-1's 2-D GLM RoPE for absolute
    ``positions`` [B, T] and per-row prompt lengths P = ``prompt_len`` [B]:
    the position id min(p, P-2) (clamped at the [gMASK] token) and the
    block id max(p-(P-2), 0) (the generation counter). ``inv_freqs`` are
    those of n_dims = Dh/2 (``rope_freqs(head_dim, head_dim // 2, ...)``)."""
    anchor = (prompt_len.long() - 2)[:, None]
    pos = torch.minimum(positions.clamp_min(0), anchor.clamp_min(0))
    blk = (positions - anchor).clamp_min(0)
    return (*rope_cos_sin(pos, inv_freqs), *rope_cos_sin(blk, inv_freqs))


def apply_glm1(x: torch.Tensor, tables) -> torch.Tensor:
    """Two NeoX rotations on the halves of [B, T, H, Dh]: the first half by
    the position ids, the second by the block ids (``glm1_cos_sin``)."""
    c1, s1, c2, s2 = tables
    d = x.shape[-1] // 2
    return torch.cat([apply_rope(x[..., :d], c1, s1),
                      apply_rope(x[..., d:], c2, s2)], dim=-1)


def apply_rope_glm1(x: torch.Tensor, positions: torch.Tensor,
                    prompt_len: torch.Tensor,
                    inv_freqs: torch.Tensor) -> torch.Tensor:
    """ChatGLM-1's 2-D GLM RoPE on x [B, T, H, Dh] (the JAX package's
    ``apply_rope_glm1``)."""
    return apply_glm1(x, glm1_cos_sin(positions, prompt_len, inv_freqs))


def alibi_slopes(n_heads: int) -> np.ndarray:
    """ALiBi per-head slopes [n_heads] f32 (Bloom, MPT): the geometric
    series 2^(-8/n·(i+1)) for the largest power of two n <= n_heads, and
    for the rest every other slope of the series of 2n."""
    def pow2slopes(n):
        start = 2.0 ** (-(2.0 ** -(np.log2(n) - 3)))
        return start * (start ** np.arange(n))
    n = 2 ** int(np.floor(np.log2(n_heads)))
    slopes = pow2slopes(n)
    if n < n_heads:
        slopes = np.concatenate([slopes,
                                 pow2slopes(2 * n)[0::2][: n_heads - n]])
    return slopes.astype(np.float32)
