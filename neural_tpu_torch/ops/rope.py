"""Rotary position embeddings (port of ``neural_tpu/ops/rope.py``: the
frequency table, unscaled or with the "llama3" scaling, and the
NeoX-style rotation Llama uses).

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
    computed in float64 and stored as float32 like the JAX table.
    ``max_seq_len`` is accepted for signature parity; the scalings ported
    here do not read it."""
    d = rope_dim or head_dim
    inv = 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
    if scaling:
        kind = scaling.get("type", scaling.get("rope_type", "linear"))
        if kind == "llama3":
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
        else:
            raise NotImplementedError(
                f"rope scaling {kind!r} is not ported yet (model zoo slice)")
    return inv.astype(np.float32)


def rope_cos_sin(positions: torch.Tensor, inv_freqs: torch.Tensor):
    """cos/sin tables [..., T, rope_dim//2] in f32 for the given positions."""
    ang = positions[..., None].to(torch.float32) * inv_freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate [..., T, H, Dh] halves — pair (i, i + Dh/2), the NeoX style —
    in f32, then cast back to x's dtype."""
    d = x.shape[-1]
    c = cos[..., None, :]
    s = sin[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
