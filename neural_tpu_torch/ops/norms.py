"""RMS and Layer normalization (port of ``neural_tpu/ops/norms.py``): f32
compute, then a cast back to the input dtype.

On the card :func:`rms_norm` launches the row-norm kernel
(``csrc/rms_norm.cu``), which computes each row's scale by the routine of
K1's fused rms prologue (``csrc/rms_row.cuh``: one fixed order of the sum
of squares, ``rsqrtf``), so that the unfused graph and the fused decode
path give the same bits. On the CPU it is :func:`rms_norm_plain`, the
torch chain, which the card's kernel is held against to a tolerance.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _cuda


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
                   offset: float = 0.0) -> torch.Tensor:
    """The norm as torch ops: the mean square in f32, ``rsqrt``, times
    ``weight + offset``, cast to x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (weight.to(torch.float32) + offset)).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    """offset=1.0 gives Gemma-style (1 + w) scaling. On the card x is
    [..., K] bf16 (the residual stream) with K a multiple of 8 and the
    weight [K] bf16 or f32 (the final norm's)."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps, offset)
    if x.dtype != torch.bfloat16 or \
            weight.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"rms_norm on the card takes bf16 x and a bf16 or "
                         f"f32 weight, got {x.dtype} and {weight.dtype}")
    K = x.shape[-1]
    if K % 8:
        raise ValueError(f"rms_norm needs a row length that is a multiple "
                         f"of 8, got {K}")
    x2 = x.reshape(-1, K).contiguous()
    weight = weight.contiguous()
    _cuda.check(x2, "x", torch.bfloat16)
    _cuda.check(weight, "norm weight", weight.dtype, (K,))
    out = torch.empty_like(x2)
    _cuda.RMS_NORM.call("rms_norm_bf16", _cuda.ptr(x2), _cuda.ptr(weight),
                        int(weight.dtype == torch.float32), float(eps),
                        float(offset), _cuda.ptr(out), x2.shape[0], K,
                        _cuda.stream_ptr())
    return out.reshape(x.shape)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], eps: float = 1e-5
               ) -> torch.Tensor:
    """LayerNorm with an optional bias (MPT has none): the mean and the
    biased variance in f32, ``(var + eps) ** -0.5``."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * (var + eps) ** -0.5 * weight.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)
