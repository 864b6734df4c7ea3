"""RMS and Layer normalization (port of ``neural_tpu/ops/norms.py``): f32
compute, then a cast back to the input dtype."""
from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    """offset=1.0 gives Gemma-style (1 + w) scaling."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (weight.to(torch.float32) + offset)).to(x.dtype)


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
