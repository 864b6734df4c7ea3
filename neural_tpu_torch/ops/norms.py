"""RMS normalization (port of ``neural_tpu/ops/norms.py``): f32 compute,
then a cast back to the input dtype."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    """offset=1.0 gives Gemma-style (1 + w) scaling."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (weight.to(torch.float32) + offset)).to(x.dtype)
