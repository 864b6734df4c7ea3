"""Split fused HF QKV tensors into separate q/k/v (the port's copy of the
fp part of ``neural_tpu/models/_defuse.py``).

The port keeps separate ``[K, N]`` projections, as the JAX package does, so
each family's fused layout is untangled once at conversion. Inputs are
HF-layout ``[out_features, in_features]`` tensors (or 1-D biases); splitting
an already-quantized tensor (a GPTQ/AWQ import) comes with that import.
"""
from __future__ import annotations

import numpy as np
import torch


def asw(x) -> torch.Tensor:
    """A state-dict entry as a torch tensor (numpy arrays are wrapped)."""
    if hasattr(x, "planes"):
        raise NotImplementedError("splitting pre-quantized fused tensors "
                                  "comes with the GPTQ/AWQ import")
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))


def split_interleaved(w, n_heads: int, head_dim: int):
    """[H*3*Dh, ...] with a per-head (q, k, v) interleave → 3x [H*Dh, ...].
    Layout used by GPT-NeoX, Bloom and ChatGLM-1."""
    w = asw(w)
    rest = tuple(w.shape[1:])
    w4 = w.reshape(n_heads, 3, head_dim, *rest)
    return tuple(w4[:, i].reshape(n_heads * head_dim, *rest)
                 for i in range(3))


def split_concat(w, q_dim: int, kv_dim: int):
    """[q+kv+kv, ...] straight concatenation → q, k, v. Layout used by
    MPT."""
    w = asw(w)
    return w[:q_dim], w[q_dim:q_dim + kv_dim], w[q_dim + kv_dim:]
