"""KV cache (port of ``neural_tpu/runtime/kvcache.py``, bf16 only).

Layout is head-major ``[L, B, Hkv, S, Dh]``: each layer's ``[B, Hkv, S,
Dh]`` slice is one contiguous block the attention kernels read directly.
Unlike the JAX cache, the port's cache is updated in place: the forward
pass writes only the new tokens' slots, so no step copies the cache.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ..core.device import resolve_device
from ..models.config import ModelConfig


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor                  # [L, B, Hkv, S, Dh]
    v: torch.Tensor


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[Union[str, torch.device]] = None) -> KVCache:
    if dtype != torch.bfloat16:
        raise NotImplementedError(
            f"KV cache dtype {dtype}: only bf16 is ported (int8 KV is a "
            "later slice)")
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    dev = resolve_device(device)
    return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev))
