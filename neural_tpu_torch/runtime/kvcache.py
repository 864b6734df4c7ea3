"""KV cache (port of ``neural_tpu/runtime/kvcache.py``).

Layout is head-major ``[L, B, Hkv, S, Dh]``: each layer's ``[B, Hkv, S,
Dh]`` slice is one contiguous block the attention kernels read directly.
int8 KV keeps flat bf16 per-(token, head) scales ``[L, B, Hkv, S]`` beside
the codes. Unlike the JAX cache, the port's cache is updated in place: the
forward pass writes only the new tokens' slots, so no step copies the
cache. Beam search reorders its rows (:func:`reorder_batch`) into a second
cache and swaps the two; :func:`copy_kv` copies rows or pages in place,
for a prompt's KV shared to the other rows of a beam group and for the
Scheduler's beam reorders (its captured graphs hold the cache's storage).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.config import ModelConfig


class LayerKV(NamedTuple):
    """One layer's view of a cache, as the decoder block takes it: a
    contiguous ``[B, Hkv, S, Dh]`` slice, or a page pool ``[P, Hkv, ps,
    Dh]`` with its ``table`` [B, MAXP]; scales iff int8."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    table: Optional[torch.Tensor] = None


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor                            # [L, B, Hkv, S, Dh]
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None     # [L, B, Hkv, S] bf16 iff int8
    v_scale: Optional[torch.Tensor] = None

    def layer(self, l: int) -> LayerKV:
        sc = (None, None) if self.k_scale is None else \
            (self.k_scale[l], self.v_scale[l])
        return LayerKV(self.k[l], self.v[l], *sc)

    def rows(self, start: int, n: int) -> "KVCache":
        """Batch rows [start, start+n) as a view: its writes land in this
        cache, and each layer's slice stays contiguous."""
        return KVCache(*(None if c is None else c[:, start:start + n]
                         for c in (self.k, self.v, self.k_scale,
                                   self.v_scale)))


#: the KV cache dtypes the attention kernels read
KV_DTYPES = (torch.bfloat16, torch.float32, torch.int8)
_KV_NAMES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
             "float32": torch.float32, "int8": torch.int8}


def kv_torch_dtype(kv_dtype) -> torch.dtype:
    """A KV cache dtype as the JAX server and Scheduler take it — a name
    (``"bfloat16"``, ``"float32"``, ``"int8"``; ``"bf16"`` too) or a dtype
    (torch or numpy) — as the port's torch dtype, passed through
    unchanged; one the kernels do not read raises."""
    if isinstance(kv_dtype, torch.dtype):
        dt = kv_dtype
    else:
        name = kv_dtype if isinstance(kv_dtype, str) else \
            np.dtype(kv_dtype).name
        dt = _KV_NAMES.get(name)
    if dt not in KV_DTYPES:
        raise NotImplementedError(
            f"KV cache dtype {kv_dtype!r}: the port keeps bf16, f32 or int8 "
            "KV")
    return dt


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[Union[str, torch.device]] = None) -> KVCache:
    """A zeroed cache: bf16 or f32, or int8 codes with bf16 scales."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    dev = resolve_device(device)
    dtype = kv_torch_dtype(dtype)
    if dtype == torch.int8:
        return KVCache(torch.zeros(shape, dtype=torch.int8, device=dev),
                       torch.zeros(shape, dtype=torch.int8, device=dev),
                       torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                   device=dev),
                       torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                   device=dev))
    return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev))


def cache_nbytes(cache) -> int:
    """Bytes of a cache's K and V (and int8 scales), contiguous or paged,
    as the JAX package's ``cache_nbytes`` counts them."""
    tot = cache.k.numel() * cache.k.element_size() * 2
    if cache.k_scale is not None:
        tot += cache.k_scale.numel() * cache.k_scale.element_size() * 2
    return tot


def reorder_batch(cache: KVCache, idx: torch.Tensor,
                  out: Optional[KVCache] = None) -> KVCache:
    """Reorder the batch rows (beam search's parents): row b of the result
    is row ``idx[b]`` of ``cache``, int8 scales included. The rows are
    gathered on the device into ``out``, a cache of the same shapes that
    the caller swaps with ``cache`` (``cache, spare = reorder_batch(cache,
    parents, spare), cache``), or into new tensors when ``out`` is None;
    never in place, never through the host."""
    idx = idx.to(device=cache.k.device, dtype=torch.long)
    if out is None:
        return KVCache(*(None if c is None else c.index_select(1, idx)
                         for c in (cache.k, cache.v, cache.k_scale,
                                   cache.v_scale)))
    for src, dst in zip((cache.k, cache.v, cache.k_scale, cache.v_scale),
                        (out.k, out.v, out.k_scale, out.v_scale)):
        if src is not None:
            torch.index_select(src, 1, idx, out=dst)
    return out


#: the largest temporary a KV copy gathers at once, in bytes
_COPY_BYTES = 256 << 20


def copy_kv(cache, src: Sequence[int], dst: Sequence[int],
            n: Optional[int] = None):
    """Copy ``[:, src[i]]`` → ``[:, dst[i]]`` over the K and V tensors and
    their int8 scales, in place: whole pages of a paged pool (``n`` None),
    or batch rows of a contiguous cache over positions [0, n) (nothing at
    or past a row's length is read, so the rest need not move). A beam
    prompt's KV shared to the group's other rows or pages, or a beam
    reorder. Each group of layers is gathered into a temporary of at most
    ``_COPY_BYTES`` before it is written, so overlapping sets are safe,
    and the tensors keep their storage (captured graphs read them)."""
    if not src:
        return
    dev = cache.k.device
    src = torch.tensor(list(src), dtype=torch.long, device=dev)
    dst = torch.tensor(list(dst), dtype=torch.long, device=dev)
    for c in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if c is None:
            continue
        if n is not None:
            c = c[:, :, :, :n]
        per_layer = len(src) * c[0, 0].numel() * c.element_size()
        step = max(1, _COPY_BYTES // per_layer)
        for l in range(0, c.shape[0], step):
            block = c[l:l + step]
            block.index_copy_(1, dst, block.index_select(1, src))
