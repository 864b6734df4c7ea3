"""Paged KV cache: fixed-size pages + per-sequence page tables (port of
``neural_tpu/runtime/paged.py``).

The serving cache is a shared pool of ``page_size``-token pages; each slot
maps its logical page ordinals to physical pages through a small int32
table, so memory is reserved per page a sequence can fill. Layouts: pools
``[L, P, Hkv, ps, Dh]`` (bf16 or int8), int8 scales ``[L, P, Hkv, ps]``
bf16, table ``[B, MAXP]`` int32; logical position ``p*ps + row`` of a slot
lives at ``pool[l, table[b, p], :, row]``.

The pools are updated in place, as :class:`~.kvcache.KVCache` is. The table
is one device buffer for the life of the cache: the scheduler rewrites it
with ``copy_`` and never rebinds it, so a CUDA graph that captured it reads
the current rows. Allocation is host-side bookkeeping
(:class:`PageAllocator`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ..core.device import resolve_device
from ..models.config import ModelConfig
from .kvcache import LayerKV, kv_torch_dtype


@dataclasses.dataclass
class PagedKVCache:
    k: torch.Tensor                  # [L, P, Hkv, ps, Dh] bf16 or int8
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]  # [L, P, Hkv, ps] bf16 iff int8
    v_scale: Optional[torch.Tensor]
    table: torch.Tensor              # [B, MAXP] int32 physical page ids

    @property
    def n_pages(self) -> int:
        return self.k.shape[1]

    def layer(self, l: int) -> LayerKV:
        sc = (None, None) if self.k_scale is None else \
            (self.k_scale[l], self.v_scale[l])
        return LayerKV(self.k[l], self.v[l], *sc, table=self.table)

    def rows(self, start: int, n: int) -> "PagedKVCache":
        """The same pool with table rows [start, start+n): writes land in
        those rows' pages."""
        return PagedKVCache(self.k, self.v, self.k_scale, self.v_scale,
                            self.table[start:start + n])


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     n_pages: Optional[int] = None, page_size: int = 256,
                     dtype: torch.dtype = torch.bfloat16,
                     device=None) -> PagedKVCache:
    """Pool of ``n_pages`` (default: worst case batch·max_len/ps) pages.

    ``max_len`` bounds any single sequence (table width MAXP); the pool may
    hold fewer pages than batch·MAXP — that under-reservation is the point.
    """
    if max_len % page_size:
        raise ValueError(f"max_len={max_len} is not a multiple of "
                         f"page_size={page_size}")
    maxp = max_len // page_size
    if n_pages is None:
        n_pages = batch * maxp
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
    table = torch.zeros((batch, maxp), dtype=torch.int32, device=dev)
    dtype = kv_torch_dtype(dtype)
    if dtype == torch.int8:
        z = lambda shp, dt: torch.zeros(shp, dtype=dt, device=dev)
        return PagedKVCache(z(shape, torch.int8), z(shape, torch.int8),
                            z(shape[:-1], torch.bfloat16),
                            z(shape[:-1], torch.bfloat16), table)
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=dev),
                        torch.zeros(shape, dtype=dtype, device=dev),
                        None, None, table)


class PageAllocator:
    """Host-side free-list over the physical page pool."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.free: List[int] = list(range(n_pages))[::-1]

    @property
    def n_free(self) -> int:
        return len(self.free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages, or None if the pool can't satisfy the request."""
        if n > len(self.free):
            return None
        return [self.free.pop() for _ in range(n)]

    def release(self, pages: Sequence[int]):
        self.free.extend(pages)
        if len(self.free) > self.n_pages:
            raise RuntimeError("released more pages than the pool holds")


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)
