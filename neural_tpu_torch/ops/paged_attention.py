"""Paged-KV attention: K6, its plain version, the page gathers, the paged
dispatch and the page-pool writes (port of
``neural_tpu/ops/paged_attention.py``).

- **K6** :func:`paged_decode` / :func:`paged_decode_i8`
  (``csrc/paged_decode.cu``) replace the TPU's ``_paged_decode_kernel``:
  K4's body (``csrc/decode_body.cuh``, a TMA ring of K/V tiles, mma.sync
  with all G heads of a KV head as rows), its producer looking each tile's
  page up in ``table[b, s // ps]`` (:func:`~.attention.k6_boxes`,
  :func:`~.attention.k6_tile_pages`), launched as K4 with the pool's
  capacity MAXP·ps as S. Tiles past a row's fill, and wholly below its
  sliding window, are never read, so table entries past the fill may point
  anywhere in the pool; every row of a page the table names must hold
  finite K/V (a whole box is read and masked). The softcap, ALiBi and the
  window are K4's.
- :func:`attend_paged`: T == 1 goes to K6; T > 1 gathers the slot's pages
  into a contiguous ``[B, Hkv, MAXP·ps, Dh]`` view and runs K3 over it, the
  JAX package's own route for paged prefill; a head dim that is not a
  multiple of 128 gathers the pages for ``attend_xla`` at any T. Unlike the JAX package's
  ``attend_paged``, which takes no prefix bound (so its paged prefill of a
  prefix-LM model is causal), the GLM prefix mask reaches K3 here too.

Layouts (``runtime/paged.py``): per layer a pool ``[P, Hkv, ps, Dh]``,
int8 scales ``[P, Hkv, ps]`` bf16, table ``[B, MAXP]`` int32.
"""
from __future__ import annotations

import torch

from . import _cuda
from .attention import (_k4_launch, attend_xla, attn_options, attn_scale,
                        check_head_dim, flash_decode_i8_plain,
                        flash_decode_plain, flash_prefill, flash_prefill_i8,
                        k6_boxes, quantize_kv)


def gather_pages(pool, table):
    """[P, Hkv, ps, Dh] + [B, MAXP] → contiguous [B, Hkv, MAXP*ps, Dh]."""
    g = pool[table.long()]                      # [B, MAXP, Hkv, ps, Dh]
    B, MP, H, ps, Dh = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, H, MP * ps, Dh)


def gather_scales(spool, table):
    """[P, Hkv, ps] + [B, MAXP] → [B, Hkv, MAXP*ps]."""
    g = spool[table.long()]                     # [B, MAXP, Hkv, ps]
    B, MP, H, ps = g.shape
    return g.permute(0, 2, 1, 3).reshape(B, H, MP * ps)


def paged_decode_plain(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                       scale: float, softcap: float = 0.0, window: int = 0,
                       slopes=None):
    """Plain version of K6: gather the pages, then K4's plain version (bf16
    or int8 by the pool's scales). q [B, Hq, Dh]; pools [P, Hkv, ps, Dh];
    table [B, MAXP]; lengths [B]; ALiBi ``slopes`` [Hq] or None →
    [B, Hq, Dh] f32."""
    k, v = gather_pages(k_pool, table), gather_pages(v_pool, table)
    if k_scale is None:
        return flash_decode_plain(q, k, v, lengths, scale, softcap, window,
                                  slopes)
    return flash_decode_i8_plain(q, k, v, gather_scales(k_scale, table),
                                 gather_scales(v_scale, table), lengths,
                                 scale, softcap, window, slopes)


def _paged_args(q, k_pool, v_pool, table, lengths, kv_dtype):
    B, Hq, Dh = q.shape
    P, Hkv, ps = k_pool.shape[:3]
    check_head_dim(Dh)
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    k6_boxes(ps, Dh)
    q = q.to(torch.bfloat16).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    for name, c in (("k_pool", k_pool), ("v_pool", v_pool)):
        _cuda.check(c, name, kv_dtype, (P, Hkv, ps, Dh))
    _cuda.check(table, "table", torch.int32)
    if table.shape[0] != B:
        raise ValueError(f"table has {table.shape[0]} rows for B={B}")
    _cuda.check(lengths, "lengths", torch.int32, (B,))
    return q, lengths


def paged_decode(q, k_pool, v_pool, table, lengths, scale: float,
                 softcap: float = 0.0, window: int = 0, slopes=None):
    """K6 over a bf16 pool. Same contract as :func:`paged_decode_plain`."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, None, None, table,
                                  lengths, scale, softcap, window, slopes)
    q, lengths = _paged_args(q, k_pool, v_pool, table, lengths,
                             torch.bfloat16)
    return _k4_launch("paged_decode", q, k_pool, v_pool, None, None, lengths,
                      scale, softcap, window, slopes, table)


def paged_decode_i8(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                    scale: float, softcap: float = 0.0, window: int = 0,
                    slopes=None):
    """K6 over an int8 pool. Same contract as :func:`paged_decode_plain`."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, k_scale, v_scale, table,
                                  lengths, scale, softcap, window, slopes)
    q, lengths = _paged_args(q, k_pool, v_pool, table, lengths, torch.int8)
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        _cuda.check(s, name, torch.bfloat16, k_pool.shape[:3])
    return _k4_launch("paged_decode_i8", q, k_pool, v_pool, k_scale,
                      v_scale, lengths, scale / 127.0, softcap, window,
                      slopes, table)


def attend_paged(q, k_pool, v_pool, k_scale, v_scale, table, positions, cfg,
                 window: int = 0, slopes=None, prefix_len=None):
    """Paged dispatch, mirroring :func:`~.attention.attend`: K6 for T == 1;
    for T > 1 the slot's pages are gathered into a contiguous view for K3.
    q [B, T, Hq, Dh]; positions [B, T]; the config's softcap, this layer's
    sliding ``window`` (0 = off), an ALiBi config's ``slopes`` [Hq] and a
    prefix-LM config's prompt lengths ``prefix_len`` [B] (prefill only) →
    [B, T, Hq*Dh] f32. A head dim that is not a multiple of 128 gathers the
    pages and takes :func:`~.attention.attend_xla`, at T == 1 too, as the
    JAX package's ``attend_paged`` does (counted as the route
    ``attend_xla_paged``)."""
    B, T, Hq, Dh = q.shape
    slopes, prefix_len = attn_options(cfg, T, slopes, prefix_len)
    if Dh % 128:
        _cuda.ROUTES.count("attend_xla_paged")
        ks, vs = (None if s is None else gather_scales(s, table)
                  for s in (k_scale, v_scale))
        return attend_xla(q, gather_pages(k_pool, table),
                          gather_pages(v_pool, table), positions, cfg, ks, vs,
                          window, slopes, prefix_len)
    opts = (attn_scale(cfg, Dh), cfg.attn_softcap, window, slopes)
    if T == 1:
        lengths = positions[:, 0] + 1
        if k_scale is None:
            out = paged_decode(q[:, 0], k_pool, v_pool, table, lengths, *opts)
        else:
            out = paged_decode_i8(q[:, 0], k_pool, v_pool, k_scale, v_scale,
                                  table, lengths, *opts)
        return out.reshape(B, 1, Hq * Dh)
    k, v = gather_pages(k_pool, table), gather_pages(v_pool, table)
    if k_scale is None:
        out = flash_prefill(q, k, v, positions[:, 0], *opts, prefix_len)
    else:
        out = flash_prefill_i8(q, k, v, gather_scales(k_scale, table),
                               gather_scales(v_scale, table),
                               positions[:, 0], *opts, prefix_len)
    return out.reshape(B, T, Hq * Dh)


def paged_update_kv(k_pool, v_pool, ks_pool, vs_pool, k_new, v_new, table,
                    start):
    """Write new tokens' K/V into one layer's page pool, in place.

    k_new/v_new [B, Hkv, T, Dh] (RoPE'd). For T == 1 the write lands at
    ``(table[b, start // ps], start % ps)``; for T > 1 the start must be
    page-aligned and whole pages stream in (a last partial page writes its
    leading rows only). With an int8 pool the codes and scales come from
    :func:`quantize_kv`. Every index stays on the device: no host sync."""
    ps = k_pool.shape[-2]
    B, H, T, Dh = k_new.shape
    if ks_pool is not None:
        k_new, ks_new = quantize_kv(k_new)           # scales [B, Hkv, T]
        v_new, vs_new = quantize_kv(v_new)
        writes = ((k_pool, k_new), (v_pool, v_new), (ks_pool, ks_new),
                  (vs_pool, vs_new))
    else:
        writes = ((k_pool, k_new), (v_pool, v_new))
    start = start.long()
    if T == 1:
        page = table[torch.arange(B, device=table.device), start // ps].long()
        row = start % ps
        for pool, new in writes:
            pool[page, :, row] = new[:, :, 0].to(pool.dtype)
        return
    npages = -(-T // ps)
    ords = start[:, None] // ps + torch.arange(npages, device=start.device)
    pages = table.gather(1, ords).long()            # [B, npages]
    full, tail = divmod(T, ps)
    for pool, new in writes:
        new = new.to(pool.dtype)
        if full:
            chunk = new[:, :, :full * ps].unflatten(2, (full, ps))
            pool[pages[:, :full]] = chunk.transpose(1, 2)
        if tail:
            pool[pages[:, full], :, :tail] = new[:, :, full * ps:]
