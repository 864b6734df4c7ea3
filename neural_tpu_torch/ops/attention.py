"""Attention over the KV cache: the K3 and K4 kernels in their bf16 and int8
variants, their plain versions, ``quantize_kv``, the f32 reference and the
dispatch.

Port of ``neural_tpu/ops/attention.py`` for the main path. The cache is
head-major ``[B, Hkv, S, Dh]`` per layer: bf16, or int8 codes with flat
bf16 per-(token, head) scales ``[B, Hkv, S]``.

- **K4** :func:`flash_decode` / :func:`flash_decode_i8`
  (``csrc/flash_decode.cu``) replace the TPU's ``_decode_kernel``: T = 1,
  split over S (:func:`k4_schedule`) with a combine pass.
- **K3** :func:`flash_prefill` / :func:`flash_prefill_i8`
  (``csrc/flash_prefill.cu``) replace ``_prefill_kernel``: causal flash
  attention for T > 1 queries against a cache that already holds them
  (:func:`k3_schedule`).

The bf16 variants follow the TPU kernels' rounding: bf16 QK^T and PV
operands, f32 softmax statistics, P rounded to bf16 before PV, masked
scores at -1e30, l floored at 1e-30, f32 output. The int8 variants quantize
q per row (``q8 = round(q · 127/qa)``, ``qa = max|q| + 1e-9``), take an
exact int8·int8 QK dot and form ``s = d · (qa·scale/127) · k_scale``; l
sums the unscaled P, and the v scale is folded into P — in f32 for the PV
product of decode, rounded to bf16 for the bf16 PV product of prefill, as
each TPU kernel does. Head dim 128 or 256. The options of the TPU kernels,
each off by default: the tanh softcap (``softcap · tanh(s / softcap)`` on
the scaled f32 score, before the mask; 0 = off); ALiBi (``slopes`` [Hq]
f32, None = off: ``slope_h · (kv_pos - q_pos)`` added in f32 after the
softcap, before the mask); the sliding window (an int, 0 = off: decode
sees keys at ``pos >= length - window``, prefill keys at ``kv_pos > q_pos
- window``); and, in prefill only, the GLM prefix-LM mask (``prefix_len``
[B] int32, None = off; a row's 0 is off too): keys at ``kv_pos <
prefix_len[b] - 1`` are visible to every query of row b. Decode needs no
prefix mask: every key a decode step sees is already causal. Any number
of query heads per KV head.

The dispatch :func:`attend` sends a head dim that is not a multiple of 128
to :func:`attend_xla`, as the JAX package does; the kernels' wrappers take
head dims 128 and 256 only.
"""
from __future__ import annotations

import torch

from . import _cuda

NEG = -1e30
HEAD_DIMS = (128, 256)    # the head dims the attention kernels are built for
PREFIX_OFF = -(1 << 30)   # a prefix bound no key is below


def quantize_kv(x: torch.Tensor):
    """[..., Dh] → (int8 codes, bf16 scales [...]), per-token-head absmax.
    The scale is rounded to bf16 first and the codes are quantized against
    the rounded value, by a division (a tensor divisor: the IEEE quotient
    on the card too), then clipped to ±127."""
    absmax = x.to(torch.float32).abs().amax(dim=-1)
    scale = (absmax / torch.full_like(absmax, 127.0) + 1e-9) \
        .to(torch.bfloat16)
    q = torch.round(x.to(torch.float32) / scale.to(torch.float32)[..., None])
    return q.clamp(-127, 127).to(torch.int8), scale


def _dequant(cache, scale):
    if scale is None:
        return cache.to(torch.float32)
    return cache.to(torch.float32) * scale.to(torch.float32)[..., None]


def _softcap(s: torch.Tensor, softcap: float) -> torch.Tensor:
    return softcap * torch.tanh(s / softcap) if softcap else s


def _alibi(s: torch.Tensor, slopes, dist: torch.Tensor) -> torch.Tensor:
    """s [B, Hkv, G, ..., S] + slope of the query head · dist [B, ..., S]
    (kv_pos - q_pos, f32): a product, then a sum, each rounded in f32."""
    if slopes is None:
        return s
    Hkv, G = s.shape[1:3]
    extra = s.dim() - 3
    sl = slopes.to(torch.float32).reshape(1, Hkv, G, *([1] * extra))
    return s + sl * dist.to(torch.float32)[:, None, None]


def _prefix_m1(prefix_len):
    """[B] → prefix_len - 1, or a bound no key is below where it is 0."""
    p = prefix_len.long()
    return torch.where(p > 0, p - 1, torch.full_like(p, PREFIX_OFF))


def attend_xla(q, k_cache, v_cache, positions, cfg, k_scale=None,
               v_scale=None, window: int = 0, slopes=None, prefix_len=None):
    """Reference attention, all f32 (the JAX package's ``attend_xla``).
    q [B, T, Hq, Dh]; caches [B, Hkv, S, Dh] (bf16, or int8 with scales
    [B, Hkv, S]); positions [B, T]; the config's softcap, ALiBi ``slopes``
    [Hq] (read when the config uses ALiBi), the GLM prefix mask
    ``prefix_len`` [B] and a sliding ``window`` (0 = off) →
    [B, T, Hq*Dh] f32."""
    B, T, Hq, Dh = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qh = q.reshape(B, T, Hkv, G, Dh).permute(0, 2, 3, 1, 4)
    scale = cfg.attn_scale if cfg.attn_scale is not None else Dh ** -0.5
    scores = torch.einsum("bhgtd,bhsd->bhgts", qh.to(torch.float32) * scale,
                          _dequant(k_cache, k_scale))
    scores = _softcap(scores, cfg.attn_softcap)
    s_idx = torch.arange(S, device=q.device)[None, None, :]
    q_abs = positions[:, :, None]
    mask = s_idx <= q_abs
    if prefix_len is not None:
        mask = mask | (s_idx < prefix_len.long()[:, None, None] - 1)
    if window:
        mask = mask & (s_idx > q_abs - window)
    if cfg.use_alibi:
        scores = _alibi(scores, slopes, s_idx - q_abs)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bhsd->bhgtd", probs,
                       _dequant(v_cache, v_scale))
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq * Dh)


def _softmax_pv(s: torch.Tensor, v: torch.Tensor, eq: str) -> torch.Tensor:
    """f32 softmax statistics over the last axis, P rounded to bf16 for the
    PV product, l summed from the unrounded P."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum(eq, p.to(torch.bfloat16).to(torch.float32),
                      v.to(torch.float32))
    return pv / l.clamp_min(1e-30)


def _quantize_q(q: torch.Tensor):
    """Per-row int8 quantization of bf16 q [..., Dh] as the int8 kernels do
    it: codes (integer-valued f32) and ``qa = max|q| + 1e-9`` [..., 1]. The
    127/qa is a true division (a tensor over a tensor)."""
    qf = q.to(torch.bfloat16).to(torch.float32)
    qa = qf.abs().amax(dim=-1, keepdim=True) + 1e-9
    return torch.round(qf * (torch.full_like(qa, 127.0) / qa)), qa


def _i8_scores(q8, qa, k8, k_scale, scale: float, eq: str, ks_view):
    """``d · (qa·scale/127) · k_scale`` with the int8·int8 dot d computed in
    f32: every partial sum is an integer below 2^24 (127·127·256 at head
    dim 256), so it is exact in any order, as the kernels' int32 dot is."""
    d = torch.einsum(eq, q8, k8.to(torch.float32))
    return d * (qa * (scale / 127.0)) * ks_view(k_scale.to(torch.float32))


# ---------------------------------------------------------------------------
# K4: decode (T = 1)
# ---------------------------------------------------------------------------


def _decode_opts(s, lengths, softcap: float, window: int, slopes):
    """The softcap, ALiBi at ``pos - (length - 1)``, then the mask: keys at
    positions < lengths[b] and, with a window, >= lengths[b] - window stay;
    the rest score -1e30."""
    pos = torch.arange(s.shape[-1], device=s.device)[None, :]
    lengths = lengths.long()[:, None]
    s = _alibi(_softcap(s, softcap), slopes, pos - (lengths - 1))
    mask = pos < lengths
    if window:
        mask = mask & (pos >= lengths - window)
    return torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG))


def flash_decode_plain(q, k_cache, v_cache, lengths, scale: float,
                       softcap: float = 0.0, window: int = 0, slopes=None):
    """Plain version of K4. q [B, Hq, Dh] bf16; caches [B, Hkv, S, Dh];
    keys at positions >= lengths[b] (and, with a window, below lengths[b] -
    window) masked; ALiBi ``slopes`` [Hq] or None → [B, Hq, Dh] f32."""
    B, Hq, Dh = q.shape
    Hkv = k_cache.shape[1]
    qh = q.to(torch.bfloat16).reshape(B, Hkv, Hq // Hkv, Dh)
    s = torch.einsum("bhgd,bhsd->bhgs", qh.to(torch.float32),
                     k_cache.to(torch.float32)) * scale
    s = _decode_opts(s, lengths, softcap, window, slopes)
    return _softmax_pv(s, v_cache, "bhgs,bhsd->bhgd").reshape(B, Hq, Dh)


def flash_decode_i8_plain(q, k_cache, v_cache, k_scale, v_scale, lengths,
                          scale: float, softcap: float = 0.0,
                          window: int = 0, slopes=None):
    """Plain version of K4's int8 variant. Caches int8 [B, Hkv, S, Dh] with
    bf16 scales [B, Hkv, S]; the v scale multiplies P in f32 and PV is an
    f32 product → [B, Hq, Dh] f32."""
    B, Hq, Dh = q.shape
    Hkv = k_cache.shape[1]
    q8, qa = _quantize_q(q.reshape(B, Hkv, Hq // Hkv, Dh))
    s = _i8_scores(q8, qa, k_cache, k_scale, scale, "bhgd,bhsd->bhgs",
                   lambda ks: ks[:, :, None, :])
    s = _decode_opts(s, lengths, softcap, window, slopes)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p * v_scale.to(torch.float32)[:, :, None, :]
    pv = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.to(torch.float32))
    return (pv / l.clamp_min(1e-30)).reshape(B, Hq, Dh)


# K4's schedule (and K6's: the same body, decode_body.cuh): keys a tile (32
# KB of bf16 K and V at either head dim), the stages of its ring, heads a
# block (padded), and the waves of blocks over the card's SMs that a split
# count aims for
K4_TILE = {128: 64, 256: 32}
K4_STAGES = 2
K4_HEADS = (16, 64)
# blocks resident at once an SM: a bf16 block holds ~73 KB of shared memory,
# an int8 one ~42 KB and ~120 registers a thread
K4_BLOCKS_PER_SM = {False: 3, True: 4}
H100_SMS = 132
K4_TICKETS = 1 << 16      # ticket counters kept per device (_cuda.tickets)


def k4_schedule(B: int, Hq: int, Hkv: int, S: int, D: int,
                n_sm: int = H100_SMS, int8: bool = False) -> dict:
    """K4's launch, and K6's with the pool's capacity MAXP·ps as S: the
    tile, the split of S into ``n_split`` chunks of ``chunk`` keys (a whole
    number of tiles), the heads a block serves (padded to 16, or 64 past 16
    a KV head) and the grid (splits, B·Hkv, head groups). The split comes
    from B·Hkv, the capacity S and the SM count alone, never from the fill
    or the window (the host never reads them, so the launch can sit in a
    CUDA graph): the fewest tiles a chunk that let every block be resident
    at once (K4_BLOCKS_PER_SM an SM, by the cache's type), so that batch 1
    fills the card 2-4 times over in one wave and each block streams a few
    tiles through its ring."""
    tk = K4_TILE[D]
    G = Hq // Hkv
    mp = K4_HEADS[0] if G <= K4_HEADS[0] else K4_HEADS[1]
    groups = -(-G // mp)
    tiles = -(-S // tk)
    per_chunk = min(tiles, -(-B * Hkv * groups * tiles
                             // (K4_BLOCKS_PER_SM[int8] * n_sm)))
    chunk = per_chunk * tk
    n_split = -(-S // chunk)
    return dict(tile=tk, stages=K4_STAGES, tiles_per_chunk=per_chunk,
                chunk=chunk, n_split=n_split, heads=mp,
                grid=(n_split, B * Hkv, groups))


def k6_boxes(ps: int, D: int) -> tuple:
    """K6's TMA boxes: (key rows a box, boxes a tile). A box stays inside
    one page: its rows are the largest power of two dividing the page size
    (a multiple of 16), up to K4's tile, so the server's 256-key pages take
    one box a tile and 16- or 32-key pages several on the stage's
    barrier."""
    if ps <= 0 or ps % 16:
        raise ValueError(f"K6 takes page sizes that are multiples of 16, "
                         f"got {ps}")
    br = min(K4_TILE[D], ps & -ps)
    return br, K4_TILE[D] // br


def k6_tile_pages(fill: int, window: int, ps: int, D: int, chunk: int,
                  split: int) -> list:
    """The table entries (page ordinals of the row) that one K6 block reads
    for split ``split`` of a row of fill ``fill``: the kernel's producer
    rule, box by box, in the order it issues them. A box wholly past the
    fill or below the window's floor reads the page of the nearest visible
    key, so no entry outside [floor // ps, (fill - 1) // ps] is read; a
    split with no visible key reads none."""
    tk = K4_TILE[D]
    br, _ = k6_boxes(ps, D)
    lo = max(fill - window, 0) if window else 0
    kb, ke = max(split * chunk, lo), min(split * chunk + chunk, fill)
    if kb >= ke:
        return []
    out = []
    for t in range(kb // tk, -(-ke // tk)):
        for r0 in range(0, tk, br):
            k = min(max(t * tk + r0, lo), fill - 1)
            out.append((t * tk + r0, k // ps))
    return out


def _check_slopes(slopes, Hq: int):
    """ALiBi slopes as a kernel takes them: [Hq] f32 on the card."""
    if slopes is not None:
        _cuda.check(slopes, "slopes", torch.float32, (Hq,))


def _branches(slopes, Hq: int, Hkv: int):
    """A decode launch with ALiBi counts under ``fn+alibi`` as well, one with
    more than 8 query heads per KV head under ``fn+G>8``."""
    return (() if slopes is None else ("alibi",)) + \
        (("G>8",) if Hq // Hkv > 8 else ())


def _k4_launch(fn, q, k, v, k_scale, v_scale, lengths, qk_scale, softcap,
               window, slopes, table=None):
    """Launch K4 (``flash_decode``, ``flash_decode_i8``) over caches [B, Hkv,
    S, D], or K6 (``paged_decode``, ``paged_decode_i8``) over pools [P,
    Hkv, ps, D] through ``table`` [B, MAXP] at S = MAXP·ps, with
    :func:`k4_schedule`'s split; the scratch (part_o, part_ml) is allocated
    here, inside a graph capture too; the last block of each row merges the
    splits."""
    B, Hq, Dh = q.shape
    Hkv = k.shape[1]
    if table is None:
        kernel, S, geometry = _cuda.FLASH_DECODE, k.shape[2], []
    else:
        ps, maxp = k.shape[2], table.shape[1]
        kernel, S = _cuda.PAGED_DECODE, maxp * ps
        geometry = [k.shape[0], ps, maxp]
    _check_slopes(slopes, Hq)
    sch = k4_schedule(B, Hq, Hkv, S, Dh, _cuda.sm_count(q.device),
                      k_scale is not None)
    n_split = sch["n_split"]
    part_o = torch.empty((B * Hq, n_split, Dh), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((B * Hq, n_split, 2), dtype=torch.float32,
                          device=q.device)
    out = torch.empty((B, Hq, Dh), dtype=torch.float32, device=q.device)
    # the last block of each (row, KV head) puts its counter back to 0
    tickets = _cuda.tickets("decode", q.device, B * Hkv * sch["grid"][2],
                            K4_TICKETS)
    opt = lambda t: 0 if t is None else _cuda.ptr(t)
    scales = [] if k_scale is None else [_cuda.ptr(k_scale),
                                         _cuda.ptr(v_scale)]
    paged = [] if table is None else [_cuda.ptr(table)]
    kernel.call(
        fn, _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), *scales, *paged,
        _cuda.ptr(lengths), opt(slopes), _cuda.ptr(part_o),
        _cuda.ptr(part_ml), _cuda.ptr(tickets), _cuda.ptr(out), B, Hq, Hkv,
        *(geometry or [S]), n_split, sch["chunk"], Dh, float(qk_scale),
        float(softcap), int(window), _cuda.stream_ptr(),
        branches=_branches(slopes, Hq, Hkv))
    return out


def flash_decode(q, k_cache, v_cache, lengths, scale: float,
                 softcap: float = 0.0, window: int = 0, slopes=None):
    """K4. Same contract as :func:`flash_decode_plain`."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, lengths, scale,
                                  softcap, window, slopes)
    B, Hq, Dh = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    q = q.to(torch.bfloat16).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    _check_attention(q, k_cache, v_cache, Hq, Hkv, Dh, B, torch.bfloat16)
    _cuda.check(lengths, "lengths", torch.int32, (B,))
    return _k4_launch("flash_decode", q, k_cache, v_cache, None, None,
                      lengths, scale, softcap, window, slopes)


def flash_decode_i8(q, k_cache, v_cache, k_scale, v_scale, lengths,
                    scale: float, softcap: float = 0.0, window: int = 0,
                    slopes=None):
    """K4, int8 variant. Same contract as :func:`flash_decode_i8_plain`."""
    if q.device.type == "cpu":
        return flash_decode_i8_plain(q, k_cache, v_cache, k_scale, v_scale,
                                     lengths, scale, softcap, window, slopes)
    B, Hq, Dh = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    q = q.to(torch.bfloat16).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    _check_attention(q, k_cache, v_cache, Hq, Hkv, Dh, B, torch.int8)
    _check_scales(k_scale, v_scale, (B, Hkv, S))
    _cuda.check(lengths, "lengths", torch.int32, (B,))
    return _k4_launch("flash_decode_i8", q, k_cache, v_cache, k_scale,
                      v_scale, lengths, scale / 127.0, softcap, window,
                      slopes)


# ---------------------------------------------------------------------------
# K3: prefill (T > 1, causal)
# ---------------------------------------------------------------------------


def _prefill_opts(s, starts, softcap: float, window: int, slopes,
                  prefix_len):
    """The softcap, ALiBi at ``kv_pos - q_pos``, then the mask of the TPU
    kernel: (causal and the window) or the prefix, ``kv_pos <
    prefix_len[b] - 1``."""
    T, S = s.shape[-2], s.shape[-1]
    qpos = starts.long()[:, None, None] + \
        torch.arange(T, device=s.device)[None, :, None]
    kpos = torch.arange(S, device=s.device)[None, None, :]
    s = _alibi(_softcap(s, softcap), slopes, kpos - qpos)
    mask = kpos <= qpos
    if window:
        mask = mask & (kpos > qpos - window)
    if prefix_len is not None:
        mask = mask | (kpos < _prefix_m1(prefix_len)[:, None, None])
    return torch.where(mask[:, None, None], s, torch.full_like(s, NEG))


def _heads_first(q, Hkv):
    B, T, Hq, Dh = q.shape
    return q.reshape(B, T, Hkv, Hq // Hkv, Dh).permute(0, 2, 3, 1, 4)


def flash_prefill_plain(q, k_cache, v_cache, starts, scale: float,
                        softcap: float = 0.0, window: int = 0, slopes=None,
                        prefix_len=None):
    """Plain version of K3. q [B, T, Hq, Dh] bf16; caches [B, Hkv, S, Dh]
    already holding these keys; query t at position starts[b] + t sees keys
    s <= starts[b] + t (and, with a window, s > starts[b] + t - window), or
    with ``prefix_len`` [B] any key s < prefix_len[b] - 1; ALiBi ``slopes``
    [Hq] or None → [B, T, Hq, Dh] f32."""
    B, T, Hq, Dh = q.shape
    qh = _heads_first(q.to(torch.bfloat16), k_cache.shape[1])
    s = torch.einsum("bhgtd,bhsd->bhgts", qh.to(torch.float32),
                     k_cache.to(torch.float32)) * scale
    s = _prefill_opts(s, starts, softcap, window, slopes, prefix_len)
    out = _softmax_pv(s, v_cache, "bhgts,bhsd->bhgtd")
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, Dh)


def flash_prefill_i8_plain(q, k_cache, v_cache, k_scale, v_scale, starts,
                           scale: float, softcap: float = 0.0,
                           window: int = 0, slopes=None, prefix_len=None):
    """Plain version of K3's int8 variant: the v scale multiplies P, which
    is then rounded to bf16 for a bf16 PV product with the int8 v codes
    widened to bf16 (exact) → [B, T, Hq, Dh] f32."""
    B, T, Hq, Dh = q.shape
    q8, qa = _quantize_q(_heads_first(q, k_cache.shape[1]))
    s = _i8_scores(q8, qa, k_cache, k_scale, scale, "bhgtd,bhsd->bhgts",
                   lambda ks: ks[:, :, None, None, :])
    s = _prefill_opts(s, starts, softcap, window, slopes, prefix_len)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p * v_scale.to(torch.float32)[:, :, None, None, :]
    pv = torch.einsum("bhgts,bhsd->bhgtd",
                      p.to(torch.bfloat16).to(torch.float32),
                      v_cache.to(torch.float32))
    out = pv / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, Dh)


# K3's schedule: query rows a block (two consumer warpgroups of 64) and keys
# a tile by head dim (at 256 the f32 output takes 128 registers a thread)
K3_ROWS = 128
K3_WG_ROWS = 64
K3_TILE = {128: 128, 256: 64}
K3_STAGES = {128: 3, 256: 2}


def k3_schedule(B: int, T: int, Hq: int, Hkv: int, S: int, D: int,
                starts, window: int = 0, prefix_len=None) -> dict:
    """K3's launch, as the C entry point computes it on the device from
    ``starts`` and ``prefix_len`` (host lists of B ints here; None: no
    prefix): the grid, a block a work item (b·Hq + h, 128 query rows), the
    work items in the order of the blocks (``order``: (b·Hq + h, query
    block), the heaviest query blocks first, so the light ones fill the
    tail), and for each batch row and query block the
    key tiles the block streams (``tiles``: [lo, hi)) and, for each of its
    two consumer warpgroups of 64 rows, the keys its rows can see
    (``keys``: [lo, hi), None when its rows lie past T), the tiles it
    computes and the subset of those that need the per-element mask
    (``masked``); the others ("interior") hold no hidden, windowed or
    past-S key for any of its rows."""
    tk = K3_TILE[D]
    n_tb = -(-T // K3_ROWS)
    blocks = {}
    for b in range(B):
        start = int(starts[b])
        pref = 0 if prefix_len is None else int(prefix_len[b])
        pm1 = pref - 1 if pref > 0 else PREFIX_OFF
        for tb in range(n_tb):
            t0 = tb * K3_ROWS
            wgs = []
            for w in range(K3_ROWS // K3_WG_ROWS):
                r0 = t0 + w * K3_WG_ROWS
                if r0 >= T:
                    wgs.append(dict(keys=None, tiles=[], masked=[]))
                    continue
                qlo, qhi = start + r0, start + min(r0 + K3_WG_ROWS, T) - 1
                end = min(max(qhi + 1, pm1), S)
                beg = max(qlo - window + 1, 0) if window > 0 and pm1 <= 0 \
                    else 0
                wgs.append(dict(keys=(beg, end), qpos=(qlo, qhi)))
            valid = [w for w in wgs if w["keys"] is not None]
            lo = min(w["keys"][0] for w in valid) // tk
            hi = -(-max(w["keys"][1] for w in valid) // tk)
            for w in valid:
                (beg, end), (qlo, qhi) = w["keys"], w["qpos"]
                w["tiles"] = [i for i in range(lo, hi)
                              if i * tk + tk > beg and i * tk < end]
                w["masked"] = [i for i in w["tiles"] if not (
                    i * tk + tk <= S and (
                        i * tk + tk <= pm1 or (
                            i * tk + tk - 1 <= qlo and (
                                window <= 0 or i * tk > qhi - window))))]
            blocks[(b, tb)] = dict(tiles=(lo, hi), warpgroups=wgs)
    items = B * Hq * n_tb
    return dict(rows=K3_ROWS, tile=tk, stages=K3_STAGES[D], items=items,
                grid=(items,),
                order=[(w % (B * Hq), n_tb - 1 - w // (B * Hq))
                       for w in range(items)], blocks=blocks)


def _prefill_launch(fn, q, k_cache, v_cache, k_scale, v_scale, starts,
                    qk_scale, softcap, window, slopes, prefix_len):
    B, T, Hq, Dh = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    _check_slopes(slopes, Hq)
    if prefix_len is not None:
        prefix_len = prefix_len.to(torch.int32).contiguous()
        _cuda.check(prefix_len, "prefix_len", torch.int32, (B,))
    out = torch.empty((B, T, Hq, Dh), dtype=torch.float32, device=q.device)
    scales = [] if k_scale is None else [_cuda.ptr(k_scale),
                                         _cuda.ptr(v_scale)]
    opt = lambda t: 0 if t is None else _cuda.ptr(t)
    branches = (() if slopes is None else ("alibi",)) + \
        (() if prefix_len is None else ("prefix",))
    _cuda.FLASH_PREFILL.call(
        fn, _cuda.ptr(q), _cuda.ptr(k_cache), _cuda.ptr(v_cache), *scales,
        _cuda.ptr(starts), opt(slopes), opt(prefix_len), _cuda.ptr(out), B,
        T, Hq, Hkv, S, Dh, float(qk_scale), float(softcap), int(window),
        _cuda.stream_ptr(), branches=branches)
    return out


def _prefill_args(q, k_cache, v_cache, starts, kv_dtype):
    B, T, Hq, Dh = q.shape
    q = q.to(torch.bfloat16).contiguous()
    starts = starts.to(torch.int32).contiguous()
    _check_attention(q, k_cache, v_cache, Hq, k_cache.shape[1], Dh, B,
                     kv_dtype)
    _cuda.check(starts, "starts", torch.int32, (B,))
    return q, starts


def flash_prefill(q, k_cache, v_cache, starts, scale: float,
                  softcap: float = 0.0, window: int = 0, slopes=None,
                  prefix_len=None):
    """K3. Same contract as :func:`flash_prefill_plain`."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k_cache, v_cache, starts, scale,
                                   softcap, window, slopes, prefix_len)
    q, starts = _prefill_args(q, k_cache, v_cache, starts, torch.bfloat16)
    return _prefill_launch("flash_prefill", q, k_cache, v_cache, None, None,
                           starts, scale, softcap, window, slopes, prefix_len)


def flash_prefill_i8(q, k_cache, v_cache, k_scale, v_scale, starts,
                     scale: float, softcap: float = 0.0, window: int = 0,
                     slopes=None, prefix_len=None):
    """K3, int8 variant. Same contract as :func:`flash_prefill_i8_plain`."""
    if q.device.type == "cpu":
        return flash_prefill_i8_plain(q, k_cache, v_cache, k_scale, v_scale,
                                      starts, scale, softcap, window, slopes,
                                      prefix_len)
    q, starts = _prefill_args(q, k_cache, v_cache, starts, torch.int8)
    B, Hkv, S = k_cache.shape[:3]
    _check_scales(k_scale, v_scale, (B, Hkv, S))
    return _prefill_launch("flash_prefill_i8", q, k_cache, v_cache, k_scale,
                           v_scale, starts, scale / 127.0, softcap, window,
                           slopes, prefix_len)


def check_head_dim(Dh: int):
    if Dh not in HEAD_DIMS:
        raise ValueError(f"the attention kernels take head_dim "
                         f"{' or '.join(map(str, HEAD_DIMS))}, got {Dh}")


def _check_attention(q, k_cache, v_cache, Hq, Hkv, Dh, B, kv_dtype):
    check_head_dim(Dh)
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    S = k_cache.shape[2]
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        _cuda.check(c, name, kv_dtype, (B, Hkv, S, Dh))


def _check_scales(k_scale, v_scale, shape):
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        _cuda.check(s, name, torch.bfloat16, shape)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def attn_scale(cfg, Dh: int) -> float:
    return cfg.attn_scale if cfg.attn_scale is not None else Dh ** -0.5


def attn_options(cfg, T: int, slopes, prefix_len):
    """The ALiBi slopes and the prefix bound a launch takes: the slopes when
    the config uses ALiBi (then they must be given), the prefix bound for
    a prefill (T > 1) of a prefix-LM config."""
    if cfg.use_alibi and slopes is None:
        raise ValueError("an ALiBi config needs its slopes "
                         "(the model's alibi_slopes buffer)")
    return (slopes if cfg.use_alibi else None,
            prefix_len if cfg.prefix_lm and T > 1 else None)


def attend(q, k_cache, v_cache, positions, cfg, k_scale=None, v_scale=None,
           window: int = 0, slopes=None, prefix_len=None):
    """q [B, T, Hq, Dh] at ``positions`` [B, T] against one layer's cache
    [B, Hkv, S, Dh] (already holding these keys; int8 with ``k_scale`` /
    ``v_scale`` [B, Hkv, S]) → [B, T, Hq*Dh] f32. T == 1 goes to K4, T > 1
    to K3, each in the variant of the cache's dtype, with the config's
    softcap, this layer's sliding ``window`` (a Python int, 0 = off), the
    ALiBi ``slopes`` [Hq] of an ALiBi config and, for a prefix-LM config's
    prefill, the prompt lengths ``prefix_len`` [B]. A head dim that is not
    a multiple of 128 goes to :func:`attend_xla`, torch ops, as the JAX
    package's ``attend`` routes it (counted as the route
    ``attend_xla``)."""
    B, T, Hq, Dh = q.shape
    slopes, prefix_len = attn_options(cfg, T, slopes, prefix_len)
    int8 = k_cache.dtype == torch.int8
    if int8 != (k_scale is not None):
        raise ValueError("an int8 KV cache comes with its scales, a bf16 one "
                         "without")
    if Dh % 128:
        _cuda.ROUTES.count("attend_xla")
        return attend_xla(q, k_cache, v_cache, positions, cfg, k_scale,
                          v_scale, window, slopes, prefix_len)
    opts = (attn_scale(cfg, Dh), cfg.attn_softcap, window, slopes)
    if T == 1 and int8:
        out = flash_decode_i8(q[:, 0], k_cache, v_cache, k_scale, v_scale,
                              positions[:, 0] + 1, *opts)
    elif T == 1:
        out = flash_decode(q[:, 0], k_cache, v_cache, positions[:, 0] + 1,
                           *opts)
    elif int8:
        out = flash_prefill_i8(q, k_cache, v_cache, k_scale, v_scale,
                               positions[:, 0], *opts, prefix_len)
    else:
        out = flash_prefill(q, k_cache, v_cache, positions[:, 0], *opts,
                            prefix_len)
    return out.reshape(B, T, Hq * Dh)
