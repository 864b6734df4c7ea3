"""Quantized weight container and round-to-nearest quantizer (PyTorch port
of ``neural_tpu/core/qtensor.py``).

A weight ``W`` of shape ``[K, N]`` (so the product is ``x @ W``) is stored as

- unsigned codes bit-plane packed along K, chunk-locally: one uint8 array per
  plane of 4, 2 or 1 bits (8-bit weights use one full-byte plane). Within
  each run of ``chunk`` K-values, sub-chunk ``c`` sits at bit offset ``p*c``;
  nf4/fp4 store 4-bit table indices the same way; fp8 kinds store the values
  themselves as one ``torch.float8_e4m3fn`` or ``torch.float8_e5m2`` plane;
- per-group scales ``[K // group_size, N]``;
- optional per-group zero-points (asymmetric): uint8, or float (GGUF Q4_1
  style, and the shifted bf16 zero-points of the at-rest layouts);
- an optional K-permutation ``perm`` (GPTQ act-order).

The at-rest layouts the port's kernels read, made once at load by
:func:`to_native` (``runtime.generate.params_to_native``):

- 2-4 bit int → native-pack (:func:`to_native_packed`): one uint8 plane of
  centered two's-complement fields, two nibbles a byte (four 2-bit fields a
  byte for int2), LSB first;
- 5-8 bit int → one ``torch.int8`` plane ``[K, N]`` of centered codes;

both with bf16 scales and zero-points shifted like the codes. 1-bit,
nf4/fp4 and fp8 weights stay in their stored layout with their scales.

All pack/unpack arithmetic is integer shift/mask on torch tensors, so it
runs on whatever device holds the weights.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .dtypes import QuantConfig, bit_planes

FP8_DTYPES = {"fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}
FP8_MAX = {"fp8_e4m3": 448.0, "fp8_e5m2": 57344.0}


def pack_plane(vals: torch.Tensor, p: int, chunk: int) -> torch.Tensor:
    """Pack ``p``-bit values (uint8 [K, N], each < 2**p) into uint8
    [K*p//8, N], chunk-locally: value k = g*chunk + c*sub + r lives in byte
    row g*sub + r at bit offset p*c."""
    if p == 8:
        return vals.to(torch.uint8)
    per_byte = 8 // p
    K, N = vals.shape
    if K % chunk or chunk % per_byte:
        raise ValueError(f"K={K} does not split into chunks of {chunk}")
    sub = chunk // per_byte
    v = vals.reshape(K // chunk, per_byte, sub, N).to(torch.int32)
    out = torch.zeros((K // chunk, sub, N), dtype=torch.int32,
                      device=vals.device)
    for c in range(per_byte):
        out = out | (v[:, c] << (p * c))
    return out.reshape(K // per_byte, N).to(torch.uint8)


def unpack_plane(packed: torch.Tensor, p: int, chunk: int) -> torch.Tensor:
    """Inverse of :func:`pack_plane`: uint8 [K*p//8, N] → int32 [K, N]."""
    if p == 8:
        return packed.to(torch.int32)
    per_byte = 8 // p
    sub = chunk // per_byte
    Kp, N = packed.shape
    b = packed.to(torch.int32).reshape(Kp // sub, sub, N)
    mask = (1 << p) - 1
    parts = [(b >> (p * c)) & mask for c in range(per_byte)]
    return torch.stack(parts, dim=1).reshape(Kp * per_byte, N)


def plane_shifts(bits: int) -> Tuple[Tuple[int, int], ...]:
    """((plane_width, left_shift), ...) so code = sum(plane << shift)."""
    shifts = []
    rem = bits
    for p in bit_planes(bits):
        rem -= p
        shifts.append((p, rem))
    return tuple(shifts)


def pack_codes(codes: torch.Tensor, bits: int,
               chunk: int) -> Tuple[torch.Tensor, ...]:
    """Split unsigned codes [K, N] (< 2**bits) into packed plane arrays."""
    codes = codes.to(torch.int32)
    return tuple(pack_plane((codes >> shift) & ((1 << p) - 1), p, chunk)
                 for p, shift in plane_shifts(bits))


def unpack_codes(planes: Tuple[torch.Tensor, ...], bits: int,
                 chunk: int) -> torch.Tensor:
    """Rebuild unsigned codes int32 [K, N] from packed plane arrays."""
    code = None
    for arr, (p, shift) in zip(planes, plane_shifts(bits)):
        part = unpack_plane(arr, p, chunk) << shift
        code = part if code is None else code | part
    return code


def npack_codes_per_byte(bits: int) -> int:
    """Codes per byte in the native-pack layout: four 2-bit fields, else two
    nibbles (3-bit codes ride in a nibble)."""
    return 4 if bits == 2 else 2


def pack_chunk(cfg: QuantConfig, K: int) -> int:
    """Chunk-locality of the bit-plane packing: the scale group size, or a
    fixed 32 for per-channel quantization."""
    if cfg.group_size == -1:
        return 32 if K % 32 == 0 else K
    return cfg.group_size


@dataclasses.dataclass
class QTensor:
    """A quantized ``[K, N]`` weight: tensors plus a static config."""

    planes: Tuple[torch.Tensor, ...]   # packed code planes (or fp8 data)
    scales: torch.Tensor               # [G, N]
    zeros: Optional[torch.Tensor]      # [G, N], asym only
    perm: Optional[torch.Tensor]       # [K] act-order permutation or None
    cfg: QuantConfig

    @property
    def K(self) -> int:
        rows = self.planes[0].shape[-2]
        if self.cfg.kind.startswith("fp8") or \
                self.planes[0].dtype == torch.int8:
            return rows
        if self.cfg.native_pack:
            return rows * npack_codes_per_byte(self.cfg.bits)
        p0 = bit_planes(self.cfg.bits)[0]
        return rows * (8 // p0) if p0 != 8 else rows

    @property
    def N(self) -> int:
        return self.planes[0].shape[-1]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.K, self.N)

    @property
    def group_size(self) -> int:
        g = self.cfg.group_size
        return self.K if g == -1 else g

    def nbytes(self) -> int:
        """Bytes of planes and scales, plus one per zero-point — the JAX
        package's count, which takes every zero-point as one byte."""
        tot = sum(p.numel() * p.element_size() for p in self.planes)
        tot += self.scales.numel() * self.scales.element_size()
        if self.zeros is not None:
            tot += self.zeros.numel()
        return tot


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """``a / d`` as the IEEE quotient: PyTorch's CUDA division by a Python
    scalar multiplies by the reciprocal, so the divisor is a tensor."""
    return a / torch.full_like(a, d)


def _xla_sum(a: torch.Tensor) -> torch.Tensor:
    """``a.sum(dim=1)`` of [G, g, N] in the order XLA's CPU reduction takes
    (measured against jax 0.9 for g a multiple of 32), so that the 1-bit
    scales are the JAX package's bit for bit: rows are added in order
    within runs of 32, and the run sums the same way, level by level."""
    while a.shape[1] > 1:
        runs = []
        for r0 in range(0, a.shape[1], 32):
            run = a[:, r0]
            for i in range(r0 + 1, min(r0 + 32, a.shape[1])):
                run = run + a[:, i]
            runs.append(run)
        a = torch.stack(runs, dim=1)
    return a[:, 0]


_LUTS = {}


def lut_on(cfg: QuantConfig, device) -> torch.Tensor:
    """The nf4/fp4 table of ``cfg`` on ``device``, copied there once: a copy
    from the host cannot run inside a CUDA graph capture."""
    key = (cfg.kind, torch.device(device))
    if key not in _LUTS:
        _LUTS[key] = cfg.lut.to(device)
    return _LUTS[key]


# nf4/fp4 find each weight's nearest table entry through a [G, g, n, 16]
# distance tensor; N is cut into slices whose tensor stays near this size
_LUT_SLICE_BYTES = 1 << 28


def _lut_codes(wg: torch.Tensor, absmax: torch.Tensor,
               lut: torch.Tensor) -> torch.Tensor:
    """Index of the nearest LUT entry of ``wg / absmax`` (first one on a
    tie, as ``jnp.argmin``), uint8 [G, g, N]; per element, so slicing N
    changes nothing."""
    G, g, N = wg.shape
    step = max(1, _LUT_SLICE_BYTES // (G * g * 16 * 4))
    out = []
    for n0 in range(0, N, step):
        normed = wg[:, :, n0:n0 + step] / absmax[:, None, n0:n0 + step]
        d = (normed[..., None] - lut).abs()
        out.append(torch.argmin(d, dim=-1).to(torch.uint8))
    return torch.cat(out, dim=2)


def quantize(w: torch.Tensor, cfg: QuantConfig) -> QTensor:
    """Round-to-nearest quantization of ``w`` [K, N] → :class:`QTensor`,
    per K-group: 1-8 bit int (sym or asym), nf4/fp4 and fp8. ``torch.round``
    rounds half to even, as ``jnp.round`` does, and the arithmetic is the
    JAX package's op for op, so planes, scales and zero-points agree bit
    for bit."""
    w = w.to(torch.float32)
    K, N = w.shape
    g = K if cfg.group_size == -1 else cfg.group_size
    if g > K:
        # per-tensor clamp: the QTensor records the group actually used
        g = K
        cfg = dataclasses.replace(cfg, group_size=K)
    if K % g:
        raise ValueError(f"K={K} not divisible by group_size={g}")
    wg = w.reshape(K // g, g, N)
    eps = 1e-9

    if cfg.kind == "int":
        b = cfg.bits
        zeros = None
        if b == 1:
            # codes {0, 1} → {-1, +1} · scale, scale = mean |w| per group
            # (the sum times the f32 reciprocal of g, as jnp.mean)
            one = torch.ones((), device=w.device)
            scales = _xla_sum(wg.abs()) * (one / (one * g)) + eps
            codes = (wg >= 0).to(torch.uint8).reshape(K, N)
        elif cfg.sym:
            half = 1 << (b - 1)
            absmax = wg.abs().amax(dim=1)
            scales = _div(absmax, half) + eps
            q = torch.clamp(torch.round(wg / scales[:, None, :]), -half,
                            half - 1)
            codes = (q + half).to(torch.uint8).reshape(K, N)
        else:
            maxq = (1 << b) - 1
            wmin = torch.clamp(wg.amin(dim=1), max=0.0)
            wmax = torch.clamp(wg.amax(dim=1), min=0.0)
            scales = _div(wmax - wmin, maxq) + eps
            zp = torch.clamp(torch.round(-wmin / scales), 0, maxq)
            q = torch.clamp(torch.round(wg / scales[:, None, :])
                            + zp[:, None, :], 0, maxq)
            codes = q.to(torch.uint8).reshape(K, N)
            zeros = zp.to(torch.uint8)
        planes = pack_codes(codes, b, pack_chunk(cfg, K))
        return QTensor(planes, scales.to(cfg.scale_torch), zeros, None, cfg)

    if cfg.kind in ("nf4", "fp4"):
        absmax = wg.abs().amax(dim=1) + eps
        codes = _lut_codes(wg, absmax, lut_on(cfg, w.device)).reshape(K, N)
        planes = pack_codes(codes, 4, pack_chunk(cfg, K))
        return QTensor(planes, absmax.to(cfg.scale_torch), None, None, cfg)

    if cfg.kind in FP8_DTYPES:
        absmax = wg.abs().amax(dim=1) + eps
        scales = _div(absmax, FP8_MAX[cfg.kind])
        data = (wg / scales[:, None, :]).reshape(K, N) \
            .to(FP8_DTYPES[cfg.kind])
        return QTensor((data,), scales.to(cfg.scale_torch), None, None, cfg)

    raise ValueError(cfg.kind)


def centered_codes(qt: QTensor) -> torch.Tensor:
    """Unsigned codes → signed values int8 [K, N]: code - 2^(b-1) for sym
    int, 2·code - 1 for 1-bit; asym codes stay biased by their zero-point
    (:func:`dequantize` subtracts it)."""
    if qt.cfg.kind != "int":
        raise ValueError(f"centered_codes of a {qt.cfg.kind} tensor")
    codes = unpack_codes(qt.planes, qt.cfg.bits, pack_chunk(qt.cfg, qt.K))
    b = qt.cfg.bits
    if b == 1:
        return codes.to(torch.int8) * 2 - 1
    if qt.cfg.sym:
        return codes.to(torch.int8) - (1 << (b - 1))
    return codes.to(torch.int8)


def native_fields(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Sign-extend the centered fields of a native-pack plane [K/cpb, N] →
    int32 [K, N] (LSB field first)."""
    b = packed.to(torch.int32)
    if bits == 2:
        fields = [(((b >> s) & 0x3) ^ 2) - 2 for s in (0, 2, 4, 6)]
    else:
        fields = [((b & 0xF) ^ 8) - 8, (((b >> 4) & 0xF) ^ 8) - 8]
    rows, N = packed.shape
    return torch.stack(fields, dim=1).reshape(rows * len(fields), N)


def is_native(qt: QTensor) -> bool:
    """At rest for the decode kernel (K1): int8 code planes or native-pack."""
    return qt.planes[0].dtype == torch.int8 or qt.cfg.native_pack


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Full-precision reconstruction [K, N], the oracle of every kernel."""
    cfg = qt.cfg
    K, N = qt.shape
    g = qt.group_size
    scales = torch.repeat_interleave(qt.scales.to(torch.float32), g, dim=0)
    if cfg.kind == "int":
        if qt.planes[0].dtype == torch.int8:
            codes = qt.planes[0].to(torch.int32)
            if cfg.sym:
                codes = codes + (1 << (cfg.bits - 1))   # back to unsigned
        elif cfg.native_pack:
            codes = native_fields(qt.planes[0], cfg.bits)
            if cfg.sym:
                codes = codes + (1 << (cfg.bits - 1))
        else:
            codes = unpack_codes(qt.planes, cfg.bits, pack_chunk(cfg, K))
        if cfg.bits == 1:
            vals = codes.to(torch.float32) * 2.0 - 1.0
        elif cfg.sym:
            vals = codes.to(torch.float32) - (1 << (cfg.bits - 1))
        else:
            zp = torch.repeat_interleave(qt.zeros.to(torch.float32), g, dim=0)
            vals = codes.to(torch.float32) - zp
        w = vals * scales
    elif cfg.kind in ("nf4", "fp4"):
        codes = unpack_codes(qt.planes, 4, pack_chunk(cfg, K))
        w = lut_on(cfg, codes.device)[codes.long()] * scales
    elif cfg.kind in FP8_DTYPES:
        w = qt.planes[0].to(torch.float32) * scales
    else:
        raise ValueError(cfg.kind)
    if qt.perm is not None:
        # stored rows are in act-order; undo it
        w = w[torch.argsort(qt.perm)]
    return w.to(dtype)


def to_native_packed(qt: QTensor) -> QTensor:
    """Convert a 2-4 bit packed int QTensor to the at-rest layout: a uint8
    plane [K/2, N] of centered two's-complement nibbles (code 2r low, code
    2r+1 high) — or [K/4, N] of 2-bit fields for int2 — with bf16 scales and
    zero-points shifted like the codes. Already-converted tensors pass
    through."""
    cfg = qt.cfg
    if cfg.native_pack:
        return qt
    if cfg.kind != "int" or not 2 <= cfg.bits <= 4:
        raise NotImplementedError(
            f"to_native_packed({cfg.short_name()}): the native-pack layout "
            "holds 2-4 bit int codes")
    shift = 1 << (cfg.bits - 1)
    codes = unpack_codes(qt.planes, cfg.bits, pack_chunk(cfg, qt.K))
    if cfg.bits == 2:
        f = (codes - shift) & 0x3
        plane = f[0::4] | (f[1::4] << 2) | (f[2::4] << 4) | (f[3::4] << 6)
    else:
        nib = (codes - shift) & 0xF
        plane = nib[0::2] | (nib[1::2] << 4)
    return QTensor((plane.to(torch.uint8),), qt.scales.to(torch.bfloat16),
                   _shift_zeros(qt.zeros, shift), qt.perm,
                   dataclasses.replace(cfg, native_pack=True))


def _shift_zeros(zeros: Optional[torch.Tensor], shift: int):
    """Zero-points (uint8 or float) moved by the codes' shift, as bf16."""
    if zeros is None:
        return None
    return (zeros.to(torch.float32) - shift).to(torch.bfloat16)


def to_native(qt: QTensor) -> QTensor:
    """The at-rest layout of an int QTensor: native-pack for 2-4 bit
    (:func:`to_native_packed`; the JAX package's ``jnp.int4`` planes hold
    the same centered values, and torch has no int4), and for 5-8 bit one
    int8 plane of centered codes ``code - 2^(bits-1)`` with bf16 scales and
    zero-points shifted by the same amount, so (c-S) - (z-S) = c - z.
    1-bit, nf4/fp4, fp8 and already-converted tensors pass through."""
    cfg = qt.cfg
    if cfg.kind != "int" or cfg.bits < 2 or is_native(qt):
        return qt
    if cfg.bits <= 4:
        return to_native_packed(qt)
    shift = 1 << (cfg.bits - 1)
    codes = unpack_codes(qt.planes, cfg.bits, pack_chunk(cfg, qt.K))
    return QTensor(((codes - shift).to(torch.int8),),
                   qt.scales.to(torch.bfloat16), _shift_zeros(qt.zeros, shift),
                   qt.perm, cfg)


def concat_n(qts) -> QTensor:
    """Concatenate QTensors along N (output features), once at load: the
    fused q|k|v and gate|up projections. Every input shares the config and
    K; act-order tensors fuse only with the same K-permutation (GPTQ
    quantizes same-input projections against one Hessian, so their g_idx
    match), and the fused product then gathers x once instead of once per
    projection."""
    first = qts[0]
    if any(q.cfg != first.cfg for q in qts):
        raise ValueError("concat_n: mixed quant configs")
    if any(q.K != first.K for q in qts):
        raise ValueError("concat_n: mixed K")
    if first.perm is not None:
        if not all(q.perm is not None and torch.equal(q.perm, first.perm)
                   for q in qts):
            raise ValueError("concat_n: act-order tensors need matching "
                             "perms")
    elif any(q.perm is not None for q in qts):
        raise ValueError("concat_n: act-order and plain tensors can't fuse")
    planes = tuple(torch.cat([q.planes[i] for q in qts], dim=-1)
                   for i in range(len(first.planes)))
    scales = torch.cat([q.scales for q in qts], dim=-1)
    zeros = None if first.zeros is None else \
        torch.cat([q.zeros for q in qts], dim=-1)
    return QTensor(planes, scales, zeros, first.perm, first.cfg)


def matmul_ref(x: torch.Tensor, qt: QTensor, dtype=None) -> torch.Tensor:
    """Oracle product ``x @ dequantize(qt)`` in f32. [*, K] @ [K, N]."""
    out = x.to(torch.float32) @ dequantize(qt, torch.float32)
    return out.to(dtype or x.dtype)


def stack_qtensors(qts) -> QTensor:
    """QTensors of one config and shape → one QTensor whose every tensor has
    a leading axis: a layer's ``[E, ...]`` expert stack, the layout of the
    JAX package's per-layer expert slice. Expert ``e`` is
    :func:`qtensor_at` ``(stack, e)``, a contiguous view."""
    first = qts[0]
    if any(q.cfg != first.cfg for q in qts):
        raise ValueError("stack_qtensors: mixed quant configs")
    opt = lambda f: None if getattr(first, f) is None else \
        torch.stack([getattr(q, f) for q in qts])
    planes = tuple(torch.stack([q.planes[i] for q in qts])
                   for i in range(len(first.planes)))
    return QTensor(planes, torch.stack([q.scales for q in qts]),
                   opt("zeros"), opt("perm"), first.cfg)


def qtensor_at(qt: QTensor, e: int) -> QTensor:
    """Entry ``e`` of a stacked QTensor (:func:`stack_qtensors`): views of
    its tensors, each contiguous, so a kernel takes it as a dense weight."""
    opt = lambda t: None if t is None else t[e]
    return QTensor(tuple(p[e] for p in qt.planes), qt.scales[e],
                   opt(qt.zeros), opt(qt.perm), qt.cfg)


def unstack_qtensor(qt: QTensor):
    """A stacked QTensor → the list of its entries."""
    return [qtensor_at(qt, e) for e in range(qt.scales.shape[0])]
