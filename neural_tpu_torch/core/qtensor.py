"""Quantized weight container and round-to-nearest quantizer (PyTorch port
of ``neural_tpu/core/qtensor.py``).

A weight ``W`` of shape ``[K, N]`` (so the product is ``x @ W``) is stored as

- unsigned codes bit-plane packed along K, chunk-locally: one uint8 array per
  plane of 4, 2 or 1 bits (8-bit weights use one full-byte plane). Within
  each run of ``chunk`` K-values, sub-chunk ``c`` sits at bit offset ``p*c``;
- per-group scales ``[K // group_size, N]``;
- optional per-group uint8 zero-points (asymmetric);
- an optional K-permutation ``perm`` (GPTQ act-order).

:func:`to_native_packed` turns a 2-4 bit tensor into the at-rest layout the
port's kernels read: one uint8 plane ``[K/2, N]`` of centered int4 nibbles
and bf16 scales. Every entry point of the port converts once at load.

All pack/unpack arithmetic is integer shift/mask on torch tensors, so it
runs on whatever device holds the weights.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .dtypes import QuantConfig, bit_planes


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

    planes: Tuple[torch.Tensor, ...]   # packed code planes
    scales: torch.Tensor               # [G, N]
    zeros: Optional[torch.Tensor]      # [G, N], asym only
    perm: Optional[torch.Tensor]       # [K] act-order permutation or None
    cfg: QuantConfig

    @property
    def K(self) -> int:
        rows = self.planes[0].shape[-2]
        if self.cfg.native_pack:
            return rows * npack_codes_per_byte(self.cfg.bits)
        if self.cfg.kind.startswith("fp8"):
            return rows
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


def quantize(w: torch.Tensor, cfg: QuantConfig) -> QTensor:
    """Round-to-nearest quantization of ``w`` [K, N] → :class:`QTensor`,
    per K-group, symmetric or asymmetric, 2-8 bit int. ``torch.round``
    rounds half to even, as ``jnp.round`` does, and the scale arithmetic is
    the JAX package's op for op, so the codes agree bit for bit."""
    if cfg.kind != "int" or cfg.bits < 2:
        raise NotImplementedError(
            f"quantize({cfg.short_name()}): only 2-8 bit int kinds are "
            "ported; 1-bit, nf4/fp4 and fp8 come with the general dequant "
            "kernel in a later slice")
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
    # tensor divisors throughout: PyTorch's CUDA division by a Python scalar
    # multiplies by the reciprocal, which is not the IEEE quotient
    div = lambda a, d: a / torch.full_like(a, d)
    b = cfg.bits
    if cfg.sym:
        half = 1 << (b - 1)
        absmax = wg.abs().amax(dim=1)
        scales = div(absmax, half) + eps
        q = torch.clamp(torch.round(wg / scales[:, None, :]), -half, half - 1)
        codes = (q + half).to(torch.uint8).reshape(K, N)
        zeros = None
    else:
        maxq = (1 << b) - 1
        wmin = torch.clamp(wg.amin(dim=1), max=0.0)
        wmax = torch.clamp(wg.amax(dim=1), min=0.0)
        scales = div(wmax - wmin, maxq) + eps
        zp = torch.clamp(torch.round(-wmin / scales), 0, maxq)
        q = torch.clamp(torch.round(wg / scales[:, None, :]) + zp[:, None, :],
                        0, maxq)
        codes = q.to(torch.uint8).reshape(K, N)
        zeros = zp.to(torch.uint8)
    planes = pack_codes(codes, b, pack_chunk(cfg, K))
    return QTensor(planes, scales.to(cfg.scale_torch), zeros, None, cfg)


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


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Full-precision reconstruction [K, N], the oracle of every kernel."""
    cfg = qt.cfg
    if cfg.kind != "int" or cfg.bits < 2:
        raise NotImplementedError(
            f"dequantize({cfg.short_name()}): only 2-8 bit int kinds are "
            "ported")
    K, N = qt.shape
    g = qt.group_size
    if cfg.native_pack:
        codes = native_fields(qt.planes[0], cfg.bits)
        if cfg.sym:
            codes = codes + (1 << (cfg.bits - 1))
    else:
        codes = unpack_codes(qt.planes, cfg.bits, pack_chunk(cfg, K))
    if cfg.sym:
        vals = codes.to(torch.float32) - (1 << (cfg.bits - 1))
    else:
        zp = torch.repeat_interleave(qt.zeros.to(torch.float32), g, dim=0)
        vals = codes.to(torch.float32) - zp
    w = vals * torch.repeat_interleave(qt.scales.to(torch.float32), g, dim=0)
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
    zeros = qt.zeros
    if zeros is not None:
        zeros = (zeros.to(torch.float32) - shift).to(torch.bfloat16)
    return QTensor((plane.to(torch.uint8),), qt.scales.to(torch.bfloat16),
                   zeros, qt.perm, dataclasses.replace(cfg, native_pack=True))


def matmul_ref(x: torch.Tensor, qt: QTensor, dtype=None) -> torch.Tensor:
    """Oracle product ``x @ dequantize(qt)`` in f32. [*, K] @ [K, N]."""
    out = x.to(torch.float32) @ dequantize(qt, torch.float32)
    return out.to(dtype or x.dtype)
