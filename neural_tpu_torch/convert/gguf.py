"""GGUF file format: reader and writer (port of
``neural_tpu/convert/gguf.py``; host-side numpy file I/O, the port's own
copy).

This is a from-scratch implementation of the public GGUF v2/v3 spec: the
header, the key/value metadata, the tensor table, and tensor data read
lazily from an mmap. ggml block-quantized tensors (Q4_0/Q4_1/Q5_0/Q5_1/
Q8_0 and the K-quants Q2_K/Q3_K/Q4_K/Q5_K/Q6_K) unpack to codes, per-group
scales and (for the asymmetric types) additive mins
(:meth:`GGUFReader.unpack_quantized`); F32/F16/BF16 load as arrays. BF16
crosses as its uint16 bit pattern (numpy has no bf16 type): widened
exactly on reading, rounded to nearest even on writing. The writer packs
every one of those types from f32 (RTN), or takes pre-encoded block bytes
(:meth:`GGUFWriter.add_tensor_raw`).

The model-level loader, which moves each tensor's block bytes to the card
and unpacks them there, is :mod:`neural_tpu_torch.convert.gguf_models`.
"""
from __future__ import annotations

import mmap
import struct
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import numpy as np

GGUF_MAGIC = b"GGUF"

# gguf metadata value types (gguf.h:120)
T_U8, T_I8, T_U16, T_I16, T_U32, T_I32, T_F32, T_BOOL, T_STR, T_ARR, \
    T_U64, T_I64, T_F64 = range(13)

_SCALAR = {
    T_U8: "<B", T_I8: "<b", T_U16: "<H", T_I16: "<h", T_U32: "<I",
    T_I32: "<i", T_F32: "<f", T_BOOL: "<?", T_U64: "<Q", T_I64: "<q",
    T_F64: "<d",
}

# ggml tensor types (data_types.h:32-54 ne_type has the same ids)
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0 = 8
GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 10, 11, 12, 13, 14
GGML_I8, GGML_I16, GGML_I32 = 24, 25, 26
GGML_BF16 = 30

QK = 32     # ggml legacy quantization block size
QK_K = 256  # K-quant super-block size (data_types.h:125, block_q6_K :134)

_BLOCK_BYTES = {GGML_Q4_0: 2 + 16, GGML_Q4_1: 4 + 16, GGML_Q5_0: 2 + 4 + 16,
                GGML_Q5_1: 4 + 4 + 16, GGML_Q8_0: 2 + 32,
                # K-quants: super-blocks of 256
                GGML_Q2_K: 16 + 64 + 2 + 2,          # scales,qs,d,dmin = 84
                GGML_Q3_K: 32 + 64 + 12 + 2,         # hmask,qs,scales,d = 110
                GGML_Q4_K: 2 + 2 + 12 + 128,         # d,dmin,scales,qs = 144
                GGML_Q5_K: 2 + 2 + 12 + 32 + 128,    # + qh = 176
                GGML_Q6_K: 128 + 64 + 16 + 2}        # ql,qh,scales,d = 210

_BLOCK_ELEMS = {t: (QK_K if t in (GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K,
                                  GGML_Q6_K) else QK)
                for t in _BLOCK_BYTES}


def _unpack_scmin_k4(s: np.ndarray):
    """12 packed bytes → 8 six-bit scales + 8 six-bit mins per block.

    Layout (ggml get_scale_min_k4): bytes 0-3 low-6 = sc[0..3], bytes 4-7
    low-6 = mn[0..3]; bytes 8-11 nibbles + top-2 bits of bytes 0-7 hold
    sc/mn[4..7]. s: [nb, 12] uint8 → (sc [nb, 8], mn [nb, 8]) int32.
    """
    s = s.astype(np.int32)
    sc = np.empty((len(s), 8), np.int32)
    mn = np.empty_like(sc)
    sc[:, :4] = s[:, 0:4] & 63
    mn[:, :4] = s[:, 4:8] & 63
    sc[:, 4:] = (s[:, 8:12] & 0xF) | ((s[:, 0:4] >> 6) << 4)
    mn[:, 4:] = (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)
    return sc, mn


def _pack_scmin_k4(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_unpack_scmin_k4`: ([nb,8], [nb,8]) → [nb,12]."""
    out = np.empty((len(sc), 12), np.int32)
    out[:, 0:4] = (sc[:, :4] & 63) | ((sc[:, 4:] >> 4) << 6)
    out[:, 4:8] = (mn[:, :4] & 63) | ((mn[:, 4:] >> 4) << 6)
    out[:, 8:12] = (sc[:, 4:] & 0xF) | ((mn[:, 4:] & 0xF) << 4)
    return out.astype(np.uint8)


class GGUFTensor:
    def __init__(self, name, shape, ggml_type, offset):
        self.name = name
        self.shape = shape          # numpy order: (rows..., cols) = ne[::-1]
        self.ggml_type = ggml_type
        self.offset = offset

    def __repr__(self):
        return f"GGUFTensor({self.name}, {self.shape}, type={self.ggml_type})"


class GGUFReader:
    """Parses header/kv/tensor table; tensor data is read lazily from an
    mmap (reference: model_mmap util.h:183)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._pos = 0
        self.kv: Dict[str, Any] = {}
        self.tensors: Dict[str, GGUFTensor] = {}
        self._parse()

    # -- low-level readers --------------------------------------------------
    def _read(self, fmt):
        size = struct.calcsize(fmt)
        v = struct.unpack_from(fmt, self._mm, self._pos)[0]
        self._pos += size
        return v

    def _read_str(self) -> str:
        n = self._read("<Q")
        s = self._mm[self._pos:self._pos + n].decode("utf-8", errors="replace")
        self._pos += n
        return s

    def _read_value(self, t):
        if t in _SCALAR:
            return self._read(_SCALAR[t])
        if t == T_STR:
            return self._read_str()
        if t == T_ARR:
            et = self._read("<I")
            n = self._read("<Q")
            if et in _SCALAR:
                fmt = "<" + str(n) + _SCALAR[et][1]
                size = struct.calcsize(fmt)
                v = np.frombuffer(self._mm, dtype=np.dtype(_SCALAR[et][1:]),
                                  count=n, offset=self._pos).copy()
                self._pos += size
                return v
            return [self._read_value(et) for _ in range(n)]
        raise ValueError(f"bad gguf value type {t}")

    # -- header -------------------------------------------------------------
    def _parse(self):
        assert self._mm[:4] == GGUF_MAGIC, "not a GGUF file"
        self._pos = 4
        self.version = self._read("<I")
        assert self.version in (2, 3), f"gguf v{self.version} unsupported"
        n_tensors = self._read("<Q")
        n_kv = self._read("<Q")
        for _ in range(n_kv):
            key = self._read_str()
            t = self._read("<I")
            self.kv[key] = self._read_value(t)
        infos = []
        for _ in range(n_tensors):
            name = self._read_str()
            nd = self._read("<I")
            ne = [self._read("<Q") for _ in range(nd)]
            ttype = self._read("<I")
            off = self._read("<Q")
            infos.append((name, ne, ttype, off))
        align = int(self.kv.get("general.alignment", 32))
        data_start = (self._pos + align - 1) // align * align
        for name, ne, ttype, off in infos:
            shape = tuple(ne[::-1])  # ggml ne[0] is fastest → numpy reverses
            self.tensors[name] = GGUFTensor(name, shape, ttype,
                                            data_start + off)

    # -- tensor data ----------------------------------------------------------
    def tensor_bytes(self, t: GGUFTensor) -> memoryview:
        n = int(np.prod(t.shape))
        if t.ggml_type in _BLOCK_BYTES:
            nbytes = n // _BLOCK_ELEMS[t.ggml_type] * _BLOCK_BYTES[t.ggml_type]
        else:
            itemsize = {GGML_F32: 4, GGML_F16: 2, GGML_BF16: 2, GGML_I8: 1,
                        GGML_I16: 2, GGML_I32: 4}[t.ggml_type]
            nbytes = n * itemsize
        return memoryview(self._mm)[t.offset:t.offset + nbytes]

    def dequantize(self, name: str) -> np.ndarray:
        """Full-precision numpy array (row-major [out, in] like HF)."""
        t = self.tensors[name]
        raw = np.frombuffer(self.tensor_bytes(t), dtype=np.uint8).copy()
        n = int(np.prod(t.shape))
        tt = t.ggml_type
        if tt == GGML_F32:
            return raw.view(np.float32).reshape(t.shape).copy()
        if tt == GGML_F16:
            return raw.view(np.float16).astype(np.float32).reshape(t.shape)
        if tt == GGML_BF16:
            return (raw.view(np.uint16).astype(np.uint32) << 16).view(
                np.float32).reshape(t.shape)
        if tt == GGML_I32:
            return raw.view(np.int32).reshape(t.shape).copy()
        codes, d, m, g = self.unpack_quantized(name)
        w = codes.astype(np.float32) * np.repeat(d, g)
        if m is not None:
            w = w + np.repeat(m, g)
        return w.reshape(t.shape)

    def unpack_quantized(self, name: str):
        """→ (codes [n] int, scales [n/g] f32, mins [n/g] f32 or None, g).

        Semantics: ``w = codes * scales (+ mins)`` over groups of ``g``
        elements. Codes are ALREADY CENTERED for the sym types (Q4_0: q-8,
        Q5_0: q-16, Q8_0/Q6_K/Q3_K: signed). For K-quants the super-block
        scale structure (6-bit sub-scales × fp16 d/dmin) is folded into
        per-group f32 scales/mins here; g is 32 (legacy, Q4_K, Q5_K) or 16
        (Q2_K, Q3_K, Q6_K). Block layouts per ggml (data_types.h:80-140,
        block_q6_K :134; dequant loops vectors/cpu/quantize.h:956).
        """
        t = self.tensors[name]
        raw = np.frombuffer(self.tensor_bytes(t), dtype=np.uint8).copy()
        n = int(np.prod(t.shape))
        tt = t.ggml_type
        nb = n // _BLOCK_ELEMS[tt]
        blk = raw.reshape(nb, _BLOCK_BYTES[tt])

        def fp16(col):
            return blk[:, col:col + 2].copy().view(np.float16)[:, 0].astype(
                np.float32)

        if tt == GGML_Q4_0:
            d = fp16(0)
            q = blk[:, 2:18]
            lo, hi = q & 0xF, q >> 4
            codes = np.concatenate([lo, hi], 1).astype(np.int8) - 8
            return codes.reshape(-1), d, None, QK
        if tt == GGML_Q4_1:
            d, m = fp16(0), fp16(2)
            q = blk[:, 4:20]
            codes = np.concatenate([q & 0xF, q >> 4], 1).astype(np.int8)
            return codes.reshape(-1), d, m, QK
        if tt in (GGML_Q5_0, GGML_Q5_1):
            off = 2 if tt == GGML_Q5_0 else 4
            d = fp16(0)
            m = None if tt == GGML_Q5_0 else fp16(2)
            qh = blk[:, off:off + 4].copy().view(np.uint32)[:, 0]
            q = blk[:, off + 4:off + 20]
            lo = np.concatenate([q & 0xF, q >> 4], 1).astype(np.int16)
            hibits = ((qh[:, None] >> np.arange(32)[None, :]) & 1).astype(
                np.int16)
            codes = lo | (hibits << 4)
            if tt == GGML_Q5_0:
                codes = codes - 16
            return codes.reshape(-1), d, m, QK
        if tt == GGML_Q8_0:
            d = fp16(0)
            codes = blk[:, 2:34].view(np.int8)
            return codes.reshape(-1).copy(), d, None, QK
        if tt == GGML_Q2_K:
            # scales[16] (lo nibble: 4-bit scale, hi: 4-bit min), qs[64],
            # d, dmin. Element e = 128*chunk + 32*shift + l; group = e//16.
            sc = blk[:, :16].astype(np.int32)
            qs = blk[:, 16:80].astype(np.int32).reshape(nb, 2, 32)
            d, dmin = fp16(80), fp16(82)
            sh = (2 * np.arange(4))[None, None, :, None]
            codes = ((qs[:, :, None, :] >> sh) & 3).reshape(nb, QK_K)
            scales = (d[:, None] * (sc & 0xF)).reshape(-1)
            mins = (-dmin[:, None] * (sc >> 4)).reshape(-1)
            return codes.reshape(-1), scales, mins, 16
        if tt == GGML_Q3_K:
            # hmask[32], qs[64], scales[12] (16 packed 6-bit, signed -32),
            # d. 2-bit low code + (hmask bit ? 0 : -4) → centered -4..3.
            hm = blk[:, :32].astype(np.int32)
            qs = blk[:, 32:96].astype(np.int32).reshape(nb, 2, 32)
            sb = blk[:, 96:108].astype(np.int32)
            d = fp16(108)
            sh = (2 * np.arange(4))[None, None, :, None]
            low = (qs[:, :, None, :] >> sh) & 3                # [nb,2,4,32]
            bit = (4 * np.arange(2)[:, None, None]
                   + np.arange(4)[None, :, None])              # [2,4,1]
            h = (hm[:, None, None, :] >> bit[None]) & 1
            codes = (low - np.where(h != 0, 0, 4)).reshape(nb, QK_K)
            sc = np.empty((nb, 16), np.int32)
            sc[:, 0:4] = (sb[:, 0:4] & 0xF) | (((sb[:, 8:12] >> 0) & 3) << 4)
            sc[:, 4:8] = (sb[:, 4:8] & 0xF) | (((sb[:, 8:12] >> 2) & 3) << 4)
            sc[:, 8:12] = (sb[:, 0:4] >> 4) | (((sb[:, 8:12] >> 4) & 3) << 4)
            sc[:, 12:16] = (sb[:, 4:8] >> 4) | (((sb[:, 8:12] >> 6) & 3) << 4)
            scales = (d[:, None] * (sc - 32)).reshape(-1)
            return codes.reshape(-1), scales, None, 16
        if tt in (GGML_Q4_K, GGML_Q5_K):
            # d, dmin, scales[12] (8×6-bit scale + 8×6-bit min), [qh[32]],
            # qs[128]. Per 64-chunk: low nibbles = first 32, high = next 32.
            d, dmin = fp16(0), fp16(2)
            sc6, mn6 = _unpack_scmin_k4(blk[:, 4:16])
            off = 16 if tt == GGML_Q4_K else 48
            qs = blk[:, off:off + 128].astype(np.int32).reshape(nb, 4, 32)
            lo, hi = qs & 0xF, qs >> 4
            if tt == GGML_Q5_K:
                qh = blk[:, 16:48].astype(np.int32)
                c = np.arange(4)
                b1 = (qh[:, None, :] >> (2 * c)[None, :, None]) & 1
                b2 = (qh[:, None, :] >> (2 * c + 1)[None, :, None]) & 1
                lo, hi = lo + 16 * b1, hi + 16 * b2
            codes = np.stack([lo, hi], axis=2).reshape(nb, QK_K)
            scales = (d[:, None] * sc6).reshape(-1)
            mins = (-dmin[:, None] * mn6).reshape(-1)
            return codes.reshape(-1), scales, mins, QK
        if tt == GGML_Q6_K:
            # ql[128], qh[64], scales[16] int8, d; centered -32..31
            # (reference dequantize_row_q6_K, vectors/cpu/quantize.h:956).
            ql = blk[:, :128].astype(np.int32).reshape(nb, 2, 64)
            qh = blk[:, 128:192].astype(np.int32).reshape(nb, 2, 32)
            sc = blk[:, 192:208].view(np.int8).astype(np.int32)
            d = fp16(208)
            q1 = (ql[:, :, 0:32] & 0xF) | (((qh >> 0) & 3) << 4)
            q2 = (ql[:, :, 32:64] & 0xF) | (((qh >> 2) & 3) << 4)
            q3 = (ql[:, :, 0:32] >> 4) | (((qh >> 4) & 3) << 4)
            q4 = (ql[:, :, 32:64] >> 4) | (((qh >> 6) & 3) << 4)
            codes = np.stack([q1, q2, q3, q4], axis=2).reshape(nb, QK_K) - 32
            scales = (d[:, None] * sc).reshape(-1)
            return codes.reshape(-1), scales, None, 16
        raise ValueError(f"unsupported ggml type {tt}")

    def close(self):
        import gc
        gc.collect()  # release any lingering views into the mmap
        try:
            self._mm.close()
        except BufferError:
            pass  # a view escaped; the mmap dies with the process
        self._f.close()


# ---------------------------------------------------------------------------
# Writer (F32/F16/BF16 + ALL legacy ggml quant formats Q4_0/Q4_1/Q5_0/
# Q5_1/Q8_0 — the full set the reference's model_quantize emits,
# quant_utils.cpp:357 ggml_quantize — plus the FULL K-quant export set
# Q2_K/Q3_K/Q4_K/Q5_K/Q6_K, matching the reference's special K-quant
# quantize path, model_quantize_special quant_utils.h:39)
# ---------------------------------------------------------------------------


def _pack_q4_0(w: np.ndarray) -> bytes:
    """f32 [..] → ggml Q4_0 blocks (RTN per 32-block, llama.cpp layout)."""
    flat = w.reshape(-1, QK).astype(np.float32)
    absmax_idx = np.argmax(np.abs(flat), axis=1)
    maxval = flat[np.arange(len(flat)), absmax_idx]
    d = maxval / -8.0                              # ggml convention
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(np.round(flat * inv[:, None]) + 8, 0, 15).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    packed = (lo | (hi << 4)).astype(np.uint8)
    d16 = d.astype(np.float16).reshape(-1, 1).view(np.uint8)
    return np.concatenate([d16, packed], axis=1).tobytes()


def _f16col(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float16).reshape(-1, 1).view(np.uint8)


def _pack_q4_1(w: np.ndarray) -> bytes:
    """f32 → ggml Q4_1 (asym per 32-block: w = q*d + m)."""
    flat = w.reshape(-1, QK).astype(np.float32)
    mn = flat.min(axis=1)
    mx = flat.max(axis=1)
    d = (mx - mn) / 15.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(np.round((flat - mn[:, None]) * inv[:, None]), 0, 15) \
        .astype(np.uint8)
    packed = (q[:, :16] | (q[:, 16:] << 4)).astype(np.uint8)
    return np.concatenate([_f16col(d), _f16col(mn), packed],
                          axis=1).tobytes()


def _pack_q5_01(w: np.ndarray, asym: bool) -> bytes:
    """f32 → ggml Q5_0 (sym, d = signed-max/-16) or Q5_1 (asym)."""
    flat = w.reshape(-1, QK).astype(np.float32)
    if asym:
        mn = flat.min(axis=1)
        d = (flat.max(axis=1) - mn) / 31.0
        inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
        q = np.clip(np.round((flat - mn[:, None]) * inv[:, None]),
                    0, 31).astype(np.uint32)
    else:
        idx = np.argmax(np.abs(flat), axis=1)
        d = flat[np.arange(len(flat)), idx] / -16.0
        inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
        q = np.clip(np.round(flat * inv[:, None]) + 16, 0, 31) \
            .astype(np.uint32)
    qh = np.zeros(len(flat), np.uint32)
    for l in range(QK):                      # bit l = element l's 5th bit
        qh |= ((q[:, l] >> 4) & 1) << l
    lo = (q & 0xF).astype(np.uint8)
    packed = (lo[:, :16] | (lo[:, 16:] << 4)).astype(np.uint8)
    head = [_f16col(d)] + ([_f16col(mn)] if asym else [])
    return np.concatenate(head + [qh.view(np.uint8).reshape(-1, 4), packed],
                          axis=1).tobytes()


def _pack_q8_0(w: np.ndarray) -> bytes:
    """f32 → ggml Q8_0 (sym int8 per 32-block)."""
    flat = w.reshape(-1, QK).astype(np.float32)
    d = np.abs(flat).max(axis=1) / 127.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(np.round(flat * inv[:, None]), -127, 127).astype(np.int8)
    return np.concatenate([_f16col(d), q.view(np.uint8)], axis=1).tobytes()


def _pack_q6_k(w: np.ndarray) -> bytes:
    """f32 → ggml Q6_K super-blocks (RTN; 16 groups of 16, 6-bit codes ×
    int8 sub-scales × fp16 super-scale — block_q6_K data_types.h:134)."""
    flat = w.reshape(-1, QK_K).astype(np.float32)
    nb = len(flat)
    g = flat.reshape(nb, 16, 16)
    gscale = np.abs(g).max(axis=2) / 31.0                      # [nb, 16]
    d = gscale.max(axis=1) / 127.0                             # [nb]
    dsafe = np.where(d == 0, 1.0, d)
    sc = np.clip(np.round(gscale / dsafe[:, None]), 0, 127)    # [nb, 16]
    eff = d[:, None, None] * sc[:, :, None]
    q = np.clip(np.round(g / np.where(eff == 0, 1.0, eff)), -32, 31)
    L = (q.reshape(nb, QK_K) + 32).astype(np.int32)            # 0..63
    Lc = L.reshape(nb, 2, 128)                                 # 128-chunks
    ql = np.empty((nb, 2, 64), np.int32)
    # element pairing per dequant loop: ql[l] = L[l] | L[l+64]<<4,
    # ql[l+32] = L[l+32] | L[l+96]<<4; qh[l] packs the top 2 bits of all 4.
    ql[:, :, 0:32] = (Lc[:, :, 0:32] & 0xF) | ((Lc[:, :, 64:96] & 0xF) << 4)
    ql[:, :, 32:64] = (Lc[:, :, 32:64] & 0xF) | ((Lc[:, :, 96:128] & 0xF) << 4)
    qh = ((Lc[:, :, 0:32] >> 4) | ((Lc[:, :, 32:64] >> 4) << 2)
          | ((Lc[:, :, 64:96] >> 4) << 4) | ((Lc[:, :, 96:128] >> 4) << 6))
    blk = np.empty((nb, _BLOCK_BYTES[GGML_Q6_K]), np.uint8)
    blk[:, :128] = ql.reshape(nb, 128)
    blk[:, 128:192] = qh.reshape(nb, 64)
    blk[:, 192:208] = sc.astype(np.int8).view(np.uint8)
    blk[:, 208:210] = d.astype(np.float16).reshape(-1, 1).view(np.uint8)
    return blk.tobytes()


def _pack_q4_k(w: np.ndarray) -> bytes:
    """f32 → ggml Q4_K super-blocks (RTN; 8 groups of 32, 4-bit codes with
    6-bit sub-scale/min × fp16 d/dmin: w ≈ d·sc·q − dmin·m)."""
    flat = w.reshape(-1, QK_K).astype(np.float32)
    nb = len(flat)
    g = flat.reshape(nb, 8, 32)
    gmin = np.maximum(-g.min(axis=2), 0.0)                     # m ≥ 0
    gscale = np.maximum(g.max(axis=2) + gmin, 0.0) / 15.0      # s ≥ 0
    d = gscale.max(axis=1) / 63.0
    dmin = gmin.max(axis=1) / 63.0
    sc6 = np.clip(np.round(gscale / np.where(d == 0, 1, d)[:, None]), 0, 63)
    mn6 = np.clip(np.round(gmin / np.where(dmin == 0, 1, dmin)[:, None]),
                  0, 63)
    eff_s = d[:, None, None] * sc6[:, :, None]
    eff_m = dmin[:, None, None] * mn6[:, :, None]
    q = np.clip(np.round((g + eff_m) / np.where(eff_s == 0, 1.0, eff_s)),
                0, 15).astype(np.int32)
    qc = q.reshape(nb, 4, 64)                                  # 64-chunks
    qs = (qc[:, :, :32] | (qc[:, :, 32:] << 4)).reshape(nb, 128)
    blk = np.empty((nb, _BLOCK_BYTES[GGML_Q4_K]), np.uint8)
    blk[:, 0:2] = d.astype(np.float16).reshape(-1, 1).view(np.uint8)
    blk[:, 2:4] = dmin.astype(np.float16).reshape(-1, 1).view(np.uint8)
    blk[:, 4:16] = _pack_scmin_k4(sc6.astype(np.int32), mn6.astype(np.int32))
    blk[:, 16:144] = qs
    return blk.tobytes()


def _pack_q2_k(w: np.ndarray) -> bytes:
    """f32 → ggml Q2_K super-blocks (RTN; 16 groups of 16, 2-bit codes
    with 4-bit sub-scale/min × fp16 d/dmin: w ≈ d·sc·q − dmin·m).
    Exact inverse of the reader's Q2_K branch."""
    flat = w.reshape(-1, QK_K).astype(np.float32)
    nb = len(flat)
    g = flat.reshape(nb, 16, 16)
    gmin = np.maximum(-g.min(axis=2), 0.0)
    gscale = np.maximum(g.max(axis=2) + gmin, 0.0) / 3.0
    d = gscale.max(axis=1) / 15.0
    dmin = gmin.max(axis=1) / 15.0
    sc4 = np.clip(np.round(gscale / np.where(d == 0, 1, d)[:, None]), 0, 15)
    mn4 = np.clip(np.round(gmin / np.where(dmin == 0, 1, dmin)[:, None]),
                  0, 15)
    eff_s = d[:, None, None] * sc4[:, :, None]
    eff_m = dmin[:, None, None] * mn4[:, :, None]
    q = np.clip(np.round((g + eff_m) / np.where(eff_s == 0, 1.0, eff_s)),
                0, 3).astype(np.int32)
    # element e = 128*c + 32*s + l → qs[c*32 + l] bits 2s (reader order)
    qe = q.reshape(nb, 2, 4, 32)
    qs = (qe[:, :, 0] | (qe[:, :, 1] << 2) | (qe[:, :, 2] << 4)
          | (qe[:, :, 3] << 6)).reshape(nb, 64)
    blk = np.empty((nb, _BLOCK_BYTES[GGML_Q2_K]), np.uint8)
    blk[:, :16] = (sc4.astype(np.int32)
                   | (mn4.astype(np.int32) << 4)).astype(np.uint8)
    blk[:, 16:80] = qs.astype(np.uint8)
    blk[:, 80:82] = d.astype(np.float16).reshape(-1, 1).view(np.uint8)
    blk[:, 82:84] = dmin.astype(np.float16).reshape(-1, 1).view(np.uint8)
    return blk.tobytes()


def _pack_q3_k(w: np.ndarray) -> bytes:
    """f32 → ggml Q3_K super-blocks (RTN; 16 groups of 16, centered 3-bit
    codes −4..3 × signed 6-bit sub-scales × fp16 d). Exact inverse of the
    reader's Q3_K branch (hmask bit CLEAR ⇒ −4 offset)."""
    flat = w.reshape(-1, QK_K).astype(np.float32)
    nb = len(flat)
    g = flat.reshape(nb, 16, 16)
    # centered −4..3 codes: the positive side only reaches 3 steps
    gscale = np.maximum(g.max(axis=2) / 3.0, g.min(axis=2) / -4.0)
    gscale = np.maximum(gscale, 0.0)
    d = gscale.max(axis=1) / 31.0
    ssc = np.clip(np.round(gscale / np.where(d == 0, 1, d)[:, None]), 0, 31)
    eff = d[:, None, None] * ssc[:, :, None]
    q = np.clip(np.round(g / np.where(eff == 0, 1.0, eff)),
                -4, 3).astype(np.int32)
    L = (q.reshape(nb, QK_K) + 4)                   # 0..7
    low, hbit = L & 3, L >> 2
    le = low.reshape(nb, 2, 4, 32)
    qs = (le[:, :, 0] | (le[:, :, 1] << 2) | (le[:, :, 2] << 4)
          | (le[:, :, 3] << 6)).reshape(nb, 64)
    hb = hbit.reshape(nb, 2, 4, 32)                 # bit 4c+s of hmask[l]
    hm = np.zeros((nb, 32), np.int32)
    for c in range(2):
        for s in range(4):
            hm |= hb[:, c, s] << (4 * c + s)
    sc = (ssc + 32).astype(np.int32)                # stored 0..63
    sb = np.empty((nb, 12), np.int32)
    sb[:, 0:4] = (sc[:, 0:4] & 0xF) | ((sc[:, 8:12] & 0xF) << 4)
    sb[:, 4:8] = (sc[:, 4:8] & 0xF) | ((sc[:, 12:16] & 0xF) << 4)
    sb[:, 8:12] = ((sc[:, 0:4] >> 4) | ((sc[:, 4:8] >> 4) << 2)
                   | ((sc[:, 8:12] >> 4) << 4) | ((sc[:, 12:16] >> 4) << 6))
    blk = np.empty((nb, _BLOCK_BYTES[GGML_Q3_K]), np.uint8)
    blk[:, :32] = hm.astype(np.uint8)
    blk[:, 32:96] = qs.astype(np.uint8)
    blk[:, 96:108] = sb.astype(np.uint8)
    blk[:, 108:110] = d.astype(np.float16).reshape(-1, 1).view(np.uint8)
    return blk.tobytes()


def _pack_q5_k(w: np.ndarray) -> bytes:
    """f32 → ggml Q5_K super-blocks (Q4_K's 6-bit sc/min structure with
    5-bit codes; high bits in qh[32]). Exact inverse of the reader."""
    flat = w.reshape(-1, QK_K).astype(np.float32)
    nb = len(flat)
    g = flat.reshape(nb, 8, 32)
    gmin = np.maximum(-g.min(axis=2), 0.0)
    gscale = np.maximum(g.max(axis=2) + gmin, 0.0) / 31.0
    d = gscale.max(axis=1) / 63.0
    dmin = gmin.max(axis=1) / 63.0
    sc6 = np.clip(np.round(gscale / np.where(d == 0, 1, d)[:, None]), 0, 63)
    mn6 = np.clip(np.round(gmin / np.where(dmin == 0, 1, dmin)[:, None]),
                  0, 63)
    eff_s = d[:, None, None] * sc6[:, :, None]
    eff_m = dmin[:, None, None] * mn6[:, :, None]
    q = np.clip(np.round((g + eff_m) / np.where(eff_s == 0, 1.0, eff_s)),
                0, 31).astype(np.int32)
    qc = q.reshape(nb, 4, 2, 32)                    # [chunk, lo/hi, byte]
    qs = ((qc[:, :, 0] & 0xF) | ((qc[:, :, 1] & 0xF) << 4)).reshape(nb, 128)
    qh = np.zeros((nb, 32), np.int32)
    for c in range(4):
        qh |= (qc[:, c, 0] >> 4) << (2 * c)
        qh |= (qc[:, c, 1] >> 4) << (2 * c + 1)
    blk = np.empty((nb, _BLOCK_BYTES[GGML_Q5_K]), np.uint8)
    blk[:, 0:2] = d.astype(np.float16).reshape(-1, 1).view(np.uint8)
    blk[:, 2:4] = dmin.astype(np.float16).reshape(-1, 1).view(np.uint8)
    blk[:, 4:16] = _pack_scmin_k4(sc6.astype(np.int32), mn6.astype(np.int32))
    blk[:, 16:48] = qh.astype(np.uint8)
    blk[:, 48:176] = qs.astype(np.uint8)
    return blk.tobytes()


def bf16_bits(w: np.ndarray) -> np.ndarray:
    """f32 → the uint16 bit patterns of bf16, rounded to nearest even (a
    NaN stays a quiet NaN)."""
    b = np.ascontiguousarray(w, np.float32).view(np.uint32)
    rounded = (b + (((b >> 16) & 1) + 0x7FFF)) >> 16
    nan = np.isnan(np.ascontiguousarray(w, np.float32))
    return np.where(nan, (b >> 16) | 0x40, rounded).astype(np.uint16)


class GGUFWriter:
    def __init__(self, path: str, align: int = 32):
        self.path = path
        self.align = align
        self.kv: List[Tuple[str, int, Any]] = []
        self.tensors: List[Tuple[str, tuple, int, bytes]] = []

    def add_kv(self, key: str, value, vtype: Optional[int] = None):
        if vtype is None:
            if isinstance(value, bool):
                vtype = T_BOOL
            elif isinstance(value, int):
                vtype = T_U32 if value >= 0 else T_I32
            elif isinstance(value, float):
                vtype = T_F32
            elif isinstance(value, str):
                vtype = T_STR
            elif isinstance(value, (list, np.ndarray)):
                vtype = T_ARR
            else:
                raise TypeError(type(value))
        self.kv.append((key, vtype, value))

    def add_tensor(self, name: str, w: np.ndarray, ggml_type: int):
        if ggml_type == GGML_F32:
            data = w.astype(np.float32).tobytes()
        elif ggml_type == GGML_F16:
            data = w.astype(np.float16).tobytes()
        elif ggml_type == GGML_BF16:
            data = bf16_bits(w).tobytes()
        elif ggml_type == GGML_Q4_0:
            data = _pack_q4_0(w)
        elif ggml_type == GGML_Q4_1:
            data = _pack_q4_1(w)
        elif ggml_type == GGML_Q5_0:
            data = _pack_q5_01(w, asym=False)
        elif ggml_type == GGML_Q5_1:
            data = _pack_q5_01(w, asym=True)
        elif ggml_type == GGML_Q8_0:
            data = _pack_q8_0(w)
        elif ggml_type == GGML_Q2_K:
            data = _pack_q2_k(w)
        elif ggml_type == GGML_Q3_K:
            data = _pack_q3_k(w)
        elif ggml_type == GGML_Q4_K:
            data = _pack_q4_k(w)
        elif ggml_type == GGML_Q5_K:
            data = _pack_q5_k(w)
        elif ggml_type == GGML_Q6_K:
            data = _pack_q6_k(w)
        else:
            raise ValueError(ggml_type)
        self.tensors.append((name, w.shape, ggml_type, data))

    def add_tensor_raw(self, name: str, shape: tuple, ggml_type: int,
                       data: bytes):
        """Pre-encoded tensor payload (lossless repack of read blocks)."""
        self.tensors.append((name, tuple(shape), ggml_type, data))

    @staticmethod
    def _enc_str(s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<Q", len(b)) + b

    def _enc_value(self, vtype, v) -> bytes:
        if vtype in _SCALAR:
            return struct.pack(_SCALAR[vtype], v)
        if vtype == T_STR:
            return self._enc_str(v)
        if vtype == T_ARR:
            if isinstance(v, np.ndarray):
                et = {np.dtype(np.int32): T_I32, np.dtype(np.float32): T_F32,
                      np.dtype(np.uint32): T_U32,
                      np.dtype(np.int64): T_I64}[v.dtype]
                return (struct.pack("<IQ", et, len(v)) + v.tobytes())
            # list of strings
            out = struct.pack("<IQ", T_STR, len(v))
            return out + b"".join(self._enc_str(x) for x in v)
        raise ValueError(vtype)

    def write(self):
        with open(self.path, "wb") as f:
            f.write(GGUF_MAGIC)
            f.write(struct.pack("<IQQ", 3, len(self.tensors), len(self.kv)))
            for key, vtype, v in self.kv:
                f.write(self._enc_str(key))
                f.write(struct.pack("<I", vtype))
                f.write(self._enc_value(vtype, v))
            off = 0
            metas = []
            for name, shape, ttype, data in self.tensors:
                metas.append(off)
                off += (len(data) + self.align - 1) // self.align * self.align
            for (name, shape, ttype, data), toff in zip(self.tensors, metas):
                f.write(self._enc_str(name))
                ne = shape[::-1]
                f.write(struct.pack("<I", len(ne)))
                for d in ne:
                    f.write(struct.pack("<Q", d))
                f.write(struct.pack("<IQ", ttype, toff))
            pos = f.tell()
            pad = (pos + self.align - 1) // self.align * self.align - pos
            f.write(b"\0" * pad)
            for (name, shape, ttype, data), toff in zip(self.tensors, metas):
                f.write(data)
                pad = (len(data) + self.align - 1) // self.align * self.align \
                    - len(data)
                f.write(b"\0" * pad)
