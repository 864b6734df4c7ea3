"""ctypes binding of the host-side codec ``native/ntpu_native.cpp`` (port of
``neural_tpu/native.py``).

The source is compiled unchanged on first use with ``g++ -O3 -shared
-fPIC -fopenmp`` into ``build/neural_tpu_torch/`` under a name that carries
its content hash (a changed source builds anew); the JAX package's
``native/libntpu_native.so`` is neither read nor written. Every entry point
here raises when no compiler or library is available (:func:`available`
says which).

The port quantizes with torch on the tensor's device (``core.qtensor.
quantize``), so no main path calls this codec: it is the multithreaded
host-side twin (reference analog: the BesTLA pack/quant driver,
core/layers/bestla_gemm.cpp) for tools that convert on the host.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

_ROOT = Path(__file__).resolve().parents[1]
SRC = _ROOT / "native" / "ntpu_native.cpp"
BUILD_DIR = _ROOT / "build" / "neural_tpu_torch"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libntpu_native-{h}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".tmp")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-fopenmp",
                        str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return False
    tmp.replace(out)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None when it cannot be."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not SRC.exists():
        return None
    path = lib_path()
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64, i32 = ctypes.c_int64, ctypes.c_int
    lib.rtn_quantize_f32.argtypes = [f32p, i64, i64, i32, i32, i32,
                                     u8p, f32p, u8p]
    lib.pack_plane_u8.argtypes = [u8p, i64, i64, i32, i32, u8p]
    lib.unpack_plane_u8.argtypes = [u8p, i64, i64, i32, i32, u8p]
    lib.dequant_q4_0.argtypes = [u8p, i64, f32p]
    lib.dequant_q8_0.argtypes = [u8p, i64, f32p]
    lib.ntpu_native_version.restype = ctypes.c_int
    lib.ntpu_native_threads.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return get_lib() is not None


def _need():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native codec could not be built from {SRC} "
                           "(g++ with OpenMP is needed)")
    return lib


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def rtn_quantize(w: np.ndarray, bits: int, group: int, sym: bool
                 ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """f32 [K, N] → (codes u8 [K, N], scales f32 [G, N], zeros u8 or
    None), the int path of ``core.qtensor.quantize``."""
    lib = _need()
    w = np.ascontiguousarray(w, np.float32)
    K, N = w.shape
    codes = np.empty((K, N), np.uint8)
    scales = np.empty((K // group, N), np.float32)
    zeros = None if sym or bits == 1 else np.empty((K // group, N), np.uint8)
    lib.rtn_quantize_f32(
        _ptr(w, ctypes.c_float), K, N, group, bits, 1 if sym else 0,
        _ptr(codes, ctypes.c_uint8), _ptr(scales, ctypes.c_float),
        _ptr(zeros, ctypes.c_uint8) if zeros is not None
        else ctypes.POINTER(ctypes.c_uint8)())
    return codes, scales, zeros


def pack_plane(vals: np.ndarray, p: int, chunk: int) -> np.ndarray:
    """``core.qtensor.pack_plane`` on the host: uint8 [K, N] → [K·p/8, N]."""
    lib = _need()
    vals = np.ascontiguousarray(vals, np.uint8)
    K, N = vals.shape
    out = np.empty((K * p // 8, N), np.uint8)
    lib.pack_plane_u8(_ptr(vals, ctypes.c_uint8), K, N, p, chunk,
                      _ptr(out, ctypes.c_uint8))
    return out


def unpack_plane(packed: np.ndarray, p: int, chunk: int) -> np.ndarray:
    """Inverse of :func:`pack_plane`: uint8 [K·p/8, N] → uint8 [K, N]."""
    lib = _need()
    packed = np.ascontiguousarray(packed, np.uint8)
    Kp, N = packed.shape
    K = Kp * 8 // p
    out = np.empty((K, N), np.uint8)
    lib.unpack_plane_u8(_ptr(packed, ctypes.c_uint8), K, N, p, chunk,
                        _ptr(out, ctypes.c_uint8))
    return out


def dequant_q4_0(blocks: np.ndarray, n: int) -> np.ndarray:
    """ggml Q4_0 block bytes → ``n`` f32 weights."""
    lib = _need()
    blocks = np.ascontiguousarray(blocks, np.uint8)
    out = np.empty(n, np.float32)
    lib.dequant_q4_0(_ptr(blocks, ctypes.c_uint8), n,
                     _ptr(out, ctypes.c_float))
    return out


def dequant_q8_0(blocks: np.ndarray, n: int) -> np.ndarray:
    """ggml Q8_0 block bytes → ``n`` f32 weights."""
    lib = _need()
    blocks = np.ascontiguousarray(blocks, np.uint8)
    out = np.empty(n, np.float32)
    lib.dequant_q8_0(_ptr(blocks, ctypes.c_uint8), n,
                     _ptr(out, ctypes.c_float))
    return out


def quantize_qtensor(w: np.ndarray, cfg, device="cpu"):
    """Host quantize and pack → the port's QTensor on ``device`` (int
    kinds, 1-8 bits; not at rest): the codec's twin of
    ``core.qtensor.quantize``."""
    from .core.qtensor import QTensor, pack_chunk, plane_shifts
    K, N = w.shape
    g = K if cfg.group_size == -1 else cfg.group_size
    if g > K:  # per-tensor clamp, the rule of core.qtensor.quantize
        g = K
        cfg = dataclasses.replace(cfg, group_size=K)
    codes, scales, zeros = rtn_quantize(w, cfg.bits, g, cfg.sym)
    chunk = pack_chunk(cfg, K)
    planes = tuple(
        torch.from_numpy(pack_plane(((codes >> shift) & ((1 << p) - 1))
                                    .astype(np.uint8), p, chunk)).to(device)
        for p, shift in plane_shifts(cfg.bits))
    return QTensor(planes, torch.from_numpy(scales).to(device),
                   None if zeros is None else torch.from_numpy(zeros).to(device),
                   None, cfg)
