"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled on first use, on the machine with the
card, by ``nvcc`` into a shared library with a plain C interface, and loaded
with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/neural_tpu_torch/<name>-<hash>.so <name>.cu

The library's file name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale one is never loaded. ``build_all``
starts one ``nvcc`` per source, all at once. Nothing here runs at import:
the CPU tests import every module of the port.

Every exported C function takes its pointers and the stream as
``void*`` and returns ``cudaGetLastError()``; :meth:`Kernel.call` raises
when that is not 0, so a refused launch never passes silently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "neural_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

P = ctypes.c_void_p
I = ctypes.c_int


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc): the port's kernels "
                           "are built on the machine with the card")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class Kernel:
    """One ``.cu`` source: its C functions' signatures, its loaded library,
    and ``launches``, the number of times its wrapper launched it."""

    def __init__(self, source: str, functions: Dict[str, Sequence]):
        self.source = source
        self.functions = functions
        self.launches = 0
        self._lib = None

    @property
    def name(self) -> str:
        return self.source[:-3]

    def lib_path(self) -> Path:
        h = hashlib.sha256((CSRC / self.source).read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def build_cmd(self):
        return [_nvcc(), *NVCC_FLAGS, "-o", str(self.lib_path()),
                str(CSRC / self.source)]

    def load(self):
        if self._lib is None:
            path = self.lib_path()
            if not path.exists():
                build_all([self])
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in self.functions.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args):
        err = getattr(self.load(), fn)(*args)
        if err != 0:
            raise RuntimeError(f"{self.source}:{fn} failed to launch: "
                               f"CUDA error {err}")


def build_all(kernels: Sequence[Kernel]) -> float:
    """Compile every kernel whose library is missing, one nvcc process per
    source, all started together. Returns the wall seconds it took."""
    t0 = time.time()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for k in kernels:
        if not k.lib_path().exists():
            procs.append((k, subprocess.Popen(
                k.build_cmd(), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    errors = []
    for k, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{k.source}: nvcc exit {p.returncode}\n{out}")
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return time.time() - t0


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None):
    """Device, dtype, contiguity and (optionally) shape checks a wrapper
    makes before it hands a pointer to a kernel."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


QMM4 = Kernel("qmm4_npack.cu", {
    # x, planes, scales, partial, out, M, K, N, group, out_f32, splits, stream
    "qmm4_npack": [P, P, P, P, P, I, I, I, I, I, I, P],
})
QMM_A8 = Kernel("qmm_a8.cu", {
    # x, x_f32, xq, sa, M, K, gd, stream
    "quantize_act_i8": [P, I, P, P, I, I, I, P],
    # xq, sa, planes, scales, out, M, K, N, gd, group, out_f32, stream
    "qmm_a8": [P, P, P, P, P, I, I, I, I, I, I, P],
})
FLASH_PREFILL = Kernel("flash_prefill.cu", {
    # q, k, v, starts, out, B, T, Hq, Hkv, S, scale, stream
    "flash_prefill": [P, P, P, P, P, I, I, I, I, I, ctypes.c_float, P],
})
FLASH_DECODE = Kernel("flash_decode.cu", {
    # q, k, v, lengths, part_o, part_ml, out, B, Hq, Hkv, S, n_split, scale,
    # stream
    "flash_decode": [P, P, P, P, P, P, P, I, I, I, I, I, ctypes.c_float, P],
})

KERNELS = (QMM4, QMM_A8, FLASH_PREFILL, FLASH_DECODE)
