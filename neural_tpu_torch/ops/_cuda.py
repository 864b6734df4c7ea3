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
when that is not 0, so a refused launch never passes silently, and counts
each launch under the C function's name (``Kernel.launches``), so a run
can tell which entry points — the bf16 and the int8 variant of an
attention kernel apart — its path went through. A launch that takes one
of an entry point's option branches (an attention kernel's ALiBi slopes or
prefix mask, a fused K1's prologue or epilogue, K5's route) also counts
under ``name+branch`` (``flash_prefill+alibi``, ``qmm4_npack_fused+rms``,
``qmm_general+gemv``), so a run can tell that its path went through the
branch too.
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
    """One ``.cu`` source: its C functions' signatures, the ``.cuh`` headers
    it includes, its loaded library, and ``launches``, the number of times
    each C function, and each of its option ``branches``, was launched."""

    def __init__(self, source: str, functions: Dict[str, Sequence],
                 headers: Sequence[str] = (), branches: Sequence[str] = ()):
        self.source = source
        self.functions = functions
        self.headers = tuple(headers)
        self.launches = {fn: 0 for fn in functions}
        self.launches.update({f"{fn}+{b}": 0 for fn in functions
                              for b in branches})
        self._lib = None

    @property
    def name(self) -> str:
        return self.source[:-3]

    def lib_path(self) -> Path:
        h = hashlib.sha256((CSRC / self.source).read_bytes())
        for header in self.headers:
            h.update((CSRC / header).read_bytes())
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

    def call(self, fn: str, *args, branches: Sequence[str] = ()):
        err = getattr(self.load(), fn)(*args)
        if err != 0:
            raise RuntimeError(f"{self.source}:{fn} failed to launch: "
                               f"CUDA error {err}")
        self.launches[fn] += 1
        for b in branches:
            self.launches[f"{fn}+{b}"] += 1


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


_TICKETS: Dict[tuple, torch.Tensor] = {}
_SMS: Dict[int, int] = {}


def _index(device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def sm_count(device) -> int:
    """The card's SM count (the schedules' wave size), read once."""
    idx = _index(device)
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def tickets(owner: str, device, n: int, cap: int) -> torch.Tensor:
    """``cap`` int32 ticket counters of one kernel family (``owner``) on
    ``device``, of which a launch uses the first ``n``: zeros made once per
    device, outside any graph capture (every caller launches eagerly
    first), and kept, so that a captured graph's pointer stays valid. A
    kernel that merges its splits in the last block to finish counts the
    blocks done on them and puts each counter back to 0 when its merge is
    done, so they are zeros between launches."""
    if n > cap:
        raise ValueError(f"{owner} takes at most {cap} ticket counters a "
                         f"launch, got {n}")
    idx = _index(device)
    if (owner, idx) not in _TICKETS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{owner}'s first launch on a device must "
                               "run eagerly, before any graph capture")
        _TICKETS[(owner, idx)] = torch.zeros(cap, dtype=torch.int32,
                                             device=device)
    return _TICKETS[(owner, idx)]


def refuse_grad(entry: str, *tensors):
    """Raise, naming the kernel entry, when autograd would record an op on
    any of ``tensors`` (grad mode on, a tensor that requires grad). No
    kernel of the port has a backward: it writes through raw pointers into
    a tensor without a ``grad_fn``, so a gradient upstream of it would
    vanish without an error. Every entry checks first, on every device, so
    that the training graph (``models.transformer.records_grad`` and its
    plain torch ops) is seen to keep off them on the CPU too."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.requires_grad:
            raise ValueError(
                f"{entry}: given a tensor that requires grad; the kernel has "
                "no backward (the training graph takes plain torch ops)")


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


# x, planes, scales, zeros, xs, partial, tickets, out, M, K, N, group,
# out_f32, splits, stream
_K1_ARGS = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]
F = ctypes.c_float
# the fused entries: x, u, norm_w, norm_f32, eps, offset, act, res, planes,
# scales, partial, tickets, out, M, K, N, group, out_f32, splits, stream
_K1_FUSED_ARGS = [P, P, P, I, F, F, I, P, P, P, P, P, P, I, I, I, I, I, I,
                  P]
K1_ENTRIES = ("qmm4_npack", "qmm2_npack", "qmm8_native")
# each fused launch also counts under the options it takes:
# ``qmm4_npack_fused+rms``, ``+glu``, ``+res``
QMM4 = Kernel("qmm4_npack.cu", {
    **{fn + asym: _K1_ARGS for fn in K1_ENTRIES for asym in ("", "_asym")},
    **{fn + "_fused": _K1_FUSED_ARGS for fn in K1_ENTRIES}},
    headers=("qmm_tc.cuh", "rms_row.cuh"), branches=("rms", "glu", "res"))
# K2's entry points per weight layout: native-pack nibbles (int4, and int3
# under the branch "int3"), native-pack int2 fields, int8 code planes
K2_ENTRIES = ("qmm_a8", "qmm_a8_int2", "qmm_a8_int8")
QMM_A8 = Kernel("qmm_a8.cu", {
    # x, x_f32, xq, sa, M, K, gd, stream
    "quantize_act_i8": [P, I, P, P, I, I, I, P],
    # xq, sa, planes, scales, out, M, K, N, gd, group, out_f32, stream
    **{fn: [P, P, P, P, P, I, I, I, I, I, I, P] for fn in K2_ENTRIES},
    # xq, sa, planes, scales, zwp, xsa, out, M, K, N, gd, group, out_f32,
    # stream
    **{fn + "_asym": [P, P, P, P, P, P, P, I, I, I, I, I, I, P]
       for fn in K2_ENTRIES},
}, headers=("qmm_tc.cuh",), branches=("int3",))
# K5's two routes, each launch also counted under its route: ``gemv`` at
# M <= 16, ``tc`` (the tensor-core tiles) above
QMM_GENERAL = Kernel("qmm_general.cu", {
    # x, plane0, plane1, plane2, scales, zeros, lut, partial, out, M, K, N,
    # group, chunk, fmt, bits, vmode, scale_f32, zkind, zconst, fp8_e5m2,
    # out_f32, splits, kps, stream
    "qmm_general": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I,
                    F, I, I, I, I, P],
}, headers=("qmm_tc.cuh",), branches=("gemv", "tc"))
FLASH_PREFILL = Kernel("flash_prefill.cu", {
    # q, k, v, starts, slopes, prefix_len, out, B, T, Hq, Hkv, S, head dim,
    # scale, softcap, window, stream
    "flash_prefill": [P, P, P, P, P, P, P, I, I, I, I, I, I, F, F, I, P],
    # the same over an f32 cache
    "flash_prefill_f32": [P, P, P, P, P, P, P, I, I, I, I, I, I, F, F, I,
                          P],
    # q, k8, v8, k_scale, v_scale, starts, slopes, prefix_len, out, B, T,
    # Hq, Hkv, S, head dim, scale / 127, softcap, window, stream
    "flash_prefill_i8": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, F,
                         I, P],
}, headers=("qmm_tc.cuh",), branches=("alibi", "prefix"))
# decode's branches: ALiBi slopes, and more than 8 query heads per KV head;
# K4 and K6 share one body (decode_body.cuh)
FLASH_DECODE = Kernel("flash_decode.cu", {
    # q, k, v, lengths, slopes, part_o, part_ml, tickets, out, B, Hq, Hkv,
    # S, n_split, chunk, head dim, scale, softcap, window, stream
    "flash_decode": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, F,
                     I, P],
    # the same over an f32 cache
    "flash_decode_f32": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F,
                         F, I, P],
    # q, k8, v8, k_scale, v_scale, then as flash_decode (scale / 127)
    "flash_decode_i8": [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                        F, F, I, P],
}, headers=("decode_body.cuh", "qmm_tc.cuh"), branches=("alibi", "G>8"))
PAGED_DECODE = Kernel("paged_decode.cu", {
    # q, k, v, table, lengths, slopes, part_o, part_ml, tickets, out, B, Hq,
    # Hkv, pages, page size, maxp, n_split, chunk, head dim, scale, softcap,
    # window, stream
    "paged_decode": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                     F, F, I, P],
    # the same over an f32 pool
    "paged_decode_f32": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                         I, I, F, F, I, P],
    # q, k8, v8, k_scale, v_scale, then as paged_decode (scale / 127)
    "paged_decode_i8": [P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                        I, I, I, F, F, I, P],
}, headers=("decode_body.cuh", "qmm_tc.cuh"), branches=("alibi", "G>8"))

# the unfused graph's RMS norm, on the row-scale routine of K1's fused rms
# prologue (``rms_row.cuh``), so that the two round alike
RMS_NORM = Kernel("rms_norm.cu", {
    # x, w, w_f32, eps, offset, out, M, K, stream
    "rms_norm_bf16": [P, P, I, F, F, P, I, I, P]},
    headers=("rms_row.cuh",))

KERNELS = (QMM4, QMM_A8, QMM_GENERAL, FLASH_PREFILL, FLASH_DECODE,
           PAGED_DECODE, RMS_NORM)


class Routes:
    """The torch-op routes the JAX package also computes outside any Pallas
    kernel, counted beside the kernels' launches so that a run can tell
    which of its products and attention calls took them: ``attend_xla``
    (attention at a head dim that is not a multiple of 128, in
    ``attend``), ``attend_xla_paged`` (the same in ``attend_paged``, after
    the page gather), ``act_order_gather`` (the gather of x by a GPTQ
    act-order ``perm`` before a quantized product), ``qmm_plain`` (a
    quantized product whose shape neither K1 nor K5 takes, dequantized
    and multiplied by one ``torch.mm``) and a mixture-of-experts layer's
    strategy, once a layer: ``moe_mixture`` (every expert on every row,
    its products through the kernels), ``moe_grouped`` (the expert-sorted
    row groups, one ``torch.mm`` a group, sizes read on the host) and
    ``moe_grouped_static`` (the same at a fixed capacity a group, the form
    a CUDA graph captures); and a sharded model's collectives, once a
    call: ``tp_all_reduce`` (the sums after wo, w_down and the experts'
    mixture), ``tp_all_gather`` (the lm_head's vocabulary slices),
    ``dp_all_gather`` (each dp rank's ids) and ``ep_all_to_all`` (the
    expert dispatch and combine), and every other ``<axis>_<collective>``
    of the mesh (``sp_ppermute``: a ring hop's K, V or positions;
    ``pp_ppermute``: a pipeline tick's activations; the gradient sums over
    the axes a leaf is replicated on); and the cache-less attention, once a
    layer: ``attend_nocache`` (one device) or ``ring_attend`` (over sp)."""

    def __init__(self, names: Sequence[str]):
        self.launches = {n: 0 for n in names}

    def count(self, name: str):
        self.launches[name] += 1


MESH_AXES = ("dp", "tp", "ep", "sp", "pp")
COLLECTIVES = ("all_reduce", "all_gather", "all_to_all", "ppermute")
ROUTES = Routes(("attend_xla", "attend_xla_paged", "act_order_gather",
                 "qmm_plain", "moe_mixture", "moe_grouped",
                 "moe_grouped_static", "attend_nocache", "ring_attend")
                + tuple(f"{a}_{c}" for a in MESH_AXES for c in COLLECTIVES))
COUNTED = KERNELS + (ROUTES,)


def reset_launches():
    """Set every launch count, and every route count, to 0."""
    for k in COUNTED:
        for fn in k.launches:
            k.launches[fn] = 0


def launch_counts() -> Dict[str, int]:
    """Launches per C function name (and ``name+branch``), over every
    kernel source, and the count of each torch-op route."""
    return {fn: n for k in COUNTED for fn, n in k.launches.items()}


def capture(graph, fn):
    """Capture ``fn()`` into the CUDA graph ``graph``; return its output
    and the launches the capture recorded. A capture executes nothing, so
    those launches are taken back out of the counts; :func:`add_launches`
    puts them in again at each replay, where the kernels do run."""
    before = launch_counts()
    with torch.cuda.graph(graph):
        out = fn()
    recorded = {fn_: n - before[fn_] for fn_, n in launch_counts().items()
                if n != before[fn_]}
    add_launches(recorded, -1)
    return out, recorded


_OWNER = {fn: k for k in COUNTED for fn in k.launches}


def add_launches(recorded: Dict[str, int], times: int = 1):
    """Count ``times`` replays of a graph whose capture recorded
    ``recorded``."""
    for fn, n in recorded.items():
        _OWNER[fn].launches[fn] += times * n
