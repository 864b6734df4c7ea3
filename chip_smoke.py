"""Smoke run of the PyTorch / CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi), and a measured
   device-to-device copy rate;
2. build: the kernels of ``neural_tpu_torch/csrc`` from source, one nvcc
   per source, all at once;
3. kernels: each kernel (K1 at M=1 and 8, K2, K3 and K4 in their bf16
   and int8 variants, K6 paged decode in both) against its plain PyTorch
   version on the same CUDA tensors at the Llama-2-7B q4_j main-path
   shapes, with its time, the plain version's time, one library call's
   time (a yardstick the port never calls) and its bound; then K5 (nf4 at
   M=1 and 1975, q4_0 at 1975, q4_j at 128, 64, 32 and 24, fp4, fp8
   e4m3/e5m2, int1 and bit-plane int3 asym at 1), K1's other entry points
   (asym nibbles, int2 and int8 codes, sym and asym) at M=1 and 8, and
   K2-asym at 1975, the same way;
4. generation: a Llama-2-7B-shaped q4_j model (random weights from a seed,
   FFN 11008 padded to 11264) generates greedily through ``Model.generate``
   with bf16 and with int8 KV, every launch count set to 0 just before each
   path and read just after; ``decode_loop``'s CUDA graph against eager
   steps; decode ms/token (slope of ``decode_loop`` n=4 vs n=36) at fills
   128 and 1975 (bf16 KV), at fill 1975 with int8 KV (leg decode_i8kv) and
   at batch 8, fill 128, int8 KV (leg batch8); the 1975-token prefill time
   (TTFT) with bf16 and int8 KV; then (4b) the same model at nf4, q4_0 and
   q4_j_i8_g128, one at a time: ``Model.generate``, the TTFT and decode
   ms/token at fill 128, each a path with its own launch counts;
5. card vs plain: a 2-layer copy at the same width runs its prefill logits
   and greedy steps through the kernels on the card and through the plain
   path on the CPU; then the same through the Scheduler (paged int8 KV,
   batch 4, 6 requests); then, for fp4, fp8, fp8_e5m2, int1, int2, int2
   asym, int3, int5, int5 asym, q8_0 and int8 (per channel),
   ``Model.generate`` on the card (a
   path each) and its logits against the plain path; logits within
   tolerance, greedy ids equal where the margin proves it;
6. serving: the same 7B model behind ``ModelServer(max_batch=8,
   max_len=2048, kv_mode="paged", page_size=256, memory_dtype="int8")``
   answers 12 queries (prompts of 32-1500 tokens, 32 new tokens each) with
   launch counts; the graphed decode step against the same steps run
   eagerly (ids and pool bytes); short slots-mode bf16 and paged bf16 runs;
   aggregate tok/s, decode-iteration ms at 8 running slots, TTFT.

The last lines are a ``{"kernels": [...]}`` JSON line, the nvidia-smi line,
and ``{"ok": true, "device": {...}}``. Exits non-zero without a result when
no CUDA device is present.
"""
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from neural_tpu_torch.api import Model  # noqa: E402
from neural_tpu_torch.convert.hf import init_random  # noqa: E402
from neural_tpu_torch.core.dtypes import PRESETS, QuantConfig  # noqa: E402
from neural_tpu_torch.core.qtensor import (dequantize, quantize,  # noqa: E402
                                           to_native, to_native_packed)
from neural_tpu_torch.models.config import ModelConfig  # noqa: E402
from neural_tpu_torch.ops import _cuda  # noqa: E402
from neural_tpu_torch.ops import attention as A  # noqa: E402
from neural_tpu_torch.ops import paged_attention as PA  # noqa: E402
from neural_tpu_torch.ops import qmatmul as Q  # noqa: E402
from neural_tpu_torch.runtime.generate import (decode_loop,  # noqa: E402
                                               greedy_generate, model_step,
                                               prefill_step)
from neural_tpu_torch.runtime.kvcache import init_cache  # noqa: E402
from neural_tpu_torch.runtime.sampling import SamplingParams  # noqa: E402
from neural_tpu_torch.serving import (ModelServer, Query,  # noqa: E402
                                      Scheduler)

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

L2_BYTES = 50 << 20
D, I_PAD, V, L, H, DH = 4096, 11264, 32000, 32, 32, 128
T_PREFILL, S_CACHE = 1975, 2048
CFG = ModelConfig(arch="llama", vocab_size=V, hidden_size=D, n_layers=L,
                  n_heads=H, n_kv_heads=H, head_dim=DH,
                  intermediate_size=11008, norm_eps=1e-5, rope_theta=10000.0,
                  max_seq_len=4096)
DEV = "cuda"


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fns, reps=20):
    """Device time of one call, in ms: the calls of ``fns`` (closures over
    distinct buffers, so a weight stream does not sit in the 50 MB L2) are
    captured in a CUDA graph, repeated until one replay is long enough to
    time, and each of ``reps`` replays is timed with CUDA events; the
    median replay over the number of calls in it. The graph keeps the
    host's launch cost (Python, ctypes) out of the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fns[0]()
    torch.cuda.synchronize()
    rounds = 1 if time.perf_counter() - t0 > 1e-3 else max(1, 10 // len(fns))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for f in fns:
                f()
    calls = rounds * len(fns)
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1) / calls)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(ts)


def bound_ms(nbytes, ops, peak_ops):
    return bound_ms_s(nbytes, ops / peak_ops)


def bound_ms_s(nbytes, op_seconds):
    """The larger of the bytes over the HBM rate and the operations' least
    time (summed over the operand types' peaks), in ms."""
    b, o = nbytes / HBM_BPS * 1e3, op_seconds * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


LAUNCHES = {}   # path name -> launch counts of that path's run


def run_path(name, required, fn):
    """Drive one main path with every launch count set to 0 just before and
    read just after; fail if a kernel of the path was never launched."""
    _cuda.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    LAUNCHES[name] = counts
    missing = [k for k in required if counts[k] == 0]
    log(f"path {name}: launches {counts}")
    if missing:
        raise AssertionError(f"kernels not launched on path {name}: "
                             f"{missing}")
    return out


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def phase_device():
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | nvidia-smi: {smi} | count "
        f"{torch.cuda.device_count()}")
    n = 1 << 30
    a = torch.empty(n, dtype=torch.uint8, device=DEV)
    bufs = [torch.empty_like(a) for _ in range(2)]
    ms = time_ms([lambda b=b: b.copy_(a) for b in bufs])
    bw = 2 * n / (ms * 1e-3)
    log(f"device-to-device copy: {bw / 1e12:.3f} TB/s (read+write of 1 GiB "
        f"in {ms:.3f} ms)")
    del a, bufs
    return smi, name, bw


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _qweight(K, N, gen, copies=1):
    w = torch.randn((K, N), generator=gen, device=DEV) * 0.02
    qt = to_native_packed(quantize(w, PRESETS["q4_j"]))
    return [(qt.planes[0].clone(), qt.scales.clone(), qt)
            for _ in range(copies)]


def _copies(nbytes):
    return max(1, math.ceil(2 * L2_BYTES / nbytes))


# the 7B's products per token: q/k/v/o, gate/up, down; and its lm_head
PROJ = [(D, D, 4 * L), (D, I_PAD, 2 * L), (I_PAD, D, L)]
LM_HEAD = [(D, V, 1)]


def _qt_bytes(qt):
    return sum(t.numel() * t.element_size() for t in (
        *qt.planes, qt.scales, *(() if qt.zeros is None else (qt.zeros,))))


def _qt_copy(qt):
    c = lambda t: None if t is None else t.clone()
    return dataclasses.replace(qt, planes=tuple(map(c, qt.planes)),
                               scales=c(qt.scales), zeros=c(qt.zeros))


def _case(gen, label, cfg, M, shapes, fn, plain, entry, peak, at_rest=True):
    """One format at one M over ``shapes`` (K, N, products per step): the
    wrapper ``fn(x, qt, out_dtype)`` against ``plain`` on the same CUDA
    tensors, checking that ``entry`` is the C function it launched; its
    time, the plain version's, one bf16 ``torch.matmul`` on the
    pre-dequantized weight (a yardstick) and the bound, each summed over the
    step. The lm_head (N = V) writes f32 logits, the rest bf16: a bf16
    output is one rounding away, 1e-2·max|ref|; f32 only the order of the
    sums, 1e-4·max|ref|."""
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0)
    bound_by = {"bytes": 0.0, "operations": 0.0}
    for K, N, count in shapes:
        odt = torch.float32 if N == V else torch.bfloat16
        qt = quantize(torch.randn((K, N), generator=gen, device=DEV) * 0.02,
                      cfg)
        if at_rest:
            qt = to_native(qt)
        wbytes = _qt_bytes(qt)
        qts = [qt] + [_qt_copy(qt) for _ in range(_copies(wbytes) - 1)]
        x = torch.randn((M, K), generator=gen, device=DEV).bfloat16()
        before = _cuda.launch_counts()[entry]
        out = fn(x, qt, odt)
        if _cuda.launch_counts()[entry] != before + 1:
            raise AssertionError(f"{label} {K}x{N}: {entry} was not launched")
        ref = plain(x, qt, odt)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = (1e-2 if odt == torch.bfloat16 else 1e-4) \
            * ref.float().abs().max().item()
        if not (err <= tol and torch.isfinite(out).all()):
            raise AssertionError(f"{label} {K}x{N}: max err {err} > tol {tol}")
        ms = time_ms([lambda q=q: fn(x, q, odt) for q in qts])
        pms = time_ms([lambda: plain(x, qt, odt)], reps=5)
        wd = Q.dequant_bf16(qt)
        wds = [wd] + [wd.clone() for _ in range(_copies(K * N * 2) - 1)]
        lms = time_ms([lambda w=w: torch.matmul(x, w) for w in wds])
        del wds, wd, qts
        bnd, by = bound_ms(wbytes + M * K * 2 + M * N * odt.itemsize,
                           2 * M * K * N, peak)
        bound_by[by] += count * bnd
        log(f"{label} {entry} M={M} {K}x{N} x{count}/step: err {err:.3g} "
            f"(tol {tol:.3g}) | kernel {ms:.4f} ms, plain {pms:.3f} ms, "
            f"torch.matmul bf16 {lms:.4f} ms, bound {bnd:.4f} ms ({by}); "
            f"{wbytes / (ms * 1e-3) / 1e9:.0f} GB/s of weights, "
            f"{2 * M * K * N / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
        for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                     ("bound_ms", bnd)):
            agg[k] += count * v
        agg["err"] = max(agg["err"], err)
    n = sum(count for _, _, count in shapes)
    agg.update(bound_by=max(bound_by, key=bound_by.get),
               per=f"{label} at M={M} ({n} launches)")
    log(f"{label} at M={M}, per step: kernel {agg['ms']:.4f} ms, bound "
        f"{agg['bound_ms']:.4f} ms ({agg['bound_by']}), plain "
        f"{agg['plain_ms']:.3f} ms, torch.matmul {agg['library_ms']:.4f} ms")
    return agg


def _record(results, key, cases):
    """The first case is the kernel's line; every case is kept beside it."""
    first = next(iter(cases.values()))
    results[key] = dict(first, cases=cases)


def check_k1(gen, results):
    """K1 over sym int4 (q4_j) at M=1 (batch 1) and M=8 (the server's
    batch-8 step): q/k/v/o, gate/up, down and the lm_head."""
    k1 = lambda x, qt, odt: Q.qmm_native(x, qt.planes[0], qt.scales, None,
                                         qt.group_size, 4, odt)
    pl = lambda x, qt, odt: Q.qmm_native_plain(x, qt.planes[0], qt.scales,
                                               None, qt.group_size, 4, odt)
    _record(results, "K1", {
        label: _case(gen, label, PRESETS["q4_j"], M, PROJ + LM_HEAD, k1, pl,
                     "qmm4_npack", BF16_FLOPS)
        for M, label in ((1, "q4_j decode step"), (8, "q4_j batch-8 step"))})


def check_k2(gen, results):
    """Prefill products at M=1975 through the int8-activation path; and its
    first pass, the activation quantization, alone (its codes must equal
    the plain version's; its time is inside K2's, and PyTorch has no one
    call for it)."""
    M = T_PREFILL
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0)
    act = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for K, N, count in PROJ:
        planes, scales, qt = _qweight(K, N, gen)[0]
        x = torch.randn((M, K), generator=gen, device=DEV).bfloat16()
        xq, sa = Q.act_quant_i8(x, 128)
        rq, rsa = Q.quantize_act_i8(x, 128)
        if not (torch.equal(xq, rq) and torch.equal(sa, rsa)):
            raise AssertionError(f"K2 act quant codes differ at {M}x{K}")
        # read x, write codes and f32 scales; ~4 f32 operations an element
        abnd, act["bound_by"] = bound_ms(M * K * 3 + M * K // 128 * 4,
                                         4 * M * K, F32_FLOPS)
        for k, v in (("ms", time_ms([lambda: Q.act_quant_i8(x, 128)])),
                     ("plain_ms", time_ms([lambda: Q.quantize_act_i8(x, 128)],
                                          reps=5)), ("bound_ms", abnd)):
            act[k] += count * v
        out = Q.qmm_a8(x, planes, scales, 128, 128, torch.bfloat16)
        ref = Q.qmm_a8_plain(x, planes, scales, 128, 128, torch.bfloat16)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = 1e-5 * ref.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"K2 {M}x{K}x{N}: max err {err} > {tol}")
        ms = time_ms([lambda: Q.qmm_a8(x, planes, scales, 128, 128,
                                       torch.bfloat16)])
        pms = time_ms([lambda: Q.qmm_a8_plain(x, planes, scales, 128, 128,
                                              torch.bfloat16)], reps=5)
        wd = dequantize(qt, torch.bfloat16)
        lms = time_ms([lambda: torch.matmul(x, wd)])
        nbytes = M * K * 2 + K * N // 2 + K // 128 * N * 2 + M * N * 2
        bnd, by = bound_ms(nbytes, 2 * M * N * K, INT8_OPS)
        log(f"K2 qmm_a8 M={M} {K}x{N} x{count}/prefill: err {err:.3g} "
            f"(tol {tol:.3g}), act codes equal | kernel {ms:.3f} ms, "
            f"plain {pms:.3f} ms, torch.matmul bf16 {lms:.3f} ms, bound "
            f"{bnd:.4f} ms ({by}); {2 * M * N * K / (ms * 1e-3) / 1e12:.1f} "
            "TOP/s")
        for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                     ("bound_ms", bnd)):
            agg[k] += count * v
        agg["err"] = max(agg["err"], err)
        del wd
    results["K2"] = dict(agg, bound_by="operations",
                         per="1975-token prefill (224 launches)")
    results["K2_act"] = dict(act, library_ms=None, err=0.0,
                             per="1975-token prefill (224 launches), inside "
                                 "K2's time")
    log(f"K2 quantize_act_i8 per prefill: kernel {act['ms']:.3f} ms, plain "
        f"{act['plain_ms']:.3f} ms, bound {act['bound_ms']:.4f} ms "
        f"({act['bound_by']})")


def check_k5(gen, results):
    """K5 in every format of the main paths, and at M=1 in the formats that
    run only in phase 5: nf4 decode (every product and the lm_head, M=1)
    and prefill (M=1975); the q4_0 prefill; the q4_j model's products at
    M=128, 64 and 32 (server chunks in those buckets, and the 64-token
    prompt of phase 4; each M picks its own tile height: 16, 64 or 128
    rows) and at M=24 (the 24-token prompt of phase 5, a partial tile);
    and fp4, fp8 e4m3/e5m2, int1 and bit-plane int3 asym (uint8
    zero-points, not at rest) at M=1."""
    k5 = lambda x, qt, odt: Q.qmm_general(x, qt, odt)
    pl = lambda x, qt, odt: Q.qmm_general_plain(x, qt, odt)
    cases = {}
    for label, cfg, M, shapes, at_rest in (
            ("nf4 decode step", PRESETS["nf4"], 1, PROJ + LM_HEAD, True),
            ("nf4 1975-token prefill", PRESETS["nf4"], T_PREFILL, PROJ,
             True),
            ("q4_0 1975-token prefill", PRESETS["q4_0"], T_PREFILL, PROJ,
             True),
            ("q4_j server chunk", PRESETS["q4_j"], 128, PROJ, True),
            ("q4_j 64-token prompt", PRESETS["q4_j"], 64, PROJ, True),
            ("q4_j server chunk, 32 bucket", PRESETS["q4_j"], 32, PROJ,
             True),
            ("q4_j 24-token prompt", PRESETS["q4_j"], 24, PROJ, True),
            ("fp4 decode step", PRESETS["fp4"], 1, PROJ + LM_HEAD, True),
            ("fp8_e4m3 decode step", PRESETS["fp8"], 1, PROJ + LM_HEAD, True),
            ("fp8_e5m2 decode step", PRESETS["fp8_e5m2"], 1, PROJ + LM_HEAD,
             True),
            ("int1 decode step", PRESETS["int1"], 1, PROJ + LM_HEAD, True),
            ("int3 asym bit planes decode step",
             QuantConfig(bits=3, group_size=32, sym=False), 1,
             PROJ + LM_HEAD, False)):
        cases[label] = _case(gen, label, cfg, M, shapes, k5, pl,
                             "qmm_general", BF16_FLOPS, at_rest)
        torch.cuda.empty_cache()
    _record(results, "K5", cases)


def check_k1_branches(gen, results):
    """K1's other entry points at M=1 and 8, every decode product and the
    lm_head: asym nibbles (q4_j_i8_g128), int2 and int8 codes (int5), sym
    and asym."""
    args = lambda qt: (qt.planes[0], qt.scales, qt.zeros, qt.group_size,
                       qt.cfg.bits)
    k1 = lambda x, qt, odt: Q.qmm_native(x, *args(qt), odt)
    pl = lambda x, qt, odt: Q.qmm_native_plain(x, *args(qt), odt)
    for key, entry, fmt in (("K1_asym", "qmm4_npack_asym", "q4_j_i8_g128"),
                            ("K1_int2", "qmm2_npack", "int2"),
                            ("K1_int2_asym", "qmm2_npack_asym", "int2_asym"),
                            ("K1_int8", "qmm8_native", "int5"),
                            ("K1_int8_asym", "qmm8_native_asym", "int5_asym")):
        cfg = QUANTS.get(fmt) or PRESETS[fmt]
        _record(results, key, {
            f"{fmt} {what}": _case(gen, f"{fmt} {what}", cfg, M,
                                   PROJ + LM_HEAD, k1, pl, entry, BF16_FLOPS)
            for M, what in ((1, "decode step"), (8, "batch-8 step"))})
        torch.cuda.empty_cache()


def check_k2_asym(gen, results):
    """K2 over asymmetric int4 (q4_j_i8_g128) at the 1975-token prefill.
    Equal int8 codes, exact integer dots and the fold in the same order;
    only the start ``-(xsa @ zwp)`` is summed in another order, which can
    move the bf16 output by one rounding: 1e-2·max|ref|."""
    k2 = lambda x, qt, odt: Q.qmm_a8(x, qt.planes[0], qt.scales,
                                     qt.group_size, 128, odt, qt.zeros)
    pl = lambda x, qt, odt: Q.qmm_a8_plain(x, qt.planes[0], qt.scales,
                                           qt.group_size, 128, odt, qt.zeros)
    label = "q4_j_i8_g128 1975-token prefill"
    _record(results, "K2_asym", {label: _case(
        gen, label, PRESETS["q4_j_i8_g128"], T_PREFILL, PROJ, k2, pl,
        "qmm_a8_asym", INT8_OPS)})


def _kv(gen, S, copies=1):
    return [(torch.randn((1, H, S, DH), generator=gen, device=DEV).bfloat16(),
             (torch.rand((1, H, S, DH), generator=gen, device=DEV) * 2 - 1)
             .bfloat16()) for _ in range(copies)]


def check_k3(gen, results):
    T, S = T_PREFILL, S_CACHE
    q = torch.randn((1, T, H, DH), generator=gen, device=DEV).bfloat16()
    k, v = _kv(gen, S)[0]
    starts = torch.zeros(1, dtype=torch.int32, device=DEV)
    scale = DH ** -0.5
    out = A.flash_prefill(q, k, v, starts, scale)
    ref = A.flash_prefill_plain(q, k, v, starts, scale)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = 4e-3           # two bf16 roundings of P (<= 2^-9 each), |v| <= 1
    if not err <= tol:
        raise AssertionError(f"K3: max err {err} > {tol}")
    ms = time_ms([lambda: A.flash_prefill(q, k, v, starts, scale)])
    pms = time_ms([lambda: A.flash_prefill_plain(q, k, v, starts, scale)],
                  reps=5)
    qt_, kt, vt = q.transpose(1, 2), k[:, :, :T], v[:, :, :T]
    lms = time_ms([lambda: torch.nn.functional.scaled_dot_product_attention(
        qt_, kt, vt, is_causal=True)])
    ops = 4 * DH * H * T * (T + 1) // 2
    nbytes = T * H * DH * 2 * 3 + T * H * DH * 4
    bnd, by = bound_ms(nbytes, ops, BF16_FLOPS)
    log(f"K3 flash_prefill T={T} S={S} H={H} x{L}/prefill: err {err:.3g} "
        f"(tol {tol}) | kernel {ms:.3f} ms, plain {pms:.3f} ms, sdpa "
        f"{lms:.3f} ms, bound {bnd:.4f} ms ({by}); "
        f"{ops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
    results["K3"] = dict(ms=L * ms, plain_ms=L * pms, library_ms=L * lms,
                         bound_ms=L * bnd, bound_by=by, err=err,
                         per="1975-token prefill (32 launches)")


def check_k4(gen, results):
    S = S_CACHE
    scale = DH ** -0.5
    for fill in (128, T_PREFILL):
        q = torch.randn((1, H, DH), generator=gen, device=DEV).bfloat16()
        kvs = _kv(gen, S, _copies(fill * H * DH * 4))
        k, v = kvs[0]
        lengths = torch.tensor([fill], dtype=torch.int32, device=DEV)
        out = A.flash_decode(q, k, v, lengths, scale)
        ref = A.flash_decode_plain(q, k, v, lengths, scale)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 4e-3
        if not err <= tol:
            raise AssertionError(f"K4 fill {fill}: max err {err} > {tol}")
        ms = time_ms([lambda k=k, v=v: A.flash_decode(q, k, v, lengths,
                                                      scale)
                      for k, v in kvs])
        pms = time_ms([lambda: A.flash_decode_plain(q, k, v, lengths,
                                                    scale)], reps=5)
        qs = q[:, :, None]
        lms = time_ms([
            lambda k=k, v=v: torch.nn.functional.scaled_dot_product_attention(
                qs, k[:, :, :fill], v[:, :, :fill]) for k, v in kvs])
        nbytes = fill * H * DH * 2 * 2 + H * DH * (2 + 4)
        bnd, by = bound_ms(nbytes, 4 * DH * H * fill, BF16_FLOPS)
        log(f"K4 flash_decode fill={fill} S={S} H={H} x{L}/token: err "
            f"{err:.3g} (tol {tol}) | kernel {ms:.4f} ms, plain {pms:.3f} "
            f"ms, sdpa {lms:.4f} ms, bound {bnd:.4f} ms ({by}); "
            f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
        del kvs
    results["K4"] = dict(ms=L * ms, plain_ms=L * pms, library_ms=L * lms,
                         bound_ms=L * bnd, bound_by=by, err=err,
                         per="decode token at fill 1975 (32 launches)")


def _kv_i8(gen, shape):
    """int8 codes and bf16 scales of a random normal K or V cache."""
    return A.quantize_kv(torch.randn(shape, generator=gen, device=DEV))


def _dequant(c, s):
    return (c.float() * s.float()[..., None]).bfloat16()


def _check_close(name, out, ref, tol):
    err = (out - ref).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max err {err} > tol {tol}")
    return err


# int8 attention: the exact int8 QK dot and q's quantization are the same
# arithmetic on both sides, the softmax sums run in another order; K3 also
# rounds P·vs to bf16 against its running max where the plain version uses
# the final max (<= 2^-9 relative), and |v| here reaches ~4: 4e-3 for K3,
# as for the bf16 K3 check, and 1e-4 for the f32-PV decode kernels
I8_PREFILL_TOL, I8_DECODE_TOL = 4e-3, 1e-4


def check_k3_i8(gen, results):
    T, S = T_PREFILL, S_CACHE
    scale = DH ** -0.5
    q = torch.randn((1, T, H, DH), generator=gen, device=DEV).bfloat16()
    k, ks = _kv_i8(gen, (1, H, S, DH))
    v, vs = _kv_i8(gen, (1, H, S, DH))
    starts = torch.zeros(1, dtype=torch.int32, device=DEV)
    args = (q, k, v, ks, vs, starts, scale)
    out = A.flash_prefill_i8(*args)
    ref = A.flash_prefill_i8_plain(*args)
    torch.cuda.synchronize()
    err = _check_close("K3 int8", out, ref, I8_PREFILL_TOL)
    ms = time_ms([lambda: A.flash_prefill_i8(*args)])
    pms = time_ms([lambda: A.flash_prefill_i8_plain(*args)], reps=5)
    kd, vd = _dequant(k, ks)[:, :, :T], _dequant(v, vs)[:, :, :T]
    qt_ = q.transpose(1, 2)
    lms = time_ms([lambda: torch.nn.functional.scaled_dot_product_attention(
        qt_, kd, vd, is_causal=True)])
    pairs = 2 * DH * H * T * (T + 1) // 2      # per product, causal half
    nbytes = T * H * DH * 2 + 2 * T * H * (DH + 2) + T * H * DH * 4
    bnd, by = bound_ms_s(nbytes, pairs / INT8_OPS + pairs / BF16_FLOPS)
    log(f"K3 flash_prefill_i8 T={T} S={S} H={H} x{L}/prefill: err {err:.3g} "
        f"(tol {I8_PREFILL_TOL}) | kernel {ms:.3f} ms, plain {pms:.3f} ms, "
        f"sdpa (dequantized bf16) {lms:.3f} ms, bound {bnd:.4f} ms ({by})")
    results["K3_i8"] = dict(ms=L * ms, plain_ms=L * pms, library_ms=L * lms,
                            bound_ms=L * bnd, bound_by=by, err=err,
                            per="1975-token prefill, int8 KV (32 launches)")


def check_k4_i8(gen, results):
    S, fill = S_CACHE, T_PREFILL
    scale = DH ** -0.5
    q = torch.randn((1, H, DH), generator=gen, device=DEV).bfloat16()
    caches = [(*_kv_i8(gen, (1, H, S, DH)), *_kv_i8(gen, (1, H, S, DH)))
              for _ in range(_copies(fill * H * (DH + 2) * 2))]
    k, ks, v, vs = caches[0]
    lengths = torch.tensor([fill], dtype=torch.int32, device=DEV)
    out = A.flash_decode_i8(q, k, v, ks, vs, lengths, scale)
    ref = A.flash_decode_i8_plain(q, k, v, ks, vs, lengths, scale)
    torch.cuda.synchronize()
    err = _check_close("K4 int8", out, ref, I8_DECODE_TOL)
    ms = time_ms([lambda c=c: A.flash_decode_i8(q, c[0], c[2], c[1], c[3],
                                                lengths, scale)
                  for c in caches])
    pms = time_ms([lambda: A.flash_decode_i8_plain(q, k, v, ks, vs, lengths,
                                                   scale)], reps=5)
    kd, vd = _dequant(k, ks)[:, :, :fill], _dequant(v, vs)[:, :, :fill]
    qs = q[:, :, None]
    lms = time_ms([lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, kd, vd)])
    nbytes = fill * H * (DH + 2) * 2 + H * DH * (2 + 4)
    ops = 2 * DH * H * fill
    # int8 QK; the PV is f32 by contract (P·vs in f32, as the TPU kernel)
    bnd, by = bound_ms_s(nbytes, ops / INT8_OPS + ops / F32_FLOPS)
    log(f"K4 flash_decode_i8 fill={fill} S={S} H={H} x{L}/token: err "
        f"{err:.3g} (tol {I8_DECODE_TOL}) | kernel {ms:.4f} ms, plain "
        f"{pms:.3f} ms, sdpa (dequantized bf16) {lms:.4f} ms, bound "
        f"{bnd:.4f} ms ({by}); {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
    del caches
    results["K4_i8"] = dict(ms=L * ms, plain_ms=L * pms, library_ms=L * lms,
                            bound_ms=L * bnd, bound_by=by, err=err,
                            per="decode token at fill 1975, int8 KV "
                                "(32 launches)")


def check_k6(gen, results):
    """K6 at the server's shape: B=8, Hkv=32, ps=256, MAXP=8, a shuffled
    table over a pool of 8*8 + 1 pages, fills spread over 1..2048."""
    B, ps, maxp = 8, 256, 8
    P = B * maxp + 1
    scale = DH ** -0.5
    cpu = torch.Generator().manual_seed(6)
    table = torch.randperm(P - 1, generator=cpu)[:B * maxp] \
        .reshape(B, maxp).to(torch.int32).to(DEV)
    fills = torch.tensor([1, 2048, 1975, 128, 700, 1300, 33, 1024],
                         dtype=torch.int32, device=DEV)
    q = torch.randn((B, H, DH), generator=gen, device=DEV).bfloat16()
    n = int(fills.sum())
    mask = (torch.arange(maxp * ps, device=DEV)[None, :]
            < fills[:, None].long())[:, None, None, :]
    for int8 in (False, True):
        if int8:
            k, ks = _kv_i8(gen, (P, H, ps, DH))
            v, vs = _kv_i8(gen, (P, H, ps, DH))
            args = (q, k, v, ks, vs, table, fills, scale)
            fn, name, tol = PA.paged_decode_i8, "K6_i8", I8_DECODE_TOL
            kd = PA.gather_pages(_dequant(k, ks), table)
            vd = PA.gather_pages(_dequant(v, vs), table)
            nbytes = n * H * (DH + 2) * 2
        else:
            k = torch.randn((P, H, ps, DH), generator=gen,
                            device=DEV).bfloat16()
            v = (torch.rand((P, H, ps, DH), generator=gen, device=DEV) * 2
                 - 1).bfloat16()
            args = (q, k, v, table, fills, scale)
            fn, name, tol = PA.paged_decode, "K6", 4e-3
            kd, vd = PA.gather_pages(k, table), PA.gather_pages(v, table)
            nbytes = n * H * DH * 2 * 2
            ks = vs = None
        out = fn(*args)
        ref = PA.paged_decode_plain(q, k, v, ks, vs, table, fills, scale)
        torch.cuda.synchronize()
        err = _check_close(name, out, ref, tol)
        ms = time_ms([lambda: fn(*args)])
        pms = time_ms([lambda: PA.paged_decode_plain(q, k, v, ks, vs, table,
                                                     fills, scale)], reps=5)
        qs = q[:, :, None]
        lms = time_ms([
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, kd, vd, attn_mask=mask)])
        nbytes += B * maxp * 4 + B * 4 + B * H * DH * (2 + 4)
        ops = 2 * DH * H * n
        # QK and PV at their operands' peaks: bf16 x bf16 for the bf16 pool;
        # int8 QK and the f32 PV of the contract for the int8 pool
        bnd, by = bound_ms_s(nbytes, ops / INT8_OPS + ops / F32_FLOPS
                             if int8 else 2 * ops / BF16_FLOPS)
        log(f"{name} paged_decode{'_i8' if int8 else ''} B={B} ps={ps} "
            f"MAXP={maxp} fills {fills.tolist()} x{L}/step: err {err:.3g} "
            f"(tol {tol}) | kernel {ms:.4f} ms, plain {pms:.3f} ms, sdpa "
            f"(gathered{', dequantized' if int8 else ''} bf16) {lms:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}); {nbytes / (ms * 1e-3) / 1e9:.0f} "
            "GB/s")
        results[name] = dict(ms=L * ms, plain_ms=L * pms, library_ms=L * lms,
                             bound_ms=L * bnd, bound_by=by, err=err,
                             per=f"batch-8 decode step, {'int8' if int8 else 'bf16'} "
                                 "KV, fills above (32 launches)")
        del kd, vd


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------


# the 64-token prompt prefills through K5, the 512-token one through K2
GEN_BF16 = ("qmm4_npack", "qmm_a8", "qmm_general", "flash_prefill",
            "flash_decode")
GEN_INT8 = ("qmm4_npack", "qmm_a8", "flash_prefill_i8", "flash_decode_i8")


def _check_ids(new, n, what):
    if len(new) != n or not all(0 <= t < V for t in new):
        raise AssertionError(f"{what}: bad generated ids {new}")


def decode_ms(params, fill, batch=1, kv_dtype=torch.bfloat16, lo=4, hi=36):
    """ms per decode step: slope of ``decode_loop`` between lo and hi steps
    (best of 3 each) from a cache filled to ``fill``."""
    token = torch.full((batch, 1), 17, dtype=torch.long, device=DEV)

    def run(n):
        cache = init_cache(CFG, batch, S_CACHE, kv_dtype, device=DEV)
        pos = torch.full((batch,), fill, dtype=torch.long, device=DEV)
        torch.cuda.synchronize()
        t = time.perf_counter()
        decode_loop(params, token, pos, cache, n)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run(lo)
    t_lo = min(run(lo) for _ in range(3))
    t_hi = min(run(hi) for _ in range(3))
    return (t_hi - t_lo) / (hi - lo) * 1e3


def ttft_ms(params, kv_dtype=torch.bfloat16):
    """1975-token prefill with last-row logits on a fresh cache, best of 3
    after a warm-up."""
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, V, (1, T_PREFILL), generator=gen).to(DEV)
    start = torch.zeros(1, dtype=torch.long, device=DEV)

    def once():
        cache = init_cache(CFG, 1, S_CACHE, kv_dtype, device=DEV)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = prefill_step(params, tokens, start, cache)
        torch.cuda.synchronize()
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite prefill logits")
        return (time.perf_counter() - t) * 1e3

    once()
    return min(once() for _ in range(3))


def phase_generation(params):
    model = Model().init_params(params, CFG)
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(3, V, (n,), generator=gen).tolist()
               for n in (64, 512)]
    outs = run_path("generate_bf16", GEN_BF16, lambda: [
        model.generate(p, max_new_tokens=16, do_sample=False,
                       stop_at_eos=False)[0] for p in prompts])
    log("Model.generate greedy, bf16 KV, prompts of 64 and 512 tokens, 16 "
        "new each")
    for p, o in zip(prompts, outs):
        _check_ids(o[len(p):], 16, "generate bf16")
        log(f"  prompt {len(p)}: new ids {o[len(p):]}")
    out8 = run_path("generate_int8", GEN_INT8, lambda: model.generate(
        prompts[1], max_new_tokens=16, do_sample=False, stop_at_eos=False,
        kv_dtype="int8")[0])
    _check_ids(out8[512:], 16, "generate int8")
    log(f"Model.generate greedy, int8 KV, 512-token prompt: new ids "
        f"{out8[512:]}")

    # decode_loop replays one CUDA graph per token: it must give the ids of
    # the same steps run eagerly
    caches = [init_cache(CFG, 1, 256, device=DEV) for _ in range(2)]
    with torch.inference_mode():
        for c in caches:
            prefill_step(params, torch.tensor([prompts[0]], device=DEV),
                         torch.zeros(1, dtype=torch.long, device=DEV), c)
        token = torch.tensor([[outs[0][64]]], device=DEV)
        pos = torch.tensor([64], device=DEV)
        graphed = decode_loop(params, token, pos, caches[0], 12)[:, 0]
        eager = []
        for _ in range(12):
            logits = params(token, pos, caches[1], logits_dtype=torch.bfloat16)
            token = torch.argmax(logits[:, -1], dim=-1)[:, None]
            pos = pos + 1
            eager.append(int(token))
    if graphed.tolist() != eager:
        raise AssertionError(f"decode_loop {graphed.tolist()} != eager "
                             f"steps {eager}")
    if not torch.equal(caches[0].k, caches[1].k):
        raise AssertionError("decode_loop wrote another KV cache than the "
                             "eager steps")
    log(f"decode_loop (CUDA graph) = eager steps: {eager}")
    del caches

    d128, d1975 = decode_ms(params, 128), decode_ms(params, T_PREFILL)
    log(f"decode (slope n=4..36, batch 1, bf16 KV): fill 128 {d128:.3f} "
        f"ms/token ({1e3 / d128:.1f} tok/s), fill 1975 {d1975:.3f} ms/token "
        f"({1e3 / d1975:.1f} tok/s)")
    d1975_i8 = decode_ms(params, T_PREFILL, kv_dtype=torch.int8)
    log(f"leg decode_i8kv (slope, batch 1, int8 KV): fill 1975 "
        f"{d1975_i8:.3f} ms/token ({1e3 / d1975_i8:.1f} tok/s)")
    b8 = decode_ms(params, 128, batch=8, kv_dtype=torch.int8)
    log(f"leg batch8 (slope, batch 8, int8 KV, fill 128): {b8:.3f} ms/step "
        f"({8e3 / b8:.1f} tok/s aggregate)")
    ttft, ttft_i8 = ttft_ms(params), ttft_ms(params, torch.int8)
    log(f"TTFT 1975-token prefill (last-row logits): bf16 KV {ttft:.2f} ms, "
        f"int8 KV {ttft_i8:.2f} ms")
    return dict(decode_ms_fill128=d128, decode_ms_fill1975=d1975,
                decode_i8kv_ms_fill1975=d1975_i8, batch8_step_ms=b8,
                batch8_tok_s=8e3 / b8, ttft_1975_ms=ttft,
                ttft_1975_int8kv_ms=ttft_i8)


# the kernels each format's prefill (1975 tokens, last-row lm_head at M=1)
# and decode (M=1) must launch, by the JAX package's route
FORMAT_PATHS = {
    "nf4": (("qmm_general", "flash_prefill"), ("qmm_general", "flash_decode")),
    "q4_0": (("qmm_general", "qmm4_npack", "flash_prefill"),
             ("qmm4_npack", "flash_decode")),
    "q4_j_i8_g128": (("quantize_act_i8", "qmm_a8_asym", "qmm4_npack_asym",
                      "flash_prefill"), ("qmm4_npack_asym", "flash_decode")),
}


def phase_formats():
    """The same 7B shape at nf4, q4_0 and q4_j_i8_g128, one model at a time:
    ``Model.generate`` (300-token prompt, 16 new tokens, greedy, bf16 KV),
    the 1975-token TTFT and decode ms/token at fill 128, each a path of its
    own with the launch counts set to 0 just before it."""
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(3, V, (300,), generator=gen).tolist()
    res = {}
    for fmt, (pre, dec) in FORMAT_PATHS.items():
        t = time.time()
        params = init_random(CFG, seed=0, quant=fmt, device=DEV)
        torch.cuda.synchronize()
        log(f"init_random Llama-2-7B {fmt} on the card: "
            f"{time.time() - t:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f}"
            " GiB allocated")
        model = Model().init_params(params, CFG)
        out = run_path(f"generate_{fmt}", sorted(set(pre + dec)),
                       lambda: model.generate(prompt, max_new_tokens=16,
                                              do_sample=False,
                                              stop_at_eos=False)[0])
        _check_ids(out[300:], 16, f"generate {fmt}")
        ttft = run_path(f"prefill_{fmt}", pre, lambda: ttft_ms(params))
        d128 = run_path(f"decode_{fmt}", dec, lambda: decode_ms(params, 128))
        log(f"{fmt}: Model.generate new ids {out[300:]}; TTFT 1975-token "
            f"prefill {ttft:.2f} ms; decode (slope n=4..36, batch 1, bf16 KV) "
            f"fill 128 {d128:.3f} ms/token ({1e3 / d128:.1f} tok/s)")
        res[f"{fmt}_ttft_1975_ms"] = ttft
        res[f"{fmt}_decode_ms_fill128"] = d128
        del model, params
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 5: the card against the plain path on the CPU
# ---------------------------------------------------------------------------


def _steps_card_vs_plain(card, host, cfg2, ids, feed, rel_tol):
    """Logits of the prefill's last row and of one decode step per id of
    ``feed``, on the card and on the CPU's plain path: within ``rel_tol``
    of max|logit| at every step, and the argmax equal wherever the plain
    top-2 margin exceeds twice that step's largest logit difference.
    Returns (worst relative difference, steps so proven, argmax equal at
    each step)."""
    caches = [init_cache(cfg2, 1, len(ids) + len(feed) + 1, device=d)
              for d in (DEV, "cpu")]
    logits = [prefill_step(m, torch.tensor([ids], device=c.k.device),
                           torch.zeros(1, dtype=torch.long,
                                       device=c.k.device), c)
              for m, c in zip((card, host), caches)]
    worst, provable, sames = 0.0, 0, []
    for step in range(len(feed) + 1):
        a, b = logits[0][0, -1].float().cpu(), logits[1][0, -1].float()
        err = (a - b).abs().max().item()
        tol = rel_tol * b.abs().max().item()
        worst = max(worst, err / b.abs().max().item())
        top2 = b.topk(2).values
        margin = (top2[0] - top2[1]).item()
        same = int(a.argmax()) == int(b.argmax())
        sames.append(same)
        log(f"  step {step}: max |card - plain| {err:.4g}, max|logit| "
            f"{b.abs().max().item():.4g}, plain top-2 margin {margin:.4g}, "
            f"argmax equal {same}")
        if not err <= tol:
            raise AssertionError(f"card vs plain logits, step {step}: max "
                                 f"err {err} > {tol}")
        if margin > 2 * err:
            provable += 1
            if not same:
                raise AssertionError(f"card vs plain argmax differs at step "
                                     f"{step} despite margin {margin}")
        if step == len(feed):
            break
        logits = [model_step(m, torch.tensor([[feed[step]]],
                                             device=c.k.device),
                             torch.tensor([len(ids) + step],
                                          device=c.k.device), c)
                  for m, c in zip((card, host), caches)]
    return worst, provable, sames


def phase_card_vs_plain():
    cfg2 = dataclasses.replace(CFG, n_layers=2)
    card = init_random(cfg2, seed=1, quant="q4_j", device=DEV)
    host = init_random(cfg2, seed=1, quant="q4_j", device=DEV).to("cpu")
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(3, V, (300,), generator=gen).tolist()
    n_new = 8
    g_card = greedy_generate(card, cfg2, ids, max_new_tokens=n_new + 1,
                             stop_at_eos=False)[len(ids):]
    g_host = greedy_generate(host, cfg2, ids, max_new_tokens=n_new + 1,
                             stop_at_eos=False)[len(ids):]
    # bf16 activations: last-bit differences (split-K order in K1 and K5,
    # where K3 rounds P, the card's rsqrt/exp) move int8 activation codes
    # of the next K2 product by a step, and two layers amplify that; the
    # tiny model shows 1.8e-2 between the JAX package and the port on the
    # CPU
    rel_tol = 5e-2
    worst, provable, sames = _steps_card_vs_plain(card, host, cfg2, ids,
                                                  g_card[:n_new], rel_tol)
    for step in range(n_new):
        if all(sames[:step + 1]) and g_host[step] != g_card[step]:
            raise AssertionError(f"free-running greedy ids differ at step "
                                 f"{step} while every argmax so far agreed")
    log(f"card vs plain (2 layers, full width, 300-token prompt): logits "
        f"max err {worst:.3g}·max|logit| (tol {rel_tol}); greedy card "
        f"{g_card}, plain {g_host}; argmax provably comparable at "
        f"{provable} of {n_new + 1} steps, equal at all of them")
    if provable < 3:
        raise AssertionError("too few steps with a margin wide enough to "
                             "compare the argmax")
    sched_worst = _sched_card_vs_plain(card, host, cfg2, rel_tol)
    del card, host
    return worst, sched_worst, _formats_card_vs_plain(cfg2)


# asymmetric int2 and int5 (uint8 zero-points, group 32), what
# ``quant_config_from_args("int2" | "int5", alg="asym")`` gives; no preset
# holds them, and K1 has an entry point for each
QUANTS = {
    "int2_asym": QuantConfig(bits=2, group_size=32, sym=False, act_bits=8),
    "int5_asym": QuantConfig(bits=5, group_size=32, sym=False, act_bits=8),
}

# the formats with no full-width path, and the kernels a card run of each
# must launch: a 24-token prompt prefills through K5 (M=24 > 16), its
# one-row lm_head and the decode steps through K1's branch for codes at
# rest, through K5 for the stored layouts
PLAIN_FORMATS = {
    "fp4": ("qmm_general",), "fp8": ("qmm_general",),
    "fp8_e5m2": ("qmm_general",), "int1": ("qmm_general",),
    "int2": ("qmm_general", "qmm2_npack"),
    "int2_asym": ("qmm_general", "qmm2_npack_asym"),
    "int3": ("qmm_general", "qmm4_npack"),
    "int5": ("qmm_general", "qmm8_native"),
    "int5_asym": ("qmm_general", "qmm8_native_asym"),
    "q8_0": ("qmm_general", "qmm8_native"),
    "int8": ("qmm_general", "qmm8_native"),
}


def _formats_card_vs_plain(cfg2, rel_tol=2e-2):
    """Each format of PLAIN_FORMATS: the 2-layer copy at full width runs
    ``Model.generate`` on the card (a path of its own, with launch counts;
    24-token prompt, 3 new tokens), then its logits, fed the card's ids,
    are held against the plain path on the CPU. Every product here has
    bf16 activations (24 rows are too few for the int8 path), so no int8
    code moves; what differs is the order of f32 sums and the bf16
    roundings between layers, one bf16 step (2^-8 relative) at a time.
    The H100 showed 7e-3 to 9e-3·max|logit|; the tolerance is 2e-2, not
    the q4_j check's 5e-2. The worst relative difference is printed per
    format."""
    gen = torch.Generator().manual_seed(8)
    ids = torch.randint(3, V, (24,), generator=gen).tolist()
    res, total = {}, 0
    for i, (fmt, required) in enumerate(PLAIN_FORMATS.items()):
        quant = QUANTS.get(fmt, fmt)
        card = init_random(cfg2, seed=10 + i, quant=quant, device=DEV)
        host = init_random(cfg2, seed=10 + i, quant=quant,
                           device=DEV).to("cpu")
        model = Model().init_params(card, cfg2)
        new = run_path(f"card_{fmt}", required, lambda: model.generate(
            ids, max_new_tokens=3, do_sample=False,
            stop_at_eos=False)[0])[len(ids):]
        _check_ids(new, 3, f"card {fmt}")
        log(f"{fmt}: card vs plain, fed the card's ids {new}")
        worst, provable, _ = _steps_card_vs_plain(card, host, cfg2, ids, new,
                                                  rel_tol)
        log(f"{fmt}: logits max err {worst:.3g}·max|logit| (tol {rel_tol}); "
            f"argmax provably comparable at {provable} of 4 steps, equal at "
            "all of them")
        res[fmt] = worst
        total += provable
        del card, host, model
        torch.cuda.empty_cache()
    if total < len(PLAIN_FORMATS):
        raise AssertionError(f"only {total} steps over {len(PLAIN_FORMATS)} "
                             "formats had a margin wide enough to compare "
                             "the argmax")
    return res


class _LogitsRecorder:
    """Stands in for the decoder inside a Scheduler: calls it, and keeps
    each logits row that becomes a token, keyed (request id, token index).
    A decode step's row of slot s is token len(output_ids) of the request
    there; a prefill chunk's row is token 0 when the chunk ends the
    prompt."""

    def __init__(self, model):
        self.model, self.sched, self.rows = model, None, {}

    @property
    def device(self):
        return self.model.device

    def __call__(self, tokens, start, cache, **kw):
        logits = self.model(tokens, start, cache, **kw)
        s = self.sched
        if tokens.shape[1] == 1:
            for slot, seq in s.running.items():
                self.rows[(seq.request_id, len(seq.output_ids))] = \
                    logits[slot, -1].float().cpu()
        else:
            seq = s._prefilling
            if seq.prefill_pos + (seq.chunk or len(seq.prompt_ids)) >= \
                    len(seq.prompt_ids):
                self.rows[(seq.request_id, 0)] = logits[0, -1].float().cpu()
        return logits


def _sched_card_vs_plain(card, host, cfg2, rel_tol):
    """The 2-layer model through the Scheduler (paged int8 KV, batch 4, 6
    requests) on the card, decode step eager so each step's logits can be
    read, and on the CPU's plain path: per request, logits within the
    tolerance and greedy ids equal at every token whose plain top-2 margin
    exceeds twice the logit difference, up to the first token where the two
    sides' ids part (past it their inputs differ)."""
    gen = torch.Generator().manual_seed(5)
    lens = torch.randint(20, 64, (6,), generator=gen).tolist()
    prompts = [torch.randint(3, V, (n,), generator=gen).tolist()
               for n in lens]
    n_new = 3           # the plain path's CPU time sets the size
    done, recs = [], []
    for model in (card, host):
        rec = _LogitsRecorder(model)
        sched = Scheduler(model, cfg2, max_batch=4, max_len=256,
                          kv_mode="paged", page_size=64,
                          kv_dtype=torch.int8,
                          sampling=SamplingParams(greedy=True,
                                                  repeat_penalty=1.0))
        sched._graphs = None      # the decode step eagerly: logits readable
        rec.sched, sched.params = sched, rec
        for i, p in enumerate(prompts):
            sched.add_request(i, p, max_new_tokens=n_new)
        done.append({q.request_id: q.output_ids
                     for q in sched.run_to_completion()})
        recs.append(rec.rows)
    worst, provable = 0.0, 0
    for i in range(len(prompts)):
        for t in range(n_new):
            if (i, t) not in recs[1]:
                break
            a, b = recs[0][(i, t)], recs[1][(i, t)]
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            worst = max(worst, err / scale)
            if not err <= rel_tol * scale:
                raise AssertionError(f"scheduler card vs plain logits, "
                                     f"request {i} token {t}: max err {err}")
            top2 = b.topk(2).values
            ca, ho = done[0][i][t], done[1][i][t]
            if (top2[0] - top2[1]).item() > 2 * err:
                provable += 1
                if ca != ho:
                    raise AssertionError(f"scheduler ids differ at request "
                                         f"{i} token {t} despite the margin")
            if ca != ho:
                break
    log(f"scheduler card vs plain (2 layers, paged int8, batch 4, prompts "
        f"{lens}): logits max err {worst:.3g}·max|logit| (tol {rel_tol}); "
        f"ids card {[done[0][i] for i in range(6)]}, plain "
        f"{[done[1][i] for i in range(6)]}; provably comparable at "
        f"{provable} tokens, equal at all of them")
    if provable < 3:
        raise AssertionError("too few scheduler steps with a margin wide "
                             "enough to compare the argmax")
    return worst


# ---------------------------------------------------------------------------
# phase 6: the server at full width
# ---------------------------------------------------------------------------

# prompt tails in the 32/64/128 buckets prefill through K5
SERVE_PAGED_I8 = ("qmm4_npack", "qmm_a8", "qmm_general", "flash_prefill_i8",
                  "paged_decode_i8")


def _serve(srv, prompts, n_new, timeout=300.0):
    """Issue every prompt at once, wait for Empty() under a timeout that
    raises; return (finished sequences by id, issue time, wall seconds)."""
    t0 = time.time()
    srv.issueQuery([Query(i, p, n_new) for i, p in enumerate(prompts)])
    while not srv.Empty():
        if time.time() - t0 > timeout:
            raise TimeoutError(f"server did not answer {len(prompts)} "
                               f"queries in {timeout} s")
        time.sleep(0.002)
    wall = time.time() - t0
    with srv._lock:
        done, srv.finished = {q.request_id: q for q in srv.finished}, []
    if sorted(done) != list(range(len(prompts))):
        raise AssertionError(f"answered {sorted(done)} of "
                             f"{len(prompts)} queries")
    for i, q in done.items():
        out = q.output_ids
        stopped = out and out[-1] in CFG.eos_token_ids and len(out) < n_new
        if not (len(out) == n_new or stopped) \
                or not all(0 <= t < V for t in out):
            raise AssertionError(f"query {i}: bad ids {out}")
    return done, t0, wall


def _graph_vs_eager(params):
    """The same 8 requests through two paged int8 Schedulers, one replaying
    the decode-step CUDA graph, one running the step eagerly: equal ids and
    equal pool bytes (the trash page aside)."""
    gen = torch.Generator().manual_seed(7)
    lens = torch.randint(40, 400, (8,), generator=gen).tolist()
    prompts = [torch.randint(3, V, (n,), generator=gen).tolist()
               for n in lens]
    runs = []
    for graph in (True, False):
        sched = Scheduler(params, CFG, max_batch=8, max_len=1024,
                          kv_mode="paged", page_size=256,
                          kv_dtype=torch.int8)
        if not graph:
            sched._graphs = None  # the same decode step, run eagerly
        for i, p in enumerate(prompts):
            sched.add_request(i, p, max_new_tokens=10)
        runs.append(({q.request_id: q.output_ids
                      for q in sched.run_to_completion()}, sched.cache))
    (ids_g, pool_g), (ids_e, pool_e) = runs
    if ids_g != ids_e:
        raise AssertionError(f"graphed server steps {ids_g} != eager {ids_e}")
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(pool_g, name), getattr(pool_e, name)
        if not torch.equal(a[:, :-1], b[:, :-1]):
            raise AssertionError(f"graphed server steps wrote another {name} "
                                 "pool than the eager steps")
    log(f"server decode step (CUDA graph) = eager steps: ids and pool bytes "
        f"equal over 8 requests (prompts {lens}), 10 new tokens each")
    del runs, pool_g, pool_e
    torch.cuda.empty_cache()


def phase_server(params):
    _graph_vs_eager(params)
    gen = torch.Generator().manual_seed(6)
    lens = torch.randint(32, 1501, (12,), generator=gen).tolist()
    prompts = [torch.randint(3, V, (n,), generator=gen).tolist()
               for n in lens]
    srv = ModelServer(params, CFG, max_batch=8, max_len=S_CACHE,
                      kv_mode="paged", page_size=256, memory_dtype="int8")
    try:
        sched = srv.scheduler
        step_ms = []
        decode_step = sched._decode_step

        def timed_decode_step():
            n = len(sched.running)
            t = time.perf_counter()
            decode_step()
            step_ms.append((n, (time.perf_counter() - t) * 1e3))

        sched._decode_step = timed_decode_step
        # warm-up query: the decode graph is captured once per server
        _serve(srv, [prompts[0][:600]], 4)
        step_ms.clear()
        done, t0, wall = run_path("server_paged_int8", SERVE_PAGED_I8,
                                  lambda: _serve(srv, prompts, 32))
    finally:
        srv.stop()
    n_tok = sum(len(q.output_ids) for q in done.values())
    full = [ms for n, ms in step_ms if n == 8]
    ttft = [(q.first_token_time - t0) * 1e3 for q in done.values()]
    if not full:
        raise AssertionError("no decode iteration ran with 8 slots")
    res = dict(server_tok_s=n_tok / wall,
               server_decode_iter_ms_8slots=statistics.median(full),
               server_ttft_median_ms=statistics.median(ttft),
               server_ttft_max_ms=max(ttft), server_wall_s=wall)
    log(f"server (paged int8, batch 8, page 256, 12 queries, prompts {lens}, "
        f"32 new each): {n_tok} tokens in {wall:.2f} s = "
        f"{res['server_tok_s']:.1f} tok/s aggregate; decode iteration with "
        f"8 running slots median {res['server_decode_iter_ms_8slots']:.3f} "
        f"ms over {len(full)}; TTFT from issue median "
        f"{res['server_ttft_median_ms']:.1f} ms, max "
        f"{res['server_ttft_max_ms']:.1f} ms")
    for i in range(3):
        log(f"  query {i} ({lens[i]} tokens): {done[i].output_ids}")
    del srv, sched
    torch.cuda.empty_cache()

    for name, kw, required, queries, n_new in (
            ("server_slots_bf16", dict(kv_mode="slots"),
             ("qmm4_npack", "qmm_a8", "flash_prefill", "flash_decode"),
             [p[:n] for p, n in zip(prompts, (64, 300, 700, 1200))], 16),
            ("server_paged_bf16", dict(kv_mode="paged", page_size=256),
             ("qmm4_npack", "flash_prefill", "paged_decode"),
             [p[:n] for p, n in zip(prompts, (90, 200))], 8)):
        srv = ModelServer(params, CFG, max_batch=8, max_len=S_CACHE,
                          memory_dtype="auto", **kw)
        try:
            done, _, wall = run_path(name, required,
                                     lambda: _serve(srv, queries, n_new))
        finally:
            srv.stop()
        log(f"{name}: {len(queries)} queries, {n_new} new each, in "
            f"{wall:.2f} s; query 0: {done[0].output_ids}")
        del srv
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------


KERNEL_META = {
    # results key: (C entry point, source, TPU kernel it replaces)
    "K1": ("qmm4_npack", "neural_tpu_torch/csrc/qmm4_npack.cu",
           "neural_tpu/ops/qmatmul.py:619"),
    "K2": ("qmm_a8", "neural_tpu_torch/csrc/qmm_a8.cu",
           "neural_tpu/ops/qmatmul.py:161"),
    "K3": ("flash_prefill", "neural_tpu_torch/csrc/flash_prefill.cu",
           "neural_tpu/ops/attention.py:433"),
    "K3_i8": ("flash_prefill_i8", "neural_tpu_torch/csrc/flash_prefill.cu",
              "neural_tpu/ops/attention.py:433"),
    "K4": ("flash_decode", "neural_tpu_torch/csrc/flash_decode.cu",
           "neural_tpu/ops/attention.py:110"),
    "K4_i8": ("flash_decode_i8", "neural_tpu_torch/csrc/flash_decode.cu",
              "neural_tpu/ops/attention.py:110"),
    "K6": ("paged_decode", "neural_tpu_torch/csrc/paged_decode.cu",
           "neural_tpu/ops/paged_attention.py:31"),
    "K6_i8": ("paged_decode_i8", "neural_tpu_torch/csrc/paged_decode.cu",
              "neural_tpu/ops/paged_attention.py:31"),
    "K5": ("qmm_general", "neural_tpu_torch/csrc/qmm_general.cu",
           "neural_tpu/ops/qmatmul.py:485"),
    "K1_asym": ("qmm4_npack_asym", "neural_tpu_torch/csrc/qmm4_npack.cu",
                "neural_tpu/ops/qmatmul.py:619"),
    "K1_int2": ("qmm2_npack", "neural_tpu_torch/csrc/qmm4_npack.cu",
                "neural_tpu/ops/qmatmul.py:619"),
    "K1_int2_asym": ("qmm2_npack_asym", "neural_tpu_torch/csrc/qmm4_npack.cu",
                     "neural_tpu/ops/qmatmul.py:619"),
    "K1_int8": ("qmm8_native", "neural_tpu_torch/csrc/qmm4_npack.cu",
                "neural_tpu/ops/qmatmul.py:619"),
    "K1_int8_asym": ("qmm8_native_asym",
                     "neural_tpu_torch/csrc/qmm4_npack.cu",
                     "neural_tpu/ops/qmatmul.py:619"),
    "K2_asym": ("qmm_a8_asym", "neural_tpu_torch/csrc/qmm_a8.cu",
                "neural_tpu/ops/qmatmul.py:161"),
    "K2_act": ("quantize_act_i8", "neural_tpu_torch/csrc/qmm_a8.cu",
               "neural_tpu/ops/qmatmul.py:161"),
}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    t_start = time.time()
    seconds = {}

    def phase(name, fn, *args):
        t = time.time()
        out = fn(*args)
        seconds[name] = time.time() - t
        log(f"phase {name}: {seconds[name]:.1f} s")
        return out

    smi, name, bw = phase("1 device", phase_device)
    build_s = phase("2 build", _cuda.build_all, _cuda.KERNELS)
    for k in _cuda.KERNELS:
        k.load()
    log(f"built {[k.source for k in _cuda.KERNELS]} in {build_s:.1f} s")

    results = {}
    gen = torch.Generator(device=DEV).manual_seed(0)

    def kernels():
        for check in (check_k1, check_k2, check_k3, check_k4, check_k3_i8,
                      check_k4_i8, check_k6, check_k5, check_k1_branches,
                      check_k2_asym):
            check(gen, results)
            torch.cuda.empty_cache()
    phase("3 kernels", kernels)
    t = time.time()
    params = init_random(CFG, seed=0, quant="q4_j", device=DEV)
    torch.cuda.synchronize()
    log(f"init_random Llama-2-7B q4_j on the card: {time.time() - t:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    e2e = phase("4 generation", phase_generation, params)
    e2e.update(phase("4b formats", phase_formats))
    worst, sched_worst, formats_worst = phase("5 card vs plain",
                                              phase_card_vs_plain)
    e2e.update(phase("6 server", phase_server, params))
    del params
    torch.cuda.empty_cache()

    kernels = []
    for kid, (kname, src, repl) in KERNEL_META.items():
        r = results[kid]
        by_path = {p: c[kname] for p, c in LAUNCHES.items() if c[kname]}
        if not by_path:
            raise AssertionError(f"{kname} was launched on no main path")
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "per": r["per"], "ok": True,
            **({"cases": r["cases"]} if "cases" in r else {})})
    log(json.dumps({"e2e": e2e, "copy_tb_s": bw / 1e12,
                    "card_vs_plain_rel_err": worst,
                    "sched_card_vs_plain_rel_err": sched_worst,
                    "formats_card_vs_plain_rel_err": formats_worst,
                    "phase_seconds": seconds,
                    "seconds": time.time() - t_start}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
