"""Smoke run of the PyTorch / CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --ab PARENT_DIR   # K1/K3/K4/K6, phase 4/4b and
                                            # server legs, parent vs this

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi), and a measured
   device-to-device copy rate;
2. build: the kernels of ``neural_tpu_torch/csrc`` from source, one nvcc
   per source, all at once;
3. kernels: each kernel (K1 at M=1 and 8, K2, K3 and K4 in their bf16
   and int8 variants, K6 paged decode in both) against its plain PyTorch
   version on the same CUDA tensors at the Llama-2-7B q4_j main-path
   shapes, with its time, the plain version's time, one library call's
   time (a yardstick the port never calls: ``torch.matmul``,
   ``scaled_dot_product_attention``, or a compiled ``flex_attention``
   where the softcap or a window applies) and its bound; K1 (M=1 and 8)
   and K2 (M=1975) also at Gemma-2-9B's widths; K3, K4 and K6 also at
   Gemma-2-9B's heads (16 over 8, head dim 256, softcap 50) with window
   4096 and 0 at fill or prompt 6000, K3 on a 1975-token prompt, K6 at
   batch 8 with mixed fills, and at head dim 128 with the softcap and a
   window (K4 and K3 must be faster with the window than without); then
   the ALiBi branches of K3 (Bloom-7B1's 1975-token prefill, 32 heads),
   K4 (fills 1975 and 128) and K6 (B=8, mixed fills) and K3's GLM prefix
   branch (ChatGLM-6B's 1975-token prefill, all of it the prefix), bf16
   and int8, each also timed with its option off and held against a
   compiled ``flex_attention`` with the same score_mod / mask_mod; K3 also
   at the server's 512-token chunk at position 1024 of 2048; K6 also over
   pages of 16 and 32 keys, over a table whose entries past each fill
   point at other rows' live pages (the rows past each fill holding large
   finite K/V), and over an identity table on K4's own cache against K4
   (the two times side by side); every K1/K3/K4/K6 case printed beside the
   time of the kernel it replaces (``ATTN_BEFORE_MS``, ``K16_BEFORE_MS``)
   and the slower ones listed; then
   K5 on both of its routes, each launch counted under its route
   (``qmm_general+gemv`` at M <= 16, ``qmm_general+tc`` above): nf4 at
   M=1, 8 and 1975, q4_0 at 1975, q4_j at 128, 64, 32 and 24, fp4, fp8
   e4m3/e5m2, int1 and bit-plane int3 asym at 1, and every layout (with
   native-pack nibbles and int2, and int8 codes) again at M=1 and 128,
   each case printed beside the PR 1-7 time it replaces; K1's other
   entry points (asym nibbles, int2 and int8 codes, sym and asym) at M=1
   and 8, and K2-asym at 1975, the same way, and every K2 entry point's
   largest difference from its plain version on one 7B product beside the
   parent tree's (``k2_errors``, ``PARENT_K2_ERR``); K1's fusion options (the
   RMS-norm and glu prologues, the residual epilogue) at M=1 and 8 over
   the three sym layouts, at the 7B's widths and at Gemma-2-9B's with the
   (1 + w) norm and tanh GELU, each also timed against the unfused chain
   it replaces (the port's ``rms_norm`` / ``act(g) * u`` / bf16 add and
   K1); every K1 entry point launched twice on the same inputs, the two
   outputs bit-identical, and the fused rms route against the unfused
   chain (their largest difference logged); the row-norm kernel
   (``rms_norm.cu``, the unfused graph's RMS norm on K1's row-scale
   routine) against the torch chain at a decode step's rows and a
   prefill's, beside ``torch.nn.functional.rms_norm``;
4. generation: a Llama-2-7B-shaped q4_j model (random weights from a seed,
   FFN 11008 padded to 11264) generates greedily through ``Model.generate``
   with bf16 and with int8 KV, every launch count set to 0 just before each
   path and read just after; ``decode_loop``'s CUDA graph against eager
   steps; decode ms/token (slope of ``decode_loop`` n=4 vs n=36) at fills
   128 and 1975 (bf16 KV), at fill 1975 with int8 KV (leg decode_i8kv) and
   at batch 8, fill 128, int8 KV (leg batch8); the 1975-token prefill time
   (TTFT) with bf16 and int8 KV; the fused decode path's A/B on the same
   model: ``Model.generate`` and ``decode_loop`` unfused, fused and fused
   with GLU (``NTPU_FUSED_DECODE``, ``NTPU_FUSE_GLU``), ids against the
   unfused ones where the margin proves them, every K1 launch of a fused
   step through a fused entry point; the decode step's CUDA graph at fills
   128 and 1975, bf16 and int8 KV, and at batch 8, each captured in the
   three modes and replayed in turns, device-timed; the host-clock legs
   and the TTFT by mode; then (4b) the same model at nf4, q4_0 and
   q4_j_i8_g128, one at a time: ``Model.generate``, the TTFT and decode
   ms/token at fill 128, each a path with its own launch counts; then
   (4c) Gemma-2-9B at full depth, q4_j (random weights from a seed):
   ``Model.generate`` with bf16 and int8 KV, decode ms/token at fills 128
   and 6000 (bf16 KV) and 6000 (int8 KV), TTFT at 1975 and 6000 tokens,
   caches of 8192 positions, each a path with its launch counts; (4d)
   Bloom-7B1 at full depth (``bigscience/bloom-7b1``'s config, q4_j,
   random weights): ``Model.generate`` with bf16 and int8 KV, decode at
   fills 128 and 1975, TTFT at 1975 tokens, peak memory; (6b, run while its
   weights are loaded) its batch-8 paged int8 ``ModelServer`` over phase
   6's 12 queries, and a short paged bf16 run; (4e) ChatGLM-6B at full
   depth (``THUDM/chatglm-6b``'s config): ``Model.generate`` with bf16 and
   int8 KV, decode at fill 128, TTFT at 1975 tokens, all of it the prefix;
   and (4i, right after phase 4, on its 7B) the sampling slice:
   ``Model.generate(do_sample=True, top_k=40, top_p=0.95, temperature=0.8)``
   on a 512-token prompt with one seed twice (ids equal) and another (ids
   differ); ``sample_loop``'s graphed step (replays from one pinned state
   draw different ids, a seed fixes the ids) and its device ms a step at
   fill 128, batch 1 and 4, replayed in turns with ``decode_loop``'s
   greedy graph; four ragged prompts (128, 512, 1024, 1975
   tokens, 32 new each) through one padded prefill and a batched decode,
   their ids against the row-wise ones where the margins prove them;
   ``num_beams=4`` on a 128-token prompt, one beam step's device-clock
   time and ``reorder_batch``'s;
   ``streaming=True`` over a 512-position cache (bf16 and int8 KV, 600 new
   tokens, two shifts) and the shift's time; ``sample_batched``'s and
   ``sample``'s draws over one 32000-wide row in 4096 rows against the
   filtered softmax (chi-square) and the sampler's device times. Phase 4 also holds C5:
   the fused decode path's logits equal the unfused ones exactly, and the
   fused rms prologue equals the norm kernel then K1 over the 7B's own
   residual rows;
5. card vs plain: a one-layer copy at the same width runs its prefill logits
   and greedy steps through the kernels on the card and through the plain
   path on the CPU, and the card's fused path (with and without GLU)
   against the same CPU rows; then the same through the Scheduler (paged
   int8 KV, batch 4, 6 requests); then, for fp4, fp8, fp8_e5m2, int1,
   int2, int2 asym, int3, int5, int5 asym, q8_0 and int8 (per channel),
   ``Model.generate`` on the card (a
   path each) and its logits against the plain path; logits within
   tolerance, greedy ids equal where the margin proves it (the formats'
   copies have one layer); (5b) a 2-layer
   Gemma-2-9B copy with its window cut to 32 (so that it acts on every
   prompt there): ``Model.generate`` on the card, its logits against the
   plain path, and the paged int8 Scheduler check; (5c) one-layer full-width
   copies of Bloom-7B1, MPT-7B and ChatGLM-6B (100-token prompts, bf16
   activations, tolerance 2e-2·max|logit|) the same way, and the paged
   int8 Scheduler check on the Bloom copy; on phase 5's copy also beam
   search (4 beams) and the first StreamingLLM shift (bf16 and int8, from
   the CPU's cache) against the CPU, and a copy with a 32001-wide
   quantized lm_head through the counted ``qmm_plain`` route (K1 and K5
   refuse it) against the CPU; and through the Scheduler a beam group
   (slots bf16, paged int8; the CPU run forced to the card's beams, every
   expansion's logits rows held to the card's and its choices proven
   where the margins allow), graphed StreamingLLM slots through their
   first shift (ids by the margins, each card shift against the plain
   shift of the same row) and decode blocks (equal to the card's single
   steps);
   Then (4f) Mistral-7B as a GPTQ int4 act-order checkpoint (its state
   dict synthesized on the host, converted on the card by
   ``params_from_gptq_state_dict``): ``Model.generate`` with bf16 and
   int8 KV, decode at fills 128 and 1975, TTFT at 1975 tokens with bf16
   and int8 KV, peak memory, the act-order gather timed alone; (4g)
   Llama-2-7B at q6_sym_g128_a8 and mix_i2_ffn as phase 4b's formats,
   each also generating with the fused path and GLU on;
   (4h) TinyLlama-1.1B (head dim 64: ``attend_xla``, no K3/K4/K6 launch)
   through ``Model.generate``, the paged int8 Scheduler, decode at fill
   128, TTFT; (5d) one-layer copies against the CPU plain path: Mistral
   GPTQ (``Model.generate``, the paged int8 Scheduler, and the copy
   written as a checkpoint directory and loaded with ``Model.init(dir,
   use_gptq=True)``), AWQ, mix_int2_int4, every K2 layout at act_bits 8,
   linear RoPE scaling, TinyLlama, and 32 heads over 2 (G = 16); a copy
   with StarCoder's 48 heads over 1 on the card alone. Phase 3 also holds
   K2 over int8 codes, int2 and int3 (sym and asym), K1-asym and K5 at
   Mistral GPTQ's widths, and K4/K6 at G = 16 and 48 against their plain
   versions.
6. serving: the same 7B model behind ``ModelServer(max_batch=8,
   max_len=2048, kv_mode="paged", page_size=256, memory_dtype="int8")``
   answers 12 queries (prompts of 32-1500 tokens, 32 new tokens each) with
   launch counts; the graphed decode step against the same steps run
   eagerly (ids and pool bytes), also with the fused path on (with and
   without GLU, the graph's K1 launches all fused); short slots-mode bf16
   and paged bf16 runs;
   aggregate tok/s, decode-iteration ms at 8 running slots, TTFT; then
   (6c) serving beyond greedy on the same model: the paged int8 server
   answers 12 mixed queries (greedy, sampled, mirostat v2, a 4-beam query
   on a 128-token prompt): greedy ids equal a greedy-only run's; the
   beam query teacher-forced: its logits rows at every expansion equal to
   the bit to an eager Scheduler's with a plain host-staged KV copy, and
   within 0.1·max|logit| of ``beam_search``'s, a run with its reorders
   skipped failing that hold; the mix through the Scheduler with one seed
   twice and another; StreamingLLM slots (512 positions, bf16 and int8
   KV, 8 queries × 600 new tokens, two shifts a slot): query 0's rows
   within 0.1·max|logit| of a batch-1 stream fed its ids, equal to the
   bit to an eager Scheduler's through the first shift, its ids against
   ``stream_generate`` by the margins; decode
   blocks of 8 against single steps; tok/s, the decode iteration with and
   without a beam group, and the page reorder, slot reorder and per-slot
   shift timed alone.

The last lines are a ``{"kernels": [...]}`` JSON line, the nvidia-smi line,
and ``{"ok": true, "device": {...}}``. Exits non-zero without a result when
no CUDA device is present.
"""
import contextlib
import dataclasses
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from neural_tpu_torch.api import Model  # noqa: E402
from neural_tpu_torch.convert.gptq import \
    params_from_gptq_state_dict  # noqa: E402
from neural_tpu_torch.convert.hf import init_random  # noqa: E402
from neural_tpu_torch.convert.quant_registry import \
    QuantRegistry  # noqa: E402
from neural_tpu_torch.core.dtypes import (PRESETS, QuantConfig,  # noqa: E402
                                          quant_config_from_args)
from neural_tpu_torch.core.qtensor import (dequantize, quantize,  # noqa: E402
                                           to_native, to_native_packed)
from neural_tpu_torch.models import bloom, chatglm, llama, mpt  # noqa: E402
from neural_tpu_torch.models.config import ModelConfig  # noqa: E402
from neural_tpu_torch.ops import _cuda  # noqa: E402
from neural_tpu_torch.ops import attention as A  # noqa: E402
from neural_tpu_torch.ops import paged_attention as PA  # noqa: E402
from neural_tpu_torch.ops import qmatmul as Q  # noqa: E402
from neural_tpu_torch.ops.norms import rms_norm, rms_norm_plain  # noqa: E402
from neural_tpu_torch.ops.rope import alibi_slopes, rope_freqs  # noqa: E402
from neural_tpu_torch.runtime import streaming as ST  # noqa: E402
from neural_tpu_torch.runtime import beam as BEAM  # noqa: E402
from neural_tpu_torch.runtime.beam import _beam_step, beam_search  # noqa: E402
from neural_tpu_torch.runtime.generate import (_Graph,  # noqa: E402
                                               _SampledStep,
                                               _StepGraph, _prefill_ragged,
                                               sample_loop,
                                               decode_loop,
                                               greedy_generate, model_step,
                                               prefill_step)
from neural_tpu_torch.runtime.kvcache import (copy_kv,  # noqa: E402
                                              init_cache, reorder_batch)
from neural_tpu_torch.runtime.paged import init_paged_cache  # noqa: E402
from neural_tpu_torch.runtime.sampling import (  # noqa: E402
    SamplingParams, apply_penalties, batch_params, draw_noise, sample,
    sample_batched, token_counts, top_k_filter, top_p_filter)
from neural_tpu_torch.serving import (ModelServer, Query,  # noqa: E402
                                      Scheduler)
from neural_tpu_torch.serving import scheduler as SCHED  # noqa: E402

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
# The depth of the copies held against the CPU's plain path (phases 5, 5c
# and 5d): one layer runs every kernel and branch of a copy, and the plain
# path's CPU time, most of the script's, grows with each layer. Gemma-2's
# copy (5b) keeps two: a sliding and a global layer.
COPY_LAYERS = 1


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


# a sym K1 entry point a path requires is also met by its fused twin: the
# fused decode path, which this script turns on for every phase (``main``),
# takes the decode steps' products there (the plain entries are required on
# the explicitly unfused paths, and every entry of the kernels line on some
# path)
FUSED_TWIN = {fn: fn + "_fused" for fn in _cuda.K1_ENTRIES}


def run_path(name, required, fn):
    """Drive one main path with every launch count set to 0 just before and
    read just after; fail if a kernel of the path was never launched."""
    _cuda.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    LAUNCHES[name] = counts
    missing = [k for k in required
               if counts[k] == 0 and counts.get(FUSED_TWIN.get(k), 0) == 0]
    log(f"path {name}: launches {counts}")
    if missing:
        raise AssertionError(f"kernels not launched on path {name}: "
                             f"{missing}")
    return out


# The fusion switches of K1's fused decode path (``models/transformer.py
# fuse_mode``), each leg of phase 4's A/B: (name, NTPU_FUSED_DECODE,
# NTPU_FUSE_GLU)
UNFUSED, FUSED, FUSED_GLU = MODES = (("unfused", "0", "0"),
                                     ("fused", "1", "0"),
                                     ("fused_glu", "1", "1"))


@contextlib.contextmanager
def fusion(mode):
    """Run the block under the switches of ``mode``; the model reads them
    at each forward call, so a capture inside records that path."""
    keys = ("NTPU_FUSED_DECODE", "NTPU_FUSE_GLU")
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update(zip(keys, mode[1:]))
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def k1_step_launches(mode, n_layers=L):
    """K1's launches in one decode step of a Llama-shaped q4_j model (7
    products a layer and the lm_head) under ``mode``: every one through a
    fused entry point when the fusion is on (q/k/v and gate/up ``+rms``,
    wo and w_down ``+res``, the lm_head ``+rms``; w_down ``+glu`` too with
    GLU), none when it is off."""
    n = 7 * n_layers + 1
    if mode is UNFUSED:
        return {"qmm4_npack": n, "qmm4_npack_fused": 0}
    return {"qmm4_npack": 0, "qmm4_npack_fused": n,
            "qmm4_npack_fused+rms": 5 * n_layers + 1,
            "qmm4_npack_fused+res": 2 * n_layers,
            "qmm4_npack_fused+glu": n_layers if mode is FUSED_GLU else 0}


def check_step_launches(recorded, mode, what, n_layers=L):
    """A captured decode step's K1 launches are those of ``mode``."""
    want = k1_step_launches(mode, n_layers)
    got = {k: recorded.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{what} ({mode[0]}): K1 launches {got}, "
                             f"expected {want}")


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
# Gemma-2-9B's (42 layers): q, k/v, o, gate/up, down; its lm_head is the
# tied embedding, a torch product
G2_PROJ = [(3584, 4096, 42), (3584, 2048, 84), (4096, 3584, 42),
           (3584, 14336, 84), (14336, 3584, 42)]


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


# The times the redesigned K2 and K5 replace: each case's kernel time per
# step or prefill in ms, from PERF.md section 6 (chip_smoke.py runs on an
# H100 80GB HBM3 at 700 W, PRs 1-7), by (results key, case label), or by
# results key for a K2 layout's one case, or by case label for K5
PR17_MS = {
    ("K2", "1975-token prefill"): 184.5,
    ("K2", "gemma2 1975-token prefill"): 235.6,
    ("K2_act", "1975-token prefill"): 6.053,
    ("K2_asym", "q4_j_i8_g128 1975-token prefill"): 217.8,
    "K2_int8": 183.0, "K2_int8_asym": 219.7, "K2_int2": 155.4,
    "K2_int2_asym": 189.6, "K2_int3": 180.3, "K2_int3_asym": 216.2,
    "nf4 decode step": 29.40, "nf4 1975-token prefill": 619.8,
    "q4_0 1975-token prefill": 335.3, "mistral gptq 1975-token prefill":
    351.5, "fp4 decode step": 29.42, "fp8_e4m3 decode step": 10.49,
    "int1 decode step": 27.28, "q4_j server chunk": 29.96,
}


# The times of the K3 and K4 kernels the redesigned ones replace, per token,
# step or prefill in ms, from PERF.md section 6 (chip_smoke.py runs on an
# H100 80GB HBM3 at 700 W, before the redesign), by (results key, case
# label); None: that case was not timed
_FILLS8 = "[1, 2048, 1975, 128, 700, 1300, 33, 1024]"
_G2_FILLS8 = "[1, 8192, 6000, 128, 4500, 3000, 33, 4097]"
ATTN_BEFORE_MS = {
    ("K3", "llama 1975-token prefill, window 0, softcap 0"): 10.30,
    ("K3", "gemma2 6000-token prefill, window 4096, softcap 50"): 53.77,
    ("K3", "gemma2 6000-token prefill, window 0, softcap 50"): 62.84,
    ("K3", "gemma2 1975-token prefill, window 4096, softcap 50"): 22.33,
    ("K3", "head dim 128 1975-token prefill, window 1024, softcap 50"): 0.405,
    ("K3", "llama 512-token chunk at 1024, window 0, softcap 0"): None,
    ("K3_i8", "llama 1975-token prefill, window 0, softcap 0"): 11.40,
    ("K3_i8", "gemma2 6000-token prefill, window 4096, softcap 50"): 64.09,
    ("K3_i8", "gemma2 6000-token prefill, window 0, softcap 50"): 75.65,
    ("K3_i8", "gemma2 1975-token prefill, window 4096, softcap 50"): 25.78,
    ("K3_i8", "head dim 128 1975-token prefill, window 1024, softcap 50"):
    0.455,
    ("K3_i8", "llama 512-token chunk at 1024, window 0, softcap 0"): None,
    ("K3_alibi", "bloom 1975-token prefill, alibi"): 10.25,
    ("K3_prefix", "chatglm 1975-token prefill, prefix"): 13.94,
    ("K3_i8_alibi", "bloom 1975-token prefill, alibi"): 11.13,
    ("K3_i8_prefix", "chatglm 1975-token prefill, prefix"): 15.23,
    ("K4", "llama decode fill 1975, window 0, softcap 0"): 1.395,
    ("K4", "llama decode fill 128, window 0, softcap 0"): None,
    ("K4", "gemma2 decode fill 6000, window 4096, softcap 50"): 1.799,
    ("K4", "gemma2 decode fill 6000, window 0, softcap 50"): 1.942,
    ("K4", "head dim 128 decode fill 1975, window 1024, softcap 50"): 0.0371,
    ("K4_i8", "llama decode fill 1975, window 0, softcap 0"): 1.190,
    ("K4_i8", "llama decode fill 128, window 0, softcap 0"): None,
    ("K4_i8", "gemma2 decode fill 6000, window 4096, softcap 50"): 1.444,
    ("K4_i8", "gemma2 decode fill 6000, window 0, softcap 50"): 1.609,
    ("K4_i8", "head dim 128 decode fill 1975, window 1024, softcap 50"):
    0.0345,
    ("K4_alibi", "bloom decode fill 1975, alibi"): 1.291,
    ("K4_alibi", "bloom decode fill 128, alibi"): 0.910,
    ("K4_i8_alibi", "bloom decode fill 1975, alibi"): 1.175,
    ("K4_i8_alibi", "bloom decode fill 128, alibi"): 0.910,
    ("K4_G>8", "chatglm2 heads (32 over 2) decode fill 1975"): 1.298,
    ("K4_G>8", "starcoder heads (48 over 1) decode fill 1975"): 1.732,
    ("K4_i8_G>8", "chatglm2 heads (32 over 2) decode fill 1975"): 1.511,
    ("K4_i8_G>8", "starcoder heads (48 over 1) decode fill 1975"): 2.085,
}
ATTN_SLOWER = []    # (key, label, ms, earlier ms) of K3/K4 cases now slower

# The times of the K1 and K6 kernels the redesigned ones replace, per token,
# step or launch sum in ms, from PERF.md section 6 (chip_smoke.py runs on an
# H100 80GB HBM3 at 700 W, before the redesign), by (results key, case
# label); None: a case this script did not run before
K16_BEFORE_MS = {
    ("K1", "q4_j decode step"): 3.757,
    ("K1", "q4_j batch-8 step"): 7.827,
    ("K1", "gemma2 q4_j decode step"): 4.822,
    ("K1", "gemma2 q4_j batch-8 step"): 10.08,
    ("K1_asym", "q4_j_i8_g128 decode step"): 4.860,
    ("K1_asym", "q4_j_i8_g128 batch-8 step"): 9.585,
    ("K1_asym", "mistral gptq decode step"): 3.604,
    ("K1_int2", "int2 decode step"): 3.142,
    ("K1_int2", "int2 batch-8 step"): 7.907,
    ("K1_int2_asym", "int2_asym decode step"): 4.335,
    ("K1_int2_asym", "int2_asym batch-8 step"): 9.401,
    ("K1_int8", "int5 decode step"): 5.977,
    ("K1_int8", "int5 batch-8 step"): 10.83,
    ("K1_int8_asym", "int5_asym decode step"): 5.732,
    ("K1_int8_asym", "int5_asym batch-8 step"): 12.41,
    ("K1_rms", "q4_j rms, decode step"): 3.053,
    ("K1_rms", "q4_j rms, decode step (batch 8)"): 6.896,
    ("K1_rms", "gemma2 q4_j rms (1 + w), decode step"): 3.877,
    ("K1_rms", "gemma2 q4_j rms (1 + w), decode step (batch 8)"): 8.716,
    ("K1_res", "q4_j res, decode step"): 1.098,
    ("K1_res", "q4_j res, decode step (batch 8)"): 2.342,
    ("K1_glu", "q4_j glu silu + res, decode step"): 0.712,
    ("K1_glu", "q4_j glu silu + res, decode step (batch 8)"): 1.860,
    ("K1_glu", "gemma2 q4_j glu gelu_tanh + res, decode step"): 0.990,
    ("K1_glu", "gemma2 q4_j glu gelu_tanh + res, decode step (batch 8)"):
    2.748,
    ("K1_int2_fused", "int2 rms, gate/up"): 1.342,
    ("K1_int2_fused", "int2 rms, gate/up (batch 8)"): 3.664,
    ("K1_int2_fused", "int2 glu silu + res, down"): 0.657,
    ("K1_int2_fused", "int2 glu silu + res, down (batch 8)"): 1.641,
    ("K1_int8_fused", "int5 rms, gate/up"): 2.014,
    ("K1_int8_fused", "int5 rms, gate/up (batch 8)"): 5.925,
    ("K1_int8_fused", "int5 glu silu + res, down"): 0.974,
    ("K1_int8_fused", "int5 glu silu + res, down (batch 8)"): 2.581,
    ("K6", f"llama B=8 decode fills {_FILLS8}, window 0, softcap 0"): 3.438,
    ("K6", "gemma2 B=1 decode fills [6000], window 4096, softcap 50"): 1.891,
    ("K6", "gemma2 B=1 decode fills [6000], window 0, softcap 50"): 1.937,
    ("K6", f"gemma2 B=8 decode fills {_G2_FILLS8}, window 4096, softcap 50"):
    3.819,
    ("K6", f"head dim 128 B=8 decode fills {_FILLS8}, window 512, softcap "
     "50"): 0.0606,
    ("K6_i8", f"llama B=8 decode fills {_FILLS8}, window 0, softcap 0"):
    2.795,
    ("K6_i8", "gemma2 B=1 decode fills [6000], window 4096, softcap 50"):
    1.256,
    ("K6_i8", "gemma2 B=1 decode fills [6000], window 0, softcap 50"): 1.476,
    ("K6_i8", f"gemma2 B=8 decode fills {_G2_FILLS8}, window 4096, softcap "
     "50"): 2.971,
    ("K6_i8", f"head dim 128 B=8 decode fills {_FILLS8}, window 512, "
     "softcap 50"): 0.0471,
    ("K6_alibi", f"bloom B=8 decode fills {_FILLS8}, alibi"): 3.296,
    ("K6_i8_alibi", f"bloom B=8 decode fills {_FILLS8}, alibi"): 2.791,
    ("K6_G>8", f"chatglm2 heads (32 over 2) B=8 decode fills {_FILLS8}"):
    1.374,
    ("K6_G>8", f"starcoder heads (48 over 1) B=8 decode fills {_FILLS8}"):
    2.233,
    ("K6_i8_G>8", f"chatglm2 heads (32 over 2) B=8 decode fills {_FILLS8}"):
    1.425,
    ("K6_i8_G>8", f"starcoder heads (48 over 1) B=8 decode fills "
     f"{_FILLS8}"): 2.378,
    ("K6", f"llama B=8 decode fills {_FILLS8}, page 16"): None,
    ("K6", f"llama B=8 decode fills {_FILLS8}, page 32"): None,
    ("K6", f"llama B=8 decode fills {_FILLS8}, table past the fill at live "
     "pages"): None,
    ("K6", "llama B=1 decode fill 1975, identity table (K4's cache)"): None,
    ("K6_i8", f"llama B=8 decode fills {_FILLS8}, page 16"): None,
    ("K6_i8", f"llama B=8 decode fills {_FILLS8}, page 32"): None,
    ("K6_i8", f"llama B=8 decode fills {_FILLS8}, table past the fill at "
     "live pages"): None,
    ("K6_i8", "llama B=1 decode fill 1975, identity table (K4's cache)"):
    None,
}
K16_SLOWER = []     # (key, label, ms, earlier ms) of K1/K6 cases now slower


def _record(results, key, cases, window_ms=None):
    """The first case is the kernel's line; every case is kept beside it,
    and an attention kernel's per-launch times at fill 6000 by window.
    Every case is printed beside the time of the kernel it replaces."""
    first = next(iter(cases.values()))
    results[key] = dict(first, cases=cases, window_ms=window_ms)
    for label, c in cases.items():
        _beside_before(key, label, c)
    _record_k2k5(key, cases)


def _beside_before(key, label, c):
    """A K1, K3, K4 or K6 case beside the time of the kernel it replaces;
    a case now slower is listed."""
    if not key.startswith(("K1", "K3", "K4", "K6")):
        return
    table, slower = (K16_BEFORE_MS, K16_SLOWER) if key.startswith(
        ("K1", "K6")) else (ATTN_BEFORE_MS, ATTN_SLOWER)
    if (key, label) not in table:
        raise AssertionError(f"{key} {label}: no earlier time")
    before = table[(key, label)]
    ratio = "" if before is None else f", {c['ms'] / before:.3f}x of it"
    lib = c.get("library_ms")
    log(f"{key} {label}: kernel {c['ms']:.4f} ms, bound "
        f"{c['bound_ms']:.4f} ms ({c['bound_by']}), library "
        f"{'n/a' if lib is None else round(lib, 4)} ms, before "
        f"{'not measured' if before is None else before} ms{ratio}")
    if before is not None and c["ms"] > before:
        slower.append((key, label, c["ms"], before))


def _record_k2k5(key, cases):
    """A K2/K5 case beside the time of the kernel it replaces."""
    if key.startswith(("K2", "K5")):
        for label, c in cases.items():
            before = PR17_MS.get((key, label), PR17_MS.get(
                label if key.startswith("K5") else key))
            log(f"{key} {label}: kernel {c['ms']:.4f} ms, bound "
                f"{c['bound_ms']:.4f} ms ({c['bound_by']}), library "
                f"{c['library_ms'] if c.get('library_ms') is None else round(c['library_ms'], 4)} ms, "
                f"PR 1-7 {before if before is not None else 'not measured'}"
                " ms")


def check_k1(gen, results):
    """K1 over sym int4 (q4_j) at M=1 (batch 1) and M=8 (the server's
    batch-8 step): q/k/v/o, gate/up, down and the lm_head."""
    k1 = lambda x, qt, odt: Q.qmm_native(x, qt.planes[0], qt.scales, None,
                                         qt.group_size, 4, odt)
    pl = lambda x, qt, odt: Q.qmm_native_plain(x, qt.planes[0], qt.scales,
                                               None, qt.group_size, 4, odt)
    _record(results, "K1", {
        label: _case(gen, label, PRESETS["q4_j"], M, shapes, k1, pl,
                     "qmm4_npack", BF16_FLOPS)
        for M, label, shapes in (
            (1, "q4_j decode step", PROJ + LM_HEAD),
            (8, "q4_j batch-8 step", PROJ + LM_HEAD),
            (1, "gemma2 q4_j decode step", G2_PROJ),
            (8, "gemma2 q4_j batch-8 step", G2_PROJ))})


def check_k2(gen, results):
    """Prefill products at M=1975 through the int8-activation path, at
    Llama-2-7B's and Gemma-2-9B's widths; and its first pass, the
    activation quantization, alone (its codes must equal the plain
    version's; its time is inside K2's, and PyTorch has no one call for
    it)."""
    cases, acts = {}, {}
    for label, shapes in (("1975-token prefill", PROJ),
                          ("gemma2 1975-token prefill", G2_PROJ)):
        agg, act = _k2_shapes(gen, shapes)
        n = sum(count for _, _, count in shapes)
        cases[label] = dict(agg, bound_by="operations",
                            per=f"{label} ({n} launches)")
        acts[label] = dict(act, library_ms=None, err=0.0,
                           per=f"{label} ({n} launches), inside K2's time")
        log(f"K2 quantize_act_i8 per {label}: kernel {act['ms']:.3f} ms, "
            f"plain {act['plain_ms']:.3f} ms, bound {act['bound_ms']:.4f} "
            f"ms ({act['bound_by']})")
    _record(results, "K2", cases)
    _record(results, "K2_act", acts)
    check_k2_errors()


def k2_errors(M=1975, K=4096, N=4096, seed=5):
    """The largest |kernel - plain| of one bf16 [M, K] @ [K, N] product
    through each K2 entry point (group 128, act_bits 8), inputs drawn with
    numpy from ``seed``: the same inputs on any tree of the port, so that
    ``--ab`` can hold this tree's K2 against the parent's. Self-contained
    (``--ab`` runs its source in each tree)."""
    import numpy as np
    import torch
    from neural_tpu_torch.core.dtypes import QuantConfig
    from neural_tpu_torch.core.qtensor import quantize, to_native
    from neural_tpu_torch.ops import qmatmul as Q
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32))
    x = x.to("cuda").bfloat16()
    out = {}
    for entry, bits, sym in (("qmm_a8", 4, True), ("qmm_a8_asym", 4, False),
                             ("qmm_a8_int2", 2, True),
                             ("qmm_a8_int2_asym", 2, False),
                             ("qmm_a8_int8", 6, True),
                             ("qmm_a8_int8_asym", 6, False),
                             ("qmm_a8+int3", 3, True),
                             ("qmm_a8_asym+int3", 3, False)):
        w = rng.standard_normal((K, N), dtype=np.float32) * 0.02
        qt = to_native(quantize(torch.from_numpy(w).to("cuda"),
                                QuantConfig(bits=bits, group_size=128,
                                            sym=sym, act_bits=8)))
        args = (qt.planes[0], qt.scales, 128, 128, torch.bfloat16, qt.zeros,
                bits)
        a, b = Q.qmm_a8(x, *args), Q.qmm_a8_plain(x, *args)
        out[entry] = (a.float() - b.float()).abs().max().item()
    return out


# k2_errors on the parent tree (PR 7, 37e0fb3), measured by
# ``chip_smoke.py --ab`` on an H100 80GB HBM3 at 700 W: every entry point
# equal to its plain version
PARENT_K2_ERR = {"qmm_a8": 0.0, "qmm_a8_asym": 0.0, "qmm_a8_int2": 0.0,
                 "qmm_a8_int2_asym": 0.0, "qmm_a8_int8": 0.0,
                 "qmm_a8_int8_asym": 0.0, "qmm_a8+int3": 0.0,
                 "qmm_a8_asym+int3": 0.0}


def check_k2_errors():
    """K2 keeps the parent's fold order, so its largest difference from
    the plain version is no larger than the parent's at each entry point."""
    errs = k2_errors()
    log(f"K2 max |kernel - plain| per entry point: {errs}; the parent's "
        f"(PR 7 tree, --ab): {PARENT_K2_ERR}")
    worse = {k: (v, PARENT_K2_ERR[k]) for k, v in errs.items()
             if v > PARENT_K2_ERR[k]}
    if worse:
        raise AssertionError(f"K2 differs from its plain version more than "
                             f"the parent's: {worse}")


def _k2_shapes(gen, shapes):
    M = T_PREFILL
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0)
    act = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for K, N, count in shapes:
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
    return agg, act


# K5's cases: (label, config, M, shapes, at rest). M <= 16 takes the gemv
# route, M > 16 the tensor-core tiles; every layout runs on both routes
# (the formats with no full-width path at one product of 4096 x 4096)
ONE = [(D, D, 1)]
K5_CASES = (
    ("nf4 decode step", "nf4", 1, PROJ + LM_HEAD, True),
    ("nf4 batch-8 step", "nf4", 8, PROJ + LM_HEAD, True),
    ("fp4 decode step", "fp4", 1, PROJ + LM_HEAD, True),
    ("fp8_e4m3 decode step", "fp8", 1, PROJ + LM_HEAD, True),
    ("fp8_e5m2 decode step", "fp8_e5m2", 1, PROJ + LM_HEAD, True),
    ("int1 decode step", "int1", 1, PROJ + LM_HEAD, True),
    ("int3 asym bit planes decode step", "int3_asym_planes", 1,
     PROJ + LM_HEAD, False),
    ("q4_j native-pack nibbles, one product at M=1", "q4_j", 1, ONE, True),
    ("int2 g16 asym native-pack, one product at M=1", "int2_g16_asym", 1,
     ONE, True),
    ("int5 int8 codes, one product at M=1", "int5", 1, ONE, True),
    ("nf4 1975-token prefill", "nf4", T_PREFILL, PROJ, True),
    ("q4_0 1975-token prefill", "q4_0", T_PREFILL, PROJ, True),
    ("q4_j server chunk", "q4_j", 128, PROJ, True),
    ("q4_j 64-token prompt", "q4_j", 64, PROJ, True),
    ("q4_j server chunk, 32 bucket", "q4_j", 32, PROJ, True),
    ("q4_j 24-token prompt", "q4_j", 24, PROJ, True),
    *((f"{fmt}, one product at M=128", fmt, 128, ONE, at_rest)
      for fmt, at_rest in (("fp4", True), ("fp8", True), ("fp8_e5m2", True),
                           ("int1", True), ("int3_asym_planes", False),
                           ("int2_g16_asym", True), ("int5", True))),
)
K5_CFGS = {"int3_asym_planes": QuantConfig(bits=3, group_size=32, sym=False),
           "int2_g16_asym": QuantConfig(bits=2, group_size=16, sym=False)}


def check_k5(gen, results):
    """K5 in every format of the main paths and every layout it reads, on
    both routes: nf4 decode (every product and the lm_head, M=1, and the
    batch-8 step) and prefill (M=1975); the q4_0 prefill; the q4_j model's
    products at M=128, 64 and 32 (server chunks in those buckets, and the
    64-token prompt of phase 4) and at M=24 (the 24-token prompt of phase
    5); fp4, fp8 e4m3/e5m2, int1 and bit-plane int3 asym (uint8
    zero-points, not at rest) at M=1; native-pack nibbles and int2 (group
    16, bf16 zero-points) and int8 codes at M=1; and each layout again at
    M=128, one product. Recorded per route (``K5_gemv``, ``K5_tc``) and
    together (``K5``)."""
    k5 = lambda x, qt, odt: Q.qmm_general(x, qt, odt)
    pl = lambda x, qt, odt: Q.qmm_general_plain(x, qt, odt)
    routes = {"gemv": {}, "tc": {}}
    for label, fmt, M, shapes, at_rest in K5_CASES:
        cfg = K5_CFGS.get(fmt) or PRESETS[fmt]
        route = Q.k5_route(M)
        routes[route][label] = _case(gen, label, cfg, M, shapes, k5, pl,
                                     f"qmm_general+{route}", BF16_FLOPS,
                                     at_rest)
        torch.cuda.empty_cache()
    _record(results, "K5_gemv", routes["gemv"])
    _record(results, "K5_tc", routes["tc"])
    results["K5"] = dict(results["K5_gemv"],
                         cases={**routes["gemv"], **routes["tc"]})


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


# K1's fusion options on a decode step (``qmatmul_fused``): the products
# whose input the RMS norm prologue makes (q/k/v, gate/up, the lm_head),
# those whose output takes the residual (wo, w_down), and w_down with the
# gated activation in its prologue too (NTPU_FUSE_GLU=1); Gemma-2-9B's
# widths with the (1 + w) norm and tanh GELU
RMS_PROJ = [(D, D, 3 * L), (D, I_PAD, 2 * L)] + LM_HEAD
RES_PROJ = [(D, D, L), (I_PAD, D, L)]
GLU_PROJ = [(I_PAD, D, L)]
G2_RMS_PROJ = [(3584, 4096, 42), (3584, 2048, 84), (3584, 14336, 84)]
G2_GLU_PROJ = [(14336, 3584, 42)]
# a prologue element that rounds to the neighbouring bf16 value (the
# card's rsqrtf, expf and tanhf against torch's, sums in another order)
# moves an f32 output by |w|·2^-8|h|, about 1e-4·max|out| at these widths:
# f32 outputs are held to 1e-3·max|ref|, bf16 ones to one rounding more,
# 1e-2 as K1's
FUSED_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}


def _unfused_chain(x, u, nw, offset, act, res, qt, odt):
    """What the graph runs without the fusion: the port's ``rms_norm`` or
    ``act(g) * u`` in bf16, K1, the bf16 residual add."""
    h = x
    if u is not None:
        h = Q.ACTS[act](x) * u
    if nw is not None:
        h = rms_norm(h, nw, 1e-5, offset)
    out = Q.qmm_native(h, qt.planes[0], qt.scales, None, qt.group_size,
                       qt.cfg.bits, odt)
    return out if res is None else out + res


def _fused_case(gen, label, cfg, M, shapes, entry, offset=None, act=None,
                res=False):
    """One fusion option of K1 at one M over ``shapes`` (K, N, products per
    step): the wrapper against its plain version on the same CUDA tensors
    (x the raw residual stream for rms, the gate input for glu), checking
    that ``entry`` and its option branches were launched; its time, the
    plain version's, the unfused chain's on the card (the yardstick this
    fusion replaces), one bf16 ``torch.matmul`` on the dequantized weight,
    and the bound: the unfused K1 bound plus the bytes of u, the norm
    weight and the residual. The lm_head (N = V) writes f32 logits with an
    f32 norm weight (the model's final norm), the rest bf16 with a bf16
    one (a layer's)."""
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, chain_ms=0.0,
               bound_ms=0.0, err=0.0)
    bound_by = {"bytes": 0.0, "operations": 0.0}
    branches = [b for b, on in (("rms", offset is not None),
                                ("glu", act is not None), ("res", res)) if on]
    for K, N, count in shapes:
        odt = torch.float32 if N == V else torch.bfloat16
        qt = to_native(quantize(
            torch.randn((K, N), generator=gen, device=DEV) * 0.02, cfg))
        wbytes = _qt_bytes(qt)
        qts = [qt] + [_qt_copy(qt) for _ in range(_copies(wbytes) - 1)]
        x = torch.randn((M, K), generator=gen, device=DEV).bfloat16()
        u = torch.randn((M, K), generator=gen, device=DEV).bfloat16() \
            if act else None
        nw = None
        if offset is not None:
            nw = (1 + 0.3 * torch.randn(K, generator=gen, device=DEV)).to(
                odt)
        r = torch.randn((M, N), generator=gen, device=DEV).bfloat16() \
            if res else None
        fuse = dict(norm=None if nw is None else (nw, 1e-5, offset), u=u,
                    act=act, res=r)
        fn = lambda q: Q.qmm_native_fused(x, q.planes[0], q.scales,
                                          q.group_size, q.cfg.bits, odt,
                                          **fuse)
        names = [entry] + [f"{entry}+{b}" for b in branches]
        before = _cuda.launch_counts()
        out = fn(qt)
        after = _cuda.launch_counts()
        if any(after[n] != before[n] + 1 for n in names):
            raise AssertionError(f"{label} {K}x{N}: {names} not launched")
        ref = Q.qmm_native_fused_plain(x, qt.planes[0], qt.scales,
                                       qt.group_size, qt.cfg.bits, odt,
                                       **fuse)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = FUSED_TOL[odt] * ref.float().abs().max().item()
        if not (err <= tol and torch.isfinite(out).all()):
            raise AssertionError(f"{label} {K}x{N}: max err {err} > tol {tol}")
        ms = time_ms([lambda q=q: fn(q) for q in qts])
        pms = time_ms([lambda: Q.qmm_native_fused_plain(
            x, qt.planes[0], qt.scales, qt.group_size, qt.cfg.bits, odt,
            **fuse)], reps=5)
        cms = time_ms([lambda q=q: _unfused_chain(x, u, nw, offset, act, r,
                                                  q, odt) for q in qts])
        wd = Q.dequant_bf16(qt)
        wds = [wd] + [wd.clone() for _ in range(_copies(K * N * 2) - 1)]
        lms = time_ms([lambda w=w: torch.matmul(x, w) for w in wds])
        del wds, wd, qts
        extra = (0 if u is None else M * K * 2) \
            + (0 if nw is None else K * nw.element_size()) \
            + (0 if r is None else M * N * 2)
        bnd, by = bound_ms(wbytes + M * K * 2 + extra + M * N * odt.itemsize,
                           2 * M * K * N, BF16_FLOPS)
        bound_by[by] += count * bnd
        log(f"{label} {'+'.join([entry] + branches)} M={M} {K}x{N} "
            f"x{count}/step: err {err:.3g} (tol {tol:.3g}) | kernel "
            f"{ms:.4f} ms, unfused chain {cms:.4f} ms, plain {pms:.3f} ms, "
            f"torch.matmul bf16 {lms:.4f} ms, bound {bnd:.4f} ms ({by})")
        for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                     ("chain_ms", cms), ("bound_ms", bnd)):
            agg[k] += count * v
        agg["err"] = max(agg["err"], err)
    n = sum(count for _, _, count in shapes)
    agg.update(bound_by=max(bound_by, key=bound_by.get),
               per=f"{label} at M={M} ({n} launches)")
    log(f"{label} at M={M}, per step: kernel {agg['ms']:.4f} ms against the "
        f"unfused chain's {agg['chain_ms']:.4f} ms; bound "
        f"{agg['bound_ms']:.4f} ms ({agg['bound_by']}), plain "
        f"{agg['plain_ms']:.3f} ms, torch.matmul {agg['library_ms']:.4f} ms")
    return agg


# (results key, C entry point, format, shapes and options of each case)
K1_FUSED_CHECKS = (
    ("K1_rms", "qmm4_npack_fused", "q4_j", (
        ("q4_j rms, decode step", RMS_PROJ, dict(offset=0.0)),
        ("gemma2 q4_j rms (1 + w), decode step", G2_RMS_PROJ,
         dict(offset=1.0)))),
    ("K1_res", "qmm4_npack_fused", "q4_j", (
        ("q4_j res, decode step", RES_PROJ, dict(res=True)),)),
    ("K1_glu", "qmm4_npack_fused", "q4_j", (
        ("q4_j glu silu + res, decode step", GLU_PROJ,
         dict(act="silu", res=True)),
        ("gemma2 q4_j glu gelu_tanh + res, decode step", G2_GLU_PROJ,
         dict(act="gelu_tanh", res=True)))),
    ("K1_int2_fused", "qmm2_npack_fused", "int2", (
        ("int2 rms, gate/up", [(D, I_PAD, 2 * L)], dict(offset=0.0)),
        ("int2 glu silu + res, down", GLU_PROJ, dict(act="silu", res=True)))),
    ("K1_int8_fused", "qmm8_native_fused", "int5", (
        ("int5 rms, gate/up", [(D, I_PAD, 2 * L)], dict(offset=0.0)),
        ("int5 glu silu + res, down", GLU_PROJ, dict(act="silu", res=True)))),
)


def check_k1_fused(gen, results):
    """K1's fusion options, each at M=1 (batch 1) and M=8 (the server's
    batch-8 step), over the three sym layouts at rest, against their plain
    versions; timed beside the unfused chain they replace."""
    for key, entry, fmt, cases in K1_FUSED_CHECKS:
        out = {}
        for label, shapes, opts in cases:
            for M, what in ((1, ""), (8, " (batch 8)")):
                out[label + what] = _fused_case(gen, label + what,
                                                PRESETS[fmt], M, shapes,
                                                entry, **opts)
        _record(results, key, out)
        torch.cuda.empty_cache()


K1_RERUN = {}       # K1's rerun and fused-vs-unfused checks, for the log


def check_k1_reruns(gen, results):
    """Two launches of each K1 entry point on the same inputs give
    bit-identical outputs (the splits are merged in a fixed order): every
    layout, sym and asym, and the fused entries with rms + res and with
    glu, at M = 1 and 8 over a 4096 x 4096 product (one split a 512-row
    stretch of K) and the lm_head's 4096 x 32000 (no split at M = 1). And
    the fused rms route (no GLU) against the unfused chain on the card
    (``rms_norm``, then K1): their largest difference is recorded."""
    checked = 0
    for fmt in ("q4_j", "q4_j_i8_g128", "int2", "int2_asym", "int5",
                "int5_asym"):
        cfg = QUANTS.get(fmt) or PRESETS[fmt]
        for K, N in ((D, D), (D, V)):
            qt = to_native(quantize(torch.randn(
                (K, N), generator=gen, device=DEV) * 0.02, cfg))
            args = (qt.planes[0], qt.scales, qt.zeros, qt.group_size,
                    qt.cfg.bits)
            for M in (1, 8):
                x = torch.randn((M, K), generator=gen, device=DEV).bfloat16()
                odt = torch.float32 if N == V else torch.bfloat16
                runs = [Q.qmm_native(x, *args, odt) for _ in range(2)]
                if qt.zeros is None:
                    nw = (1 + 0.3 * torch.randn(K, generator=gen,
                                                device=DEV)).bfloat16()
                    r = torch.randn((M, N), generator=gen,
                                    device=DEV).bfloat16()
                    u = torch.randn((M, K), generator=gen,
                                    device=DEV).bfloat16()
                    fa = (qt.planes[0], qt.scales, qt.group_size,
                          qt.cfg.bits, odt)
                    for opts in (dict(norm=(nw, 1e-5, 0.0), res=r),
                                 dict(u=u, act="silu")):
                        runs += [Q.qmm_native_fused(x, *fa, **opts)
                                 for _ in range(2)]
                    if fmt == "q4_j":
                        fused = Q.qmm_native_fused(x, *fa,
                                                   norm=(nw, 1e-5, 0.0))
                        chain = Q.qmm_native(rms_norm(x, nw, 1e-5, 0.0),
                                             *args, odt)
                        d = (fused.float() - chain.float()).abs().max()
                        K1_RERUN[f"fused_rms_vs_chain_M{M}_{N}"] = dict(
                            max_abs=d.item(), equal=torch.equal(fused,
                                                                chain))
                torch.cuda.synchronize()
                for a, b in zip(runs[::2], runs[1::2]):
                    if not torch.equal(a, b):
                        raise AssertionError(f"K1 {fmt} M={M} {K}x{N}: a "
                                             "rerun gave other bits")
                    checked += 1
            del qt
    K1_RERUN["reruns_bit_identical"] = checked
    log(f"K1 reruns bit-identical: {checked} pairs (every layout sym and "
        f"asym, fused rms + res and glu, M = 1 and 8); fused rms against "
        f"the unfused chain: {json.dumps(K1_RERUN)}")
    torch.cuda.empty_cache()


# the norms of one 7B decode step (two a layer and the final one) and of a
# 1975-token prefill, each [M, 4096] bf16 rows with a bf16 weight
RMS_CASES = ((1, "decode step"), (T_PREFILL, "1975-token prefill"))


def check_rms_norm(gen, results):
    """The row-norm kernel (``csrc/rms_norm.cu``: the unfused graph's RMS
    norm on the card, on K1's row-scale routine ``rms_row.cuh``) against
    the torch chain ``rms_norm_plain`` on the same rows: each output within
    one bf16 step of the chain's (at most 2^-7 relative; the two sum the
    squares in other orders and take other reciprocal square roots), at a
    decode step's rows and a prefill's; its time beside the chain's and
    ``torch.nn.functional.rms_norm``'s (a yardstick the port never calls),
    each times the 2L + 1 norms of a step or prefill."""
    lib_fn = getattr(torch.nn.functional, "rms_norm", None)
    n = 2 * L + 1
    cases = {}
    for M, label in RMS_CASES:
        x = (torch.randn((M, D), generator=gen, device=DEV) * 3).bfloat16()
        w = (1 + 0.3 * torch.randn(D, generator=gen, device=DEV)).bfloat16()
        before = _cuda.launch_counts()["rms_norm_bf16"]
        out = rms_norm(x, w, 1e-5, 0.0)
        if _cuda.launch_counts()["rms_norm_bf16"] != before + 1:
            raise AssertionError("rms_norm_bf16 was not launched")
        ref = rms_norm_plain(x, w, 1e-5, 0.0)
        err = (out.float() - ref.float()).abs()
        if not bool((err <= 2 ** -7 * ref.float().abs() + 1e-6).all()):
            raise AssertionError(f"rms_norm {label}: more than one bf16 step "
                                 f"from the chain (max {err.max().item()})")
        xs = [x] + [x.clone() for _ in range(_copies(M * D * 2) - 1)]
        ms = time_ms([lambda x=x: rms_norm(x, w, 1e-5, 0.0) for x in xs])
        pms = time_ms([lambda: rms_norm_plain(x, w, 1e-5, 0.0)])
        lms = None if lib_fn is None else time_ms(
            [lambda: lib_fn(x, (D,), w, 1e-5)])
        bnd, by = bound_ms(2 * M * D * 2 + D * 2, 5 * M * D, F32_FLOPS)
        log(f"rms_norm {label} (M={M}): max err {err.max().item():.3g}, "
            f"{int((out != ref).sum())} of {M * D} elements a bf16 step "
            f"apart | kernel {ms:.4f} ms, plain {pms:.4f} ms, "
            f"F.rms_norm {'n/a' if lms is None else round(lms, 4)} ms, bound "
            f"{bnd:.4f} ms ({by}), per launch")
        cases[label] = dict(ms=n * ms, plain_ms=n * pms,
                            library_ms=None if lms is None else n * lms,
                            bound_ms=n * bnd, bound_by=by,
                            err=err.max().item(),
                            per=f"{label}, {n} norms of [{M}, {D}]")
    _record(results, "RMS", cases)


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


# K2 over the layouts that are not int4, group 128, act_bits 8: (results
# key, C entry point (or its branch), bits, sym)
K2_LAYOUTS = (("K2_int8", "qmm_a8_int8", 6, True),
              ("K2_int8_asym", "qmm_a8_int8_asym", 6, False),
              ("K2_int2", "qmm_a8_int2", 2, True),
              ("K2_int2_asym", "qmm_a8_int2_asym", 2, False),
              ("K2_int3", "qmm_a8+int3", 3, True),
              ("K2_int3_asym", "qmm_a8_asym+int3", 3, False))


def check_k2_layouts(gen, results):
    """K2 at the 1975-token prefill over Llama-2-7B's products on int8 code
    planes (int6), native-pack int2 fields and int3 nibbles, group 128,
    sym and asym. Sym K2 is bit-equal to its plain version; asym sums the
    start ``-(xsa @ zwp)`` in another order, one bf16 rounding:
    1e-2·max|ref| (``_case``)."""
    args = lambda qt: (qt.planes[0], qt.scales, qt.group_size, 128)
    for key, entry, bits, sym in K2_LAYOUTS:
        cfg = QuantConfig(bits=bits, group_size=128, sym=sym, act_bits=8)
        k2 = lambda x, qt, odt: Q.qmm_a8(x, *args(qt), odt, qt.zeros,
                                         qt.cfg.bits)
        pl = lambda x, qt, odt: Q.qmm_a8_plain(x, *args(qt), odt, qt.zeros,
                                               qt.cfg.bits)
        label = f"{cfg.short_name()} 1975-token prefill"
        _record(results, key, {label: _case(gen, label, cfg, T_PREFILL, PROJ,
                                            k2, pl, entry, INT8_OPS)})
        torch.cuda.empty_cache()


# Mistral-7B GPTQ's products per token at rest (int4, group 128, asym, the
# act-order projections fused): q|k|v, o, gate|up, down; the lm_head stays
# in bf16
MISTRAL_PROJ = [(4096, 6144, 32), (4096, 4096, 32), (4096, 28672, 32),
                (14336, 4096, 32)]
GPTQ_QCFG = QuantConfig(bits=4, group_size=128, sym=False)


def check_gptq_products(gen, results):
    """Mistral-7B GPTQ's decode step through K1-asym (M=1) and its
    1975-token prefill through K5, x already gathered (the gathers are
    timed apart in phase 4f); each a case beside the kernel's others."""
    k1 = lambda x, qt, odt: Q.qmm_native(x, qt.planes[0], qt.scales,
                                         qt.zeros, qt.group_size, 4, odt)
    p1 = lambda x, qt, odt: Q.qmm_native_plain(x, qt.planes[0], qt.scales,
                                               qt.zeros, qt.group_size, 4,
                                               odt)
    label = "mistral gptq decode step"
    results["K1_asym"]["cases"][label] = _case(
        gen, label, GPTQ_QCFG, 1, MISTRAL_PROJ, k1, p1, "qmm4_npack_asym",
        BF16_FLOPS)
    _beside_before("K1_asym", label, results["K1_asym"]["cases"][label])
    label = "mistral gptq 1975-token prefill"
    case = _case(
        gen, label, GPTQ_QCFG, T_PREFILL, MISTRAL_PROJ,
        lambda x, qt, odt: Q.qmm_general(x, qt, odt),
        lambda x, qt, odt: Q.qmm_general_plain(x, qt, odt),
        "qmm_general+tc", BF16_FLOPS)
    results["K5"]["cases"][label] = case
    results["K5_tc"]["cases"][label] = case
    log(f"K5_tc {label}: kernel {case['ms']:.4f} ms, bound "
        f"{case['bound_ms']:.4f} ms, library {case['library_ms']:.4f} ms, "
        f"PR 1-7 {PR17_MS[label]} ms")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3, continued: the attention kernels K3, K4 and K6
# ---------------------------------------------------------------------------

# Gemma-2-9B's attention: 16 query heads over 8 KV heads of 256 dims,
# scale query_pre_attn_scalar^-0.5 = 1/16, softcap 50, a 4096-key window
# on its 21 even layers and none on its 21 odd ones; 8192 positions
G2_HQ, G2_HKV, G2_DH, G2_S, G2_W, G2_SOFTCAP = 16, 8, 256, 8192, 4096, 50.0
G2_FILL = 6000      # a long fill, past the window
# The heads of each case: (what, Hq, Hkv, head dim, S, softcap): Llama-2-7B's
# with no option, Gemma-2-9B's, and head dim 128 with the softcap
LLAMA_HEADS = ("llama", H, H, DH, S_CACHE, 0.0)
G2_HEADS = ("gemma2", G2_HQ, G2_HKV, G2_DH, G2_S, G2_SOFTCAP)
HD128_HEADS = ("head dim 128", H, H, DH, S_CACHE, G2_SOFTCAP)
# q is drawn at 4x a unit normal so the scaled scores reach ~16 and the
# softcap moves them by up to ~1: a kernel that skipped it would fail its
# check. K is normal, V uniform in [-1, 1] (int8: quantized from there).
Q_SPREAD = 4.0
# Tolerances on the f32 output. bf16 KV, and K3 over int8: the kernel rounds
# P (P·vs for int8) to bf16 against its running max, the plain version
# against the final max (<= 2^-9 each, |v| <= 1), and the softmax sums run
# in another order. K4/K6 over int8: q's quantization and the exact int8 QK
# dot are the same arithmetic on both sides, and PV is f32.
BF16_TOL, I8_PREFILL_TOL, I8_DECODE_TOL = 4e-3, 4e-3, 1e-4


def _visible(fill, window):
    return min(fill, window) if window else fill


def _pairs(T, window):
    """(query, key) pairs a causal prefill of T rows from position 0 sees."""
    if not window or window >= T:
        return T * (T + 1) // 2
    return window * (window + 1) // 2 + (T - window) * window


def _attn_cache(gen, shape, int8, copies=1):
    """K and V caches: (k, v, None, None) in bf16, or (k8, v8, k_scale,
    v_scale)."""
    out = []
    for _ in range(copies):
        k = torch.randn(shape, generator=gen, device=DEV)
        v = torch.rand(shape, generator=gen, device=DEV) * 2 - 1
        if int8:
            (kc, ks), (vc, vs) = A.quantize_kv(k), A.quantize_kv(v)
            out.append((kc, vc, ks, vs))
        else:
            out.append((k.bfloat16(), v.bfloat16(), None, None))
    return out


def _bf16_kv(c):
    """A cache as the library call takes it: bf16, dequantized if int8."""
    k, v, ks, vs = c
    if ks is None:
        return k, v
    return tuple((x.float() * s.float()[..., None]).bfloat16()
                 for x, s in ((k, ks), (v, vs)))


def _sdpa(q, k, v, **kw):
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, **kw)


# the yardstick's bf16 output is one rounding (2^-9, |out| <= 1) past the
# plain version's f32 on the same bf16 keys, plus BF16_TOL's sums
LIB_TOL = 1e-2
_FLEX = []      # torch.compile(flex_attention), made on first use


def _flex(q, kvs, offsets, window, scale, softcap, ref, slopes=None,
          prefix=None):
    """Closures of one compiled ``flex_attention`` call per (k, v) of
    ``kvs`` (bf16, dequantized for int8; q [B, Hq, Tq, Dh]): as its
    score_mod the tanh softcap, then ALiBi's ``slopes[h] · (kv - q_pos)``
    with q_pos = i + offsets[b]; as its block mask the keys that query row
    i of batch row b sees: kv <= i + offsets[b] and, with a window, kv > i
    + offsets[b] - window; or, with the GLM prefix bound ``prefix`` (the
    prompt length P), any kv < P - 1. The library's fused kernel for the
    function K3/K4/K6 compute with their options, a yardstick the port
    never calls. It is compiled here, outside any timed window, one graph
    per shape and set of options (the offsets, the window, the slopes and
    the prefix are tensors, so the cases of one shape share it), and its
    output is held within LIB_TOL of ``ref()``, the plain version on the
    same bf16 keys in the same layout."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    if not _FLEX:
        # one graph per shape and set of options: a dozen in all, past the
        # default limit of 8, beyond which flex runs uncompiled, and that
        # path copies from the host inside the timing's graph capture
        torch._dynamo.config.recompile_limit = 64
        _FLEX.append(torch.compile(flex_attention, dynamic=False))
    off = torch.tensor(offsets, dtype=torch.int32, device=DEV)
    lo = off - (window or 1 << 30)
    pm1 = torch.tensor([(prefix or 0) - 1], dtype=torch.int32, device=DEV)

    def mask(b, h, qi, ki):
        return (ki <= qi + off[b]) & (ki > qi + lo[b])

    def prefix_mask(b, h, qi, ki):
        return mask(b, h, qi, ki) | (ki < pm1[0])

    def score(s, b, h, qi, ki):
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        if slopes is not None:
            s = s + slopes[h] * (ki - qi - off[b])
        return s

    B, Hq, Tq, _ = q.shape
    bm = create_block_mask(prefix_mask if prefix else mask, B, None, Tq,
                           kvs[0][0].shape[2], device=DEV)
    mod = score if softcap or slopes is not None else None
    fns = [lambda k=k, v=v: _FLEX[0](
        q, k, v, score_mod=mod, block_mask=bm, scale=scale,
        enable_gqa=Hq != k.shape[1]) for k, v in kvs]
    t = time.perf_counter()
    out = fns[0]()
    torch.cuda.synchronize()
    t = time.perf_counter() - t
    err = (out.float() - ref()).abs().max().item()
    log(f"  flex_attention compiled and run in {t:.1f} s: err {err:.3g} "
        f"against the plain version on the same bf16 keys (tol {LIB_TOL})")
    if not err <= LIB_TOL:
        raise AssertionError(f"flex_attention yardstick: max err {err}")
    return fns


def _attn_case(label, entry, run, plain, nbytes, op_s, tol, count,
               runs=None, library=None, off=None):
    """One attention case: the wrapper ``run()`` against ``plain()`` on the
    same CUDA tensors, checking that ``entry`` launched; its time (over
    ``runs``, closures on copies of the cache that defeat the L2, or
    ``run`` alone), the plain version's, ``library``'s (closures of one
    library call on the same keys, dequantized for int8:
    ``scaled_dot_product_attention`` with no option, a compiled
    ``flex_attention`` with the softcap, a window, ALiBi or the prefix),
    and the bound of ``nbytes`` and ``op_s`` seconds of operations; each
    times ``count``, the launches per token or prefill. ``off``: closures
    of the same launches with the case's option off, timed beside it, so
    the branch's cost shows."""
    before = _cuda.launch_counts()[entry]
    out = run()
    if _cuda.launch_counts()[entry] != before + 1:
        raise AssertionError(f"{label}: {entry} was not launched")
    ref = plain()
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{label} {entry}: max err {err} > tol {tol}")
    del out, ref
    ms = time_ms(runs or [run])
    pms = time_ms([plain], reps=5)
    lms = time_ms(library)
    bnd, by = bound_ms_s(nbytes, op_s)
    log(f"{label} {entry} x{count}: err {err:.3g} (tol {tol}) | kernel "
        f"{ms:.4f} ms, plain {pms:.3f} ms, library {lms:.4f} ms, bound "
        f"{bnd:.4f} ms ({by}); {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
    out = dict(ms=count * ms, plain_ms=count * pms, library_ms=count * lms,
               bound_ms=count * bnd, bound_by=by, err=err,
               ms_per_launch=ms, per=f"{label} ({count} launches)")
    if off:
        oms = time_ms(off)
        out.update(off_ms_per_launch=oms, on_over_off=ms / oms)
        log(f"  the same launch with the option off: {oms:.4f} ms; on / "
            f"off {ms / oms:.3f}")
    return out


def _attn_ops(int8, Dh, Hq, pairs, alibi, decode):
    """Seconds of operations at the peaks: QK^T and PV (int8 QK at the int8
    rate; decode's int8 PV in f32, prefill's in bf16), and ALiBi's product
    and sum per pair in f32."""
    if int8:
        pv = F32_FLOPS if decode else BF16_FLOPS
        op_s = 2 * Dh * Hq * pairs * (1 / INT8_OPS + 1 / pv)
    else:
        op_s = 4 * Dh * Hq * pairs / BF16_FLOPS
    return op_s + (2 * Hq * pairs / F32_FLOPS if alibi else 0.0)


# the server's prefill chunk: 512 tokens at position 1024 (S = 2048)
CHUNK_T, CHUNK_START = 512, 1024


def check_k3(gen, results):
    """K3, bf16 and int8: Llama-2-7B's 1975-token prefill from position 0;
    Gemma-2-9B's 6000-token prompt (S = 8192) with window 4096 and 0, and
    its 1975-token prompt (S = 2048) under the window, which it never
    reaches; head dim 128 at 1975 tokens with the softcap and a window of
    1024; the server's 512-token chunk at position 1024 of 2048 (its
    yardstick a compiled ``flex_attention`` with the offset)."""
    g2_short = (*G2_HEADS[:4], S_CACHE, G2_SOFTCAP)
    shapes = [(LLAMA_HEADS, T_PREFILL, 0, 0, L),
              (G2_HEADS, G2_FILL, 0, G2_W, 21), (G2_HEADS, G2_FILL, 0, 0, 21),
              (g2_short, T_PREFILL, 0, G2_W, 42),
              (HD128_HEADS, T_PREFILL, 0, 1024, 1),
              (LLAMA_HEADS, CHUNK_T, CHUNK_START, 0, L)]
    for int8, key in ((False, "K3"), (True, "K3_i8")):
        entry = "flash_prefill_i8" if int8 else "flash_prefill"
        fn = A.flash_prefill_i8 if int8 else A.flash_prefill
        plain = A.flash_prefill_i8_plain if int8 else A.flash_prefill_plain
        cases, window_ms = {}, {}
        for (what, Hq, Hkv, Dh, S, cap), T, start, W, count in shapes:
            starts = torch.full((1,), start, dtype=torch.int32, device=DEV)
            q = (torch.randn((1, T, Hq, Dh), generator=gen, device=DEV)
                 * Q_SPREAD).bfloat16()
            c = _attn_cache(gen, (1, Hkv, S, Dh), int8)[0]
            args = (q, c[0], c[1], *(c[2:] if int8 else ()), starts,
                    Dh ** -0.5, cap, W)
            kd, vd = (x[:, :, :start + T] for x in _bf16_kv(c))
            qh = q.transpose(1, 2)
            if cap or W or start:
                library = _flex(qh, [(kd, vd)], [start], W, Dh ** -0.5, cap,
                                lambda: A.flash_prefill_plain(
                                    q, kd, vd, starts, Dh ** -0.5, cap,
                                    W).transpose(1, 2))
            else:
                library = [lambda: _sdpa(qh, kd, vd, is_causal=True)]
            pairs = _pairs(start + T, W) - _pairs(start, W)
            row = Dh + 2 if int8 else 2 * Dh    # bytes of a K or V row
            op_s = _attn_ops(int8, Dh, Hq, pairs, False, False)
            label = (f"{what} {T}-token chunk at {start}" if start else
                     f"{what} {T}-token prefill") + \
                f", window {W}, softcap {cap:g}"
            cases[label] = _attn_case(
                label, entry, lambda: fn(*args), lambda: plain(*args),
                T * Hq * Dh * 2 + 2 * (start + T) * Hkv * row
                + T * Hq * Dh * 4, op_s,
                I8_PREFILL_TOL if int8 else BF16_TOL, count,
                library=library)
            if what == "gemma2" and T == G2_FILL:
                window_ms[W] = cases[label]["ms_per_launch"]
            del q, qh, c, kd, vd, library, starts
            torch.cuda.empty_cache()
        _record(results, key, cases, window_ms)


def check_k4(gen, results):
    """K4, bf16 and int8: Llama-2-7B's decode at fills 1975 and 128;
    Gemma-2-9B's at fill 6000 of 8192 with window 4096 and 0; head dim 128
    at fill 1975 with the softcap and a window of 1024."""
    shapes = [(LLAMA_HEADS, T_PREFILL, 0, L), (LLAMA_HEADS, 128, 0, L),
              (G2_HEADS, G2_FILL, G2_W, 21), (G2_HEADS, G2_FILL, 0, 21),
              (HD128_HEADS, T_PREFILL, 1024, 1)]
    for int8, key in ((False, "K4"), (True, "K4_i8")):
        entry = "flash_decode_i8" if int8 else "flash_decode"
        fn = A.flash_decode_i8 if int8 else A.flash_decode
        plain = A.flash_decode_i8_plain if int8 else A.flash_decode_plain
        cases, window_ms = {}, {}
        for (what, Hq, Hkv, Dh, S, cap), fill, W, count in shapes:
            q = (torch.randn((1, Hq, Dh), generator=gen, device=DEV)
                 * Q_SPREAD).bfloat16()
            vis = _visible(fill, W)
            row = Dh + 2 if int8 else 2 * Dh    # bytes of a K or V row
            caches = _attn_cache(gen, (1, Hkv, S, Dh), int8,
                                 _copies(2 * vis * Hkv * row))
            lengths = torch.tensor([fill], dtype=torch.int32, device=DEV)
            args = [(q, c[0], c[1], *(c[2:] if int8 else ()), lengths,
                     Dh ** -0.5, cap, W) for c in caches]
            kvs = [_bf16_kv(c) for c in caches]
            if cap or W:
                # the whole cache, masked past the fill: K6's B=1 case
                # gathers the same shape, so the two share one graph
                library = _flex(q[:, :, None], kvs, [fill - 1], W,
                                Dh ** -0.5, cap,
                                lambda: A.flash_decode_plain(
                                    q, *kvs[0], lengths, Dh ** -0.5, cap,
                                    W)[:, :, None])
            else:
                library = [lambda kv=kv: _sdpa(
                    q[:, :, None], kv[0][:, :, :fill], kv[1][:, :, :fill])
                    for kv in kvs]
            op_s = _attn_ops(int8, Dh, Hq, vis, False, True)
            label = f"{what} decode fill {fill}, window {W}, softcap {cap:g}"
            cases[label] = _attn_case(
                label, entry, lambda: fn(*args[0]), lambda: plain(*args[0]),
                2 * vis * Hkv * row + Hq * Dh * (2 + 4), op_s,
                I8_DECODE_TOL if int8 else BF16_TOL, count,
                runs=[lambda a=a: fn(*a) for a in args], library=library)
            if what == "gemma2" and fill == G2_FILL:
                window_ms[W] = cases[label]["ms_per_launch"]
            del q, caches, args, kvs, library
            torch.cuda.empty_cache()
        _record(results, key, cases, window_ms)


def check_k6(gen, results):
    """K6 over shuffled page tables (page 256, a pool of B·MAXP + 1 pages),
    bf16 and int8: the Llama server's step (B=8, fills 1..2048);
    Gemma-2-9B's at B=1, fill 6000, window 4096 and 0, and at B=8 with
    mixed fills and the window; head dim 128 at the server's step with the
    softcap and a window of 512."""
    ps = 256
    cpu = torch.Generator().manual_seed(6)
    server = [1, 2048, 1975, 128, 700, 1300, 33, 1024]
    shapes = [(LLAMA_HEADS, server, 0, L),
              (G2_HEADS, [G2_FILL], G2_W, 21), (G2_HEADS, [G2_FILL], 0, 21),
              (G2_HEADS, [1, 8192, 6000, 128, 4500, 3000, 33, 4097], G2_W,
               21),
              (HD128_HEADS, server, 512, 1)]
    for int8, key in ((False, "K6"), (True, "K6_i8")):
        entry = "paged_decode_i8" if int8 else "paged_decode"
        fn = PA.paged_decode_i8 if int8 else PA.paged_decode
        cases, window_ms = {}, {}
        for (what, Hq, Hkv, Dh, S, cap), fills, W, count in shapes:
            B, maxp = len(fills), S // ps
            P = B * maxp + 1
            table = torch.randperm(P - 1, generator=cpu)[:B * maxp] \
                .reshape(B, maxp).to(torch.int32).to(DEV)
            lengths = torch.tensor(fills, dtype=torch.int32, device=DEV)
            q = (torch.randn((B, Hq, Dh), generator=gen, device=DEV)
                 * Q_SPREAD).bfloat16()
            c = _attn_cache(gen, (P, Hkv, ps, Dh), int8)[0]
            opts = (Dh ** -0.5, cap, W)
            args = (q, c[0], c[1], *(c[2:] if int8 else ()), table, lengths,
                    *opts)
            kd, vd = (PA.gather_pages(x, table) for x in _bf16_kv(c))
            if cap or W:
                library = _flex(q[:, :, None], [(kd, vd)],
                                [f - 1 for f in fills], W, Dh ** -0.5, cap,
                                lambda: A.flash_decode_plain(
                                    q, kd, vd, lengths, Dh ** -0.5, cap,
                                    W)[:, :, None])
            else:
                mask = (torch.arange(maxp * ps, device=DEV)[None, :]
                        < lengths[:, None].long())[:, None, None, :]
                library = [lambda: _sdpa(q[:, :, None], kd, vd,
                                         attn_mask=mask)]
            n = sum(_visible(f, W) for f in fills)
            row = Dh + 2 if int8 else 2 * Dh    # bytes of a K or V row
            op_s = _attn_ops(int8, Dh, Hq, n, False, True)
            label = (f"{what} B={B} decode fills {fills}, window {W}, "
                     f"softcap {cap:g}")
            cases[label] = _attn_case(
                label, entry, lambda: fn(*args),
                lambda: PA.paged_decode_plain(q, *c, table, lengths, *opts),
                2 * n * Hkv * row + B * maxp * 4 + B * 4
                + B * Hq * Dh * (2 + 4), op_s,
                I8_DECODE_TOL if int8 else BF16_TOL, count, library=library)
            if what == "gemma2" and fills == [G2_FILL]:
                window_ms[W] = cases[label]["ms_per_launch"]
            del q, c, args, kd, vd, library
            torch.cuda.empty_cache()
        _record(results, key, cases, window_ms)


def _server_table(cpu, B, maxp, P):
    """A shuffled page table: B rows of maxp distinct pages of P."""
    return torch.randperm(P, generator=cpu)[:B * maxp].reshape(B, maxp) \
        .to(torch.int32).to(DEV)


def check_k6_paging(gen, results):
    """K6's paging beside check_k6's cases, bf16 and int8 pools, against
    paged_decode_plain: the Llama server's step (B=8, mixed fills) over
    pages of 16 and 32 keys (a tile takes several boxes); the same over
    pages of 256 with every table entry past a row's fill pointing at
    another row's live page, and the rows past each fill in its last page
    holding large finite K and V (read, since the box is whole, and
    masked); and K6 at batch 1, fill 1975, over an identity table on K4's
    own cache (its pages the cache's rows) against K4 on that cache, the
    two times side by side."""
    cpu = torch.Generator().manual_seed(17)
    fills = SERVER_FILLS
    B = len(fills)
    lengths = torch.tensor(fills, dtype=torch.int32, device=DEV)
    opts = (DH ** -0.5, 0.0, 0)
    for int8, key in ((False, "K6"), (True, "K6_i8")):
        entry = "paged_decode_i8" if int8 else "paged_decode"
        fn = PA.paged_decode_i8 if int8 else PA.paged_decode
        tol = I8_DECODE_TOL if int8 else BF16_TOL
        row = DH + 2 if int8 else 2 * DH
        n = sum(fills)
        cases = results[key]["cases"]
        for ps, what in ((16, "page 16"), (32, "page 32"),
                         (256, "table past the fill at live pages")):
            maxp = S_CACHE // ps
            P = B * maxp + 1
            table = _server_table(cpu, B, maxp, P - 1)
            k, v = (torch.randn((P, H, ps, DH), generator=gen, device=DEV),
                    torch.rand((P, H, ps, DH), generator=gen,
                               device=DEV) * 2 - 1)
            if ps == 256:
                # entries past the fill: other rows' visible pages; rows
                # past the fill in the last page: large, finite
                live = [int(table[b, i]) for b in range(B)
                        for i in range(-(-fills[b] // ps))]
                for b, f in enumerate(fills):
                    used = -(-f // ps)
                    for i in range(used, maxp):
                        table[b, i] = live[(7 * b + i) % len(live)]
                    page, r0 = int(table[b, used - 1]), f - (used - 1) * ps
                    k[page, :, r0:] = 3e4
                    v[page, :, r0:] = -3e4
            if int8:
                (kc, ks), (vc, vs) = A.quantize_kv(k), A.quantize_kv(v)
                c = (kc, vc, ks, vs)
            else:
                c = (k.bfloat16(), v.bfloat16(), None, None)
            del k, v
            q = (torch.randn((B, H, DH), generator=gen, device=DEV)
                 * Q_SPREAD).bfloat16()
            args = (q, c[0], c[1], *(c[2:] if int8 else ()), table,
                    lengths, *opts)
            kd, vd = (PA.gather_pages(x, table) for x in _bf16_kv(c))
            mask = (torch.arange(maxp * ps, device=DEV)[None, :]
                    < lengths[:, None].long())[:, None, None, :]
            label = f"llama B={B} decode fills {fills}, {what}"
            cases[label] = _attn_case(
                label, entry, lambda: fn(*args),
                lambda: PA.paged_decode_plain(q, *c, table, lengths, *opts),
                2 * n * H * row + B * maxp * 4 + B * 4 + B * H * DH * 6,
                _attn_ops(int8, DH, H, n, False, True), tol, L,
                library=[lambda: _sdpa(q[:, :, None], kd, vd,
                                       attn_mask=mask)])
            _beside_before(key, label, cases[label])
            del q, c, args, kd, vd, mask
            torch.cuda.empty_cache()
        # K6 over an identity table on K4's cache [1, H, S, D]: page i of
        # the pool is keys i*ps .. of the row (pool [maxp, H, ps, D])
        ps, fill = 256, T_PREFILL
        maxp = S_CACHE // ps
        cache = _attn_cache(gen, (1, H, S_CACHE, DH), int8)[0]
        pool = [None if t is None else
                t.reshape(H, maxp, ps, *t.shape[3:]).transpose(0, 1)
                .contiguous() for t in cache]
        table = torch.arange(maxp, dtype=torch.int32, device=DEV)[None]
        ln = torch.tensor([fill], dtype=torch.int32, device=DEV)
        q = (torch.randn((1, H, DH), generator=gen, device=DEV)
             * Q_SPREAD).bfloat16()
        k4 = A.flash_decode_i8 if int8 else A.flash_decode
        a4 = (q, cache[0], cache[1], *(cache[2:] if int8 else ()), ln,
              *opts)
        a6 = (q, pool[0], pool[1], *(pool[2:] if int8 else ()), table, ln,
              *opts)
        out4, out6 = k4(*a4), fn(*a6)
        torch.cuda.synchronize()
        err46 = (out6 - out4).abs().max().item()
        if not err46 <= tol:
            raise AssertionError(f"K6 over an identity table against K4: "
                                 f"max err {err46} > {tol}")
        kd, vd = (x[:, :, :fill] for x in _bf16_kv(cache))
        label = f"llama B=1 decode fill {fill}, identity table (K4's cache)"
        cases[label] = _attn_case(
            label, entry, lambda: fn(*a6),
            lambda: PA.paged_decode_plain(q, *pool, table, ln, *opts),
            2 * fill * H * row + maxp * 4 + 4 + H * DH * 6,
            _attn_ops(int8, DH, H, fill, False, True), tol, L,
            library=[lambda: _sdpa(q[:, :, None], kd, vd)])
        k4_ms = time_ms([lambda: k4(*a4)])
        cases[label].update(k4_ms_per_launch=k4_ms, k6_vs_k4_err=err46)
        log(f"{key} {label}: K6 {cases[label]['ms_per_launch']:.4f} ms a "
            f"launch, K4 on the same cache {k4_ms:.4f} ms; |K6 - K4| "
            f"{err46:.3g} (tol {tol})")
        _beside_before(key, label, cases[label])
        del cache, pool, q, a4, a6, out4, out6, kd, vd
        torch.cuda.empty_cache()


def window_speedups(results):
    """The window's gain at fill 6000: K4, K6 (B=1) and K3 time per launch
    with window 4096 over the same with window 0, as each check recorded
    them. A kernel that masked the keys below the floor but still read
    them would show none: K4 and K3 must be faster with the window. K6
    shares K4's body; its B=1 gain was 4-12% on an H100 80GB HBM3 at 700
    W, down to the noise of one launch, so it is printed, not required."""
    out = {}
    for key, at in (("K4", f"decode fill {G2_FILL}"),
                    ("K4_i8", f"decode fill {G2_FILL}"),
                    ("K6", f"B=1 decode fill {G2_FILL}"),
                    ("K6_i8", f"B=1 decode fill {G2_FILL}"),
                    ("K3", f"{G2_FILL}-token prefill"),
                    ("K3_i8", f"{G2_FILL}-token prefill")):
        per = results[key]["window_ms"]
        out[key] = per[G2_W] / per[0]
        log(f"{key} {at}: window {G2_W} {per[G2_W]:.4f} ms, window 0 "
            f"{per[0]:.4f} ms per launch, ratio {out[key]:.3f}")
        if key.startswith(("K4", "K3")) and not per[G2_W] < per[0]:
            raise AssertionError(f"{key}: the window skips no work at {at}")
    return out


# Bloom-7B1's and ChatGLM-6B's attention: 32 heads of 128 over as many KV
# heads, as Llama-2-7B's; Bloom's ALiBi slopes 2^-(h+1)/4; 30 and 28 layers
BLOOM_L, CHATGLM_L = 30, 28


def _slopes(Hq):
    return torch.from_numpy(alibi_slopes(Hq)).to(DEV)


def _prefix_pairs(T, P):
    """(query, key) pairs a T-row prefill from position 0 sees under the GLM
    prefix mask of a P-token prompt: row t sees max(t + 1, P - 1) keys."""
    return sum(max(t + 1, P - 1) for t in range(T))


def check_k3_options(gen, results):
    """K3's ALiBi branch at Bloom-7B1's 1975-token prefill (32 heads, its
    slopes; 30 launches) and its GLM prefix branch at ChatGLM-6B's, where
    the whole 1975-token prompt is the prefix (every row sees 1973 keys or
    more; 28 launches), bf16 and int8 KV, each against the same launch with
    the option off."""
    starts = torch.zeros(1, dtype=torch.int32, device=DEV)
    sl, T = _slopes(H), T_PREFILL
    plen = torch.tensor([T], dtype=torch.int32, device=DEV)
    for int8 in (False, True):
        sfx = "_i8" if int8 else ""
        entry = "flash_prefill_i8" if int8 else "flash_prefill"
        fn = A.flash_prefill_i8 if int8 else A.flash_prefill
        plain = A.flash_prefill_i8_plain if int8 else A.flash_prefill_plain
        q = (torch.randn((1, T, H, DH), generator=gen, device=DEV)
             * Q_SPREAD).bfloat16()
        c = _attn_cache(gen, (1, H, S_CACHE, DH), int8)[0]
        base = (q, c[0], c[1], *(c[2:] if int8 else ()), starts, DH ** -0.5)
        kd, vd = (x[:, :, :T] for x in _bf16_kv(c))
        qh = q.transpose(1, 2)
        row = DH + 2 if int8 else 2 * DH    # bytes of a K or V row
        nbytes = T * H * DH * 2 + 2 * T * H * row + T * H * DH * 4
        for opt, kw, pairs, count, what in (
                ("alibi", dict(slopes=sl), _pairs(T, 0), BLOOM_L, "bloom"),
                ("prefix", dict(prefix_len=plen), _prefix_pairs(T, T),
                 CHATGLM_L, "chatglm")):
            library = _flex(
                qh, [(kd, vd)], [0], 0, DH ** -0.5, 0.0,
                lambda: A.flash_prefill_plain(q, kd, vd, starts, DH ** -0.5,
                                              **kw).transpose(1, 2),
                slopes=kw.get("slopes"), prefix=T if opt == "prefix" else None)
            label = f"{what} {T}-token prefill, {opt}"
            case = _attn_case(
                label, f"{entry}+{opt}", lambda: fn(*base, **kw),
                lambda: plain(*base, **kw), nbytes,
                _attn_ops(int8, DH, H, pairs, opt == "alibi", False),
                I8_PREFILL_TOL if int8 else BF16_TOL, count, library=library,
                off=[lambda: fn(*base)])
            _record(results, f"K3{sfx}_{opt}", {label: case})
            del library
        del q, c, kd, vd, qh
        torch.cuda.empty_cache()


def check_k4_alibi(gen, results):
    """K4's ALiBi branch at Bloom-7B1's decode, fills 1975 and 128 of 2048,
    bf16 and int8 KV, against the same launches without the slopes."""
    sl = _slopes(H)
    for int8, key in ((False, "K4_alibi"), (True, "K4_i8_alibi")):
        entry = "flash_decode_i8" if int8 else "flash_decode"
        fn = A.flash_decode_i8 if int8 else A.flash_decode
        plain = A.flash_decode_i8_plain if int8 else A.flash_decode_plain
        cases = {}
        for fill in (T_PREFILL, 128):
            q = (torch.randn((1, H, DH), generator=gen, device=DEV)
                 * Q_SPREAD).bfloat16()
            row = DH + 2 if int8 else 2 * DH
            caches = _attn_cache(gen, (1, H, S_CACHE, DH), int8,
                                 _copies(2 * fill * H * row))
            lengths = torch.tensor([fill], dtype=torch.int32, device=DEV)
            args = [(q, c[0], c[1], *(c[2:] if int8 else ()), lengths,
                     DH ** -0.5) for c in caches]
            kvs = [_bf16_kv(c) for c in caches]
            library = _flex(q[:, :, None], kvs, [fill - 1], 0, DH ** -0.5,
                            0.0, lambda: A.flash_decode_plain(
                                q, *kvs[0], lengths, DH ** -0.5,
                                slopes=sl)[:, :, None], slopes=sl)
            label = f"bloom decode fill {fill}, alibi"
            cases[label] = _attn_case(
                label, f"{entry}+alibi", lambda: fn(*args[0], slopes=sl),
                lambda: plain(*args[0], slopes=sl),
                2 * fill * H * row + H * DH * (2 + 4),
                _attn_ops(int8, DH, H, fill, True, True),
                I8_DECODE_TOL if int8 else BF16_TOL, BLOOM_L,
                runs=[lambda a=a: fn(*a, slopes=sl) for a in args],
                library=library, off=[lambda a=a: fn(*a) for a in args])
            del q, caches, args, kvs, library
            torch.cuda.empty_cache()
        _record(results, key, cases)


def check_k6_alibi(gen, results):
    """K6's ALiBi branch at the Bloom-7B1 server's step: B=8 over a
    shuffled page table (page 256) with the server's mixed fills, bf16 and
    int8 pools, against the same launch without the slopes."""
    ps, sl = 256, _slopes(H)
    cpu = torch.Generator().manual_seed(11)
    fills = [1, 2048, 1975, 128, 700, 1300, 33, 1024]
    B, maxp = len(fills), S_CACHE // ps
    P = B * maxp + 1
    for int8, key in ((False, "K6_alibi"), (True, "K6_i8_alibi")):
        entry = "paged_decode_i8" if int8 else "paged_decode"
        fn = PA.paged_decode_i8 if int8 else PA.paged_decode
        table = torch.randperm(P - 1, generator=cpu)[:B * maxp] \
            .reshape(B, maxp).to(torch.int32).to(DEV)
        lengths = torch.tensor(fills, dtype=torch.int32, device=DEV)
        q = (torch.randn((B, H, DH), generator=gen, device=DEV)
             * Q_SPREAD).bfloat16()
        c = _attn_cache(gen, (P, H, ps, DH), int8)[0]
        args = (q, c[0], c[1], *(c[2:] if int8 else ()), table, lengths,
                DH ** -0.5)
        kd, vd = (PA.gather_pages(x, table) for x in _bf16_kv(c))
        library = _flex(q[:, :, None], [(kd, vd)], [f - 1 for f in fills], 0,
                        DH ** -0.5, 0.0, lambda: A.flash_decode_plain(
                            q, kd, vd, lengths, DH ** -0.5,
                            slopes=sl)[:, :, None], slopes=sl)
        n = sum(fills)
        row = DH + 2 if int8 else 2 * DH
        label = f"bloom B={B} decode fills {fills}, alibi"
        case = _attn_case(
            label, f"{entry}+alibi", lambda: fn(*args, slopes=sl),
            lambda: PA.paged_decode_plain(q, *c, table, lengths, DH ** -0.5,
                                          slopes=sl),
            2 * n * H * row + B * maxp * 4 + B * 4 + B * H * DH * (2 + 4),
            _attn_ops(int8, DH, H, n, True, True),
            I8_DECODE_TOL if int8 else BF16_TOL, BLOOM_L, library=library,
            off=[lambda: fn(*args)])
        _record(results, key, {label: case})
        del q, c, args, kd, vd, library
        torch.cuda.empty_cache()


# more than 8 query heads per KV head: ChatGLM-2-6B's attention (32 heads of
# 128 over 2 KV heads, 28 layers) and StarCoder's multi-query attention (48
# heads of 128 over 1, 40 layers)
MANY_G = (("chatglm2", 32, 2, 28), ("starcoder", 48, 1, 40))
SERVER_FILLS = [1, 2048, 1975, 128, 700, 1300, 33, 1024]


def check_many_heads(gen, results):
    """K4 at fill 1975 and K6 at B=8 with the server's mixed fills (page
    256, a shuffled table) at G = 16 and 48, bf16 and int8 KV, against
    their plain versions; the library call is ``sdpa`` with GQA on the
    gathered, dequantized keys."""
    ps, cpu = 256, torch.Generator().manual_seed(13)
    for int8 in (False, True):
        sfx = "_i8" if int8 else ""
        row = DH + 2 if int8 else 2 * DH
        tol = I8_DECODE_TOL if int8 else BF16_TOL
        k4 = A.flash_decode_i8 if int8 else A.flash_decode
        p4 = A.flash_decode_i8_plain if int8 else A.flash_decode_plain
        k6 = PA.paged_decode_i8 if int8 else PA.paged_decode
        c4, c6 = {}, {}
        for what, Hq, Hkv, count in MANY_G:
            q = (torch.randn((1, Hq, DH), generator=gen, device=DEV)
                 * Q_SPREAD).bfloat16()
            fill = T_PREFILL
            caches = _attn_cache(gen, (1, Hkv, S_CACHE, DH), int8,
                                 _copies(2 * fill * Hkv * row))
            lengths = torch.tensor([fill], dtype=torch.int32, device=DEV)
            args = [(q, c[0], c[1], *(c[2:] if int8 else ()), lengths,
                     DH ** -0.5) for c in caches]
            kvs = [_bf16_kv(c) for c in caches]
            label = f"{what} heads ({Hq} over {Hkv}) decode fill {fill}"
            c4[label] = _attn_case(
                label, f"flash_decode{sfx}+G>8", lambda: k4(*args[0]),
                lambda: p4(*args[0]), 2 * fill * Hkv * row + Hq * DH * 6,
                _attn_ops(int8, DH, Hq, fill, False, True), tol, count,
                runs=[lambda a=a: k4(*a) for a in args],
                library=[lambda kv=kv: _sdpa(
                    q[:, :, None], kv[0][:, :, :fill], kv[1][:, :, :fill],
                    enable_gqa=True) for kv in kvs])
            del q, caches, args, kvs
            B, maxp = len(SERVER_FILLS), S_CACHE // ps
            P = B * maxp + 1
            table = torch.randperm(P - 1, generator=cpu)[:B * maxp] \
                .reshape(B, maxp).to(torch.int32).to(DEV)
            lengths = torch.tensor(SERVER_FILLS, dtype=torch.int32,
                                   device=DEV)
            q = (torch.randn((B, Hq, DH), generator=gen, device=DEV)
                 * Q_SPREAD).bfloat16()
            c = _attn_cache(gen, (P, Hkv, ps, DH), int8)[0]
            a6 = (q, c[0], c[1], *(c[2:] if int8 else ()), table, lengths,
                  DH ** -0.5)
            kd, vd = (PA.gather_pages(x, table) for x in _bf16_kv(c))
            mask = (torch.arange(maxp * ps, device=DEV)[None, :]
                    < lengths[:, None].long())[:, None, None, :]
            n = sum(SERVER_FILLS)
            label = f"{what} heads ({Hq} over {Hkv}) B={B} decode fills " \
                f"{SERVER_FILLS}"
            c6[label] = _attn_case(
                label, f"paged_decode{sfx}+G>8", lambda: k6(*a6),
                lambda: PA.paged_decode_plain(q, *c, table, lengths,
                                              DH ** -0.5),
                2 * n * Hkv * row + B * maxp * 4 + B * 4 + B * Hq * DH * 6,
                _attn_ops(int8, DH, Hq, n, False, True), tol, count,
                library=[lambda: _sdpa(q[:, :, None], kd, vd,
                                       attn_mask=mask, enable_gqa=True)])
            del q, c, a6, kd, vd, mask
            torch.cuda.empty_cache()
        _record(results, f"K4{sfx}_G>8", c4)
        _record(results, f"K6{sfx}_G>8", c6)


def branch_costs(results):
    """Each ALiBi and prefix case's time per launch over the same launch
    with the option off, as the checks recorded them."""
    out = {}
    for key in ("K3_alibi", "K3_i8_alibi", "K3_prefix", "K3_i8_prefix",
                "K4_alibi", "K4_i8_alibi", "K6_alibi", "K6_i8_alibi"):
        for label, c in results[key]["cases"].items():
            out[f"{key}: {label}"] = c["on_over_off"]
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------


# the 64-token prompt prefills through K5, the 512-token one through K2
GEN_BF16 = ("qmm4_npack", "qmm_a8", "qmm_general", "flash_prefill",
            "flash_decode")
GEN_INT8 = ("qmm4_npack", "qmm_a8", "flash_prefill_i8", "flash_decode_i8")


def _check_ids(new, n, what, vocab=V):
    if len(new) != n or not all(0 <= t < vocab for t in new):
        raise AssertionError(f"{what}: bad generated ids {new}")


def _check_served(out, n, what, cfg):
    """A Scheduler's ids: ``n`` of them, or fewer ending at an EOS."""
    stopped = out and out[-1] in cfg.eos_token_ids
    _check_ids(out, len(out) if stopped else n, what, cfg.vocab_size)


def decode_ms(params, fill, batch=1, kv_dtype=torch.bfloat16, lo=4, hi=36,
              cfg=CFG, S=S_CACHE):
    """ms per decode step: slope of ``decode_loop`` between lo and hi steps
    (best of 3 each) from a cache of ``S`` positions filled to ``fill``, a
    prompt of ``fill`` tokens (which a prefix-LM model's 2-D RoPE reads;
    the others ignore it)."""
    token = torch.full((batch, 1), 17, dtype=torch.long, device=DEV)

    def run(n):
        cache = init_cache(cfg, batch, S, kv_dtype, device=DEV)
        pos = torch.full((batch,), fill, dtype=torch.long, device=DEV)
        torch.cuda.synchronize()
        t = time.perf_counter()
        decode_loop(params, token, pos, cache, n, prompt_len=pos)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run(lo)
    t_lo = min(run(lo) for _ in range(3))
    t_hi = min(run(hi) for _ in range(3))
    return (t_hi - t_lo) / (hi - lo) * 1e3


def ttft_ms(params, kv_dtype=torch.bfloat16, cfg=CFG, T=T_PREFILL,
            S=S_CACHE):
    """T-token prefill with last-row logits on a fresh cache of S
    positions, best of 3 after a warm-up."""
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (1, T), generator=gen).to(DEV)
    start = torch.zeros(1, dtype=torch.long, device=DEV)

    def once():
        cache = init_cache(cfg, 1, S, kv_dtype, device=DEV)
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

    _decode_loop_vs_eager(params, prompts[0], outs[0][64])
    res = generate_fused(model, params, prompts[1])
    res["c5_residual_products_equal"] = check_c5_residual_rows(params,
                                                               prompts[1])
    for mode in (FUSED, FUSED_GLU):
        with fusion(mode):
            run_path(f"decode_loop_{mode[0]}", FUSED_DECODE[mode[0]],
                     lambda: _decode_loop_vs_eager(params, prompts[0],
                                                   outs[0][64], mode))
    res.update(run_path("ab_legs", ("qmm4_npack", "flash_decode",
                                    "flash_decode_i8")
                        + FUSED_DECODE["fused_glu"],
                        lambda: ab_device_legs(params)))

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
    res.update(ab_host_legs(params))
    res.update(decode_ms_fill128=d128, decode_ms_fill1975=d1975,
               decode_i8kv_ms_fill1975=d1975_i8, batch8_step_ms=b8,
               batch8_tok_s=8e3 / b8, ttft_1975_ms=ttft,
               ttft_1975_int8kv_ms=ttft_i8)
    return res


def _decode_loop_vs_eager(params, prompt, first, mode=None):
    """decode_loop replays one CUDA graph per token: it must give the ids
    of the same steps run eagerly, and write the same KV cache; with
    ``mode``, the graph's K1 launches are those of its fusion switches."""
    caches = [init_cache(CFG, 1, 256, device=DEV) for _ in range(2)]
    with torch.inference_mode():
        for c in caches:
            prefill_step(params, torch.tensor([prompt], device=DEV),
                         torch.zeros(1, dtype=torch.long, device=DEV), c)
        token = torch.tensor([[first]], device=DEV)
        pos = torch.tensor([len(prompt)], device=DEV)
        if mode is not None:
            g = _StepGraph(params, token, pos, init_cache(CFG, 1, 256,
                                                          device=DEV))
            check_step_launches(g.launches, mode, "decode_loop's graph")
            del g
        graphed = decode_loop(params, token, pos, caches[0], 12)[:, 0]
        eager = []
        for _ in range(12):
            logits = params(token, pos, caches[1], logits_dtype=torch.bfloat16)
            token = torch.argmax(logits[:, -1], dim=-1)[:, None]
            pos = pos + 1
            eager.append(int(token))
    what = "" if mode is None else f" ({mode[0]})"
    if graphed.tolist() != eager:
        raise AssertionError(f"decode_loop{what} {graphed.tolist()} != eager "
                             f"steps {eager}")
    if not torch.equal(caches[0].k, caches[1].k):
        raise AssertionError(f"decode_loop{what} wrote another KV cache than "
                             "the eager steps")
    log(f"decode_loop{what} (CUDA graph) = eager steps: {eager}")
    del caches


# the kernels a fused path must launch, by mode; the prefill's products
# (M = 64 or 512) take K5 or K2 as before
FUSED_DECODE = {
    "fused": ("qmm4_npack_fused", "qmm4_npack_fused+rms",
              "qmm4_npack_fused+res", "flash_decode"),
    "fused_glu": ("qmm4_npack_fused", "qmm4_npack_fused+rms",
                  "qmm4_npack_fused+res", "qmm4_npack_fused+glu",
                  "flash_decode")}


def _step_rows(model, cfg, ids, feed, kv_dtype=torch.bfloat16, cache=None):
    """The logits [V] (f32, on the CPU) of the prefill's last row and of
    one decode step per id of ``feed``, on the model's device, into a new
    cache or ``cache`` (which then holds the prompt for later steps).
    Decode steps take the prompt length, which a prefix-LM model reads."""
    dev = model.device
    if cache is None:
        cache = init_cache(cfg, 1, len(ids) + len(feed) + 1, kv_dtype,
                           device=dev)
    logits = prefill_step(model, torch.tensor([ids], device=dev),
                          torch.zeros(1, dtype=torch.long, device=dev), cache)
    return [logits[0, -1].float().cpu()] + _decode_rows(model, len(ids),
                                                        feed, cache)


def _decode_rows(model, n, feed, cache):
    """The logits rows (f32, on the CPU) of one decode step per id of
    ``feed`` after a prompt of ``n`` tokens that ``cache`` holds."""
    dev = model.device
    rows = []
    for step, tok in enumerate(feed):
        logits = model_step(model, torch.tensor([[tok]], device=dev),
                            torch.tensor([n + step], device=dev),
                            cache, torch.tensor([n], device=dev))
        rows.append(logits[0, -1].float().cpu())
    return rows


def _penalized(row, history):
    """``Model.generate``'s penalized logits (repetition penalty 1.1 over
    the last 64 ids of ``history``) of one step's row [V]."""
    sp = SamplingParams(greedy=True)
    hist = torch.tensor([history[-sp.repeat_last_n:]], dtype=torch.long)
    counts = token_counts(hist, torch.ones_like(hist, dtype=torch.bool),
                          row.shape[-1])
    return apply_penalties(row[None], counts, sp)[0]


def generate_fused(model, params, prompt, n_new=16):
    """``Model.generate`` (512-token prompt, greedy, bf16 KV) unfused, fused
    and fused with GLU, each a path with launch counts; then each mode's
    logits, teacher-forced on the unfused ids, against the unfused ones:
    the fused ids equal the unfused wherever the unfused penalized top-2
    margin exceeds twice the step's logit difference times the penalty,
    up to the first step where the runs part. Returns the largest
    difference per mode, relative to max|logit|."""
    new = {}
    for mode in MODES:
        with fusion(mode):
            out = run_path(f"generate_{mode[0]}", FUSED_DECODE.get(
                mode[0], ("qmm4_npack",)), lambda: model.generate(
                    prompt, max_new_tokens=n_new, do_sample=False,
                    stop_at_eos=False)[0])
        new[mode[0]] = out[len(prompt):]
        _check_ids(new[mode[0]], n_new, f"generate {mode[0]}")
    feed = new["unfused"]
    rows = {}
    with torch.inference_mode():
        for mode in MODES:
            with fusion(mode):
                rows[mode[0]] = _step_rows(params, CFG, prompt, feed[:-1])
    res = {}
    for name in ("fused", "fused_glu"):
        worst, proven = 0.0, 0
        for t, (a, b) in enumerate(zip(rows[name], rows["unfused"])):
            err = (a - b).abs().max().item()
            worst = max(worst, err / b.abs().max().item())
            pen = _penalized(b, prompt + feed[:t]).topk(2).values
            if (pen[0] - pen[1]).item() > 2 * 1.1 * err:
                proven += 1
                if new[name][t] != feed[t]:
                    raise AssertionError(
                        f"generate {name} id {new[name][t]} != unfused "
                        f"{feed[t]} at step {t} despite the margin")
            if new[name][t] != feed[t]:
                break
        log(f"Model.generate {name} (512-token prompt): ids {new[name]}, "
            f"unfused {feed}; logits against unfused, teacher-forced: max "
            f"err {worst:.3g}·max|logit|; ids proven equal at {proven} "
            f"steps before the runs part")
        # without GLU the fused step computes the unfused one's values (the
        # same roundings); with GLU the activation is rounded once where
        # the graph rounds it twice, and over 32 layers of random weights
        # the logits part by a few 1e-2·max|logit| (H100), wider than most
        # decode steps' margins: only the prefill, whose M = 512 products
        # are not fused, is sure to be proven there. Phase 5 holds the GLU
        # steps against the CPU's GLU path, with the same roundings
        if proven < (3 if name == "fused" else 1):
            raise AssertionError(f"generate {name}: too few steps with a "
                                 "margin wide enough to compare the ids")
        # C5: the fused rms prologue and the unfused graph's norm kernel
        # share one row-scale routine, so without GLU every logit is equal
        if name == "fused" and (worst != 0.0 or new[name] != feed):
            raise AssertionError(f"C5: fused logits part from unfused by "
                                 f"{worst}·max|logit| (ids {new[name]}, "
                                 f"unfused {feed})")
        res[f"generate_{name}_rel_err"] = worst
    return res


def check_c5_residual_rows(params, prompt, rows=16):
    """C5 over the 7B's own residual stream: the input of every block's
    attention norm and of the final norm, captured from an unfused prefill
    of ``prompt``, ``rows`` positions at a time (K1's widest M), through
    the fused rms prologue (q/k/v, and the lm_head for the final norm)
    against the unfused chain on the card (the norm kernel, then K1): every
    output bit for bit. Returns the number of products compared."""
    seen = {}

    def keep(l):
        return lambda mod, args: seen.__setitem__(l, args[0][0])

    hooks = [blk.register_forward_pre_hook(keep(l))
             for l, blk in enumerate(params.layers)]
    hooks.append(params.layers[-1].register_forward_hook(
        lambda mod, args, out: seen.__setitem__("final", out[0])))
    try:
        with fusion(UNFUSED), torch.inference_mode():
            prefill_step(params, torch.tensor([prompt], device=DEV),
                         torch.zeros(1, dtype=torch.long, device=DEV),
                         init_cache(CFG, 1, len(prompt), device=DEV))
    finally:
        for h in hooks:
            h.remove()
    gen = torch.Generator().manual_seed(13)
    sel = torch.randperm(len(prompt), generator=gen)[:rows].to(DEV)
    checked = 0
    for key, x in seen.items():
        with torch.inference_mode():
            checked += _c5_rows(params, key, x[sel].contiguous())
    log(f"C5 over the model's own residual rows ({rows} positions of a "
        f"{len(prompt)}-token prefill, every attention norm and the final "
        f"norm): {checked} fused products bit-identical to the unfused chain")
    return checked


def _c5_rows(params, key, xr):
    """Block ``key``'s q/k/v (or, for "final", the lm_head) on rows ``xr``
    of its norm's input: the fused rms prologue against the unfused chain,
    bit for bit. Returns the number of products compared."""
    if key == "final":
        pairs = [(params.final_norm_w, params.lm_head.qt, torch.float32)]
    else:
        blk = params.layers[key]
        pairs = [(blk.attn_norm_w, getattr(blk, n).qt, torch.bfloat16)
                 for n in ("wq", "wk", "wv")]
    for nw, qt, odt in pairs:
        norm = (nw, CFG.norm_eps, CFG.norm_offset)
        fused = Q.qmatmul_fused(xr, qt, odt, norm=norm)
        chain = Q.qmatmul(rms_norm(xr, *norm), qt, odt)
        if not torch.equal(fused, chain):
            d = (fused.float() - chain.float()).abs().max().item()
            raise AssertionError(f"C5: the fused rms route parts from the "
                                 f"unfused chain at {key}: {d}")
    return len(pairs)


# phase 4's device-timed legs: (name, fill, batch, KV dtype)
AB_LEGS = (("fill128_bf16", 128, 1, torch.bfloat16),
           ("fill1975_bf16", T_PREFILL, 1, torch.bfloat16),
           ("fill128_int8", 128, 1, torch.int8),
           ("fill1975_int8", T_PREFILL, 1, torch.int8),
           ("batch8_int8_fill128", 128, 8, torch.int8))
AB_REPS = 30


def _quartiles(ts):
    q = statistics.quantiles(ts, n=4)
    return dict(median=statistics.median(ts), q25=q[0], q75=q[2],
                min=min(ts), max=max(ts))


def ab_device_legs(params):
    """Each leg's decode step captured three times, once per mode, into
    ``decode_loop``'s CUDA graph (``_StepGraph``) on a cache of its own;
    the three graphs replayed in turns (the order rotated every round),
    each replay timed with CUDA events, AB_REPS replays a mode: the median
    and quartiles per mode. Each graph's K1 launches are checked against
    its mode. Then the verdict of the default rule: fused takes the place
    of unfused only if it is faster at fill 128 bf16 KV and at batch 8
    beyond the spread (its 75th percentile under unfused's 25th) and at
    no leg slower (its 25th percentile over unfused's 75th); the same rule
    for GLU against fused without it."""
    stats = {}
    for leg, fill, batch, kv in AB_LEGS:
        graphs = {}
        with torch.inference_mode():
            for mode in MODES:
                with fusion(mode):
                    cache = init_cache(CFG, batch, S_CACHE, kv, device=DEV)
                    token = torch.full((batch, 1), 17, dtype=torch.long,
                                       device=DEV)
                    pos = torch.full((batch,), fill, dtype=torch.long,
                                     device=DEV)
                    g = _StepGraph(params, token, pos, cache)
                check_step_launches(g.launches, mode, f"leg {leg}")
                graphs[mode[0]] = (g, cache)
        names = [m[0] for m in MODES]
        ts = {n: [] for n in names}
        torch.cuda.synchronize()
        for r in range(AB_REPS):
            for n in names[r % 3:] + names[:r % 3]:
                g = graphs[n][0]
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                g.graph.replay()
                e1.record()
                e1.synchronize()
                _cuda.add_launches(g.launches)
                ts[n].append(e0.elapsed_time(e1))
        stats[leg] = {n: _quartiles(t) for n, t in ts.items()}
        log(f"A/B leg {leg} (device time of one graph replay, {AB_REPS} "
            "each, in turns): " + "; ".join(
                f"{n} median {v['median']:.4f} ms (q25 {v['q25']:.4f}, q75 "
                f"{v['q75']:.4f}, min {v['min']:.4f}, max {v['max']:.4f})"
                for n, v in stats[leg].items()))
        del graphs
        torch.cuda.empty_cache()

    def verdict(new, old):
        faster = lambda leg: stats[leg][new]["q75"] < stats[leg][old]["q25"]
        slower = [leg for leg in stats
                  if stats[leg][new]["q25"] > stats[leg][old]["q75"]]
        return faster("fill128_bf16") and faster("batch8_int8_fill128") \
            and not slower, slower
    fused_on, fused_slower = verdict("fused", "unfused")
    glu_on, glu_slower = verdict("fused_glu", "fused")
    log(f"A/B verdict on {smi_line()}: fused over unfused: "
        f"{'faster' if fused_on else 'not faster'} at fill 128 bf16 and "
        f"batch 8, slower at {fused_slower or 'no leg'} -> this run "
        f"{'meets' if fused_on else 'does not meet'} the rule for "
        f"NTPU_FUSED_DECODE on; GLU over fused: "
        f"{'faster' if glu_on else 'not faster'}, slower at "
        f"{glu_slower or 'no leg'} -> {'meets' if glu_on else 'does not meet'}"
        f" the rule for NTPU_FUSE_GLU on (the package's defaults: "
        f"models.transformer.fuse_mode, fuse_glu)")
    out = {f"ab_{leg}_{n}_ms": v["median"] for leg, d in stats.items()
           for n, v in d.items()}
    out.update(ab_fused_default=int(fused_on), ab_glu_default=int(glu_on))
    return out


def ab_host_legs(params):
    """The host-clock slope legs (decode at fill 128 bf16 KV, batch 8 int8
    KV) in each mode, and the 1975-token TTFT (whose only fused product is
    the lm_head) unfused and fused, one after the other."""
    out = {}
    for mode in MODES:
        with fusion(mode):
            out[f"decode_ms_fill128_{mode[0]}"] = decode_ms(params, 128)
            out[f"batch8_step_ms_{mode[0]}"] = decode_ms(
                params, 128, batch=8, kv_dtype=torch.int8)
            if mode is not FUSED_GLU:
                out[f"ttft_1975_ms_{mode[0]}"] = ttft_ms(params)
    log("host-clock legs by mode: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out.items()))
    return out


# the kernels each format's prefill (1975 tokens, last-row lm_head at M=1)
# and decode (M=1) must launch, by the JAX package's route; int6_g128_a8 is
# ``quant_config_from_args("int6", group_size=128)`` (int8 code planes,
# int8 activations), mix_i2_ffn the JAX package's decode-bytes recipe
# (gate/up native int2 g32 sym with bf16 activations, the rest q4_j)
FORMAT_PATHS = {
    "nf4": (("qmm_general+tc", "flash_prefill"),
            ("qmm_general+gemv", "flash_decode")),
    "q4_0": (("qmm_general+tc", "qmm4_npack", "flash_prefill"),
             ("qmm4_npack", "flash_decode")),
    "q4_j_i8_g128": (("quantize_act_i8", "qmm_a8_asym", "qmm4_npack_asym",
                      "flash_prefill"), ("qmm4_npack_asym", "flash_decode")),
    "int6_g128_a8": (("quantize_act_i8", "qmm_a8_int8", "qmm8_native",
                      "flash_prefill"), ("qmm8_native", "flash_decode")),
    "mix_i2_ffn": (("quantize_act_i8", "qmm_a8", "qmm_general+tc", "qmm4_npack",
                    "flash_prefill"),
                   ("qmm4_npack", "qmm2_npack", "flash_decode")),
}


# the formats whose sym codes at rest take K1's other fused entry points
# (int6 g128 a8: int8 code planes everywhere; mix_i2_ffn: int2 gate/up
# beside its q4_j rest): the plain entries their unfused generate must
# launch, and the fused ones of a short paged bf16 server run (the fused
# path is the card's default)
UNFUSED_FORMAT_PATHS = {"int6_g128_a8": ("qmm8_native",),
                        "mix_i2_ffn": ("qmm2_npack", "qmm4_npack")}
FUSED_SERVER_PATHS = {
    "int6_g128_a8": ("qmm8_native_fused", "qmm8_native_fused+rms",
                     "qmm8_native_fused+res", "paged_decode"),
    "mix_i2_ffn": ("qmm2_npack_fused", "qmm2_npack_fused+rms",
                   "qmm4_npack_fused", "qmm4_npack_fused+res",
                   "paged_decode"),
}


# ---------------------------------------------------------------------------
# phase 4i: sampling, beams, batches of prompts and StreamingLLM on the 7B
# ---------------------------------------------------------------------------

# the kernels each path of phase 4i must launch: a prefill of 256 tokens or
# more (K2, K3) and decode steps (K1, K4)
GEN_PREFILL = ("qmm4_npack", "qmm_a8", "flash_prefill", "flash_decode")
GEN_STEPS = ("qmm4_npack", "flash_decode")
SAMPLED = SamplingParams(temperature=0.8, top_k=40, top_p=0.95)
N_SAMPLED = 32


def _host_ms(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def step_graphs_ms(params, fill, batch, reps=AB_REPS):
    """The device time of one decode step at ``fill``, batch ``batch``, for
    the sampled step (one captured ``_SampledStep``, ``sample_loop``'s
    graph: top-k 40, top-p 0.95, temperature 0.8, the penalty over a 64-id
    history; the noise refill and one replay) and the greedy one
    (``_StepGraph``, ``decode_loop``'s graph), each on a cache of its own,
    replayed in turns with CUDA events around each; each state is put back
    to ``fill`` before its replay. Returns the quartiles of each."""
    g = torch.Generator().manual_seed(17)
    token = torch.full((batch, 1), 17, dtype=torch.long, device=DEV)
    pos = torch.full((batch,), fill, dtype=torch.long, device=DEV)
    hist = torch.randint(3, V, (batch, 64), generator=g).to(DEV)
    with torch.inference_mode():
        st = _SampledStep(params, init_cache(CFG, batch, S_CACHE, device=DEV),
                          SAMPLED, token, pos, hist, generator=torch.Generator(
                              device=DEV).manual_seed(1))
        st.capture()
        greedy = _StepGraph(params, token, pos,
                            init_cache(CFG, batch, S_CACHE, device=DEV))
        steps = {"sampled": (st.step, st.pos),
                 "greedy": (greedy.replay, greedy.pos)}
        ts = {n: [] for n in steps}
        for r in range(reps + 1):
            for n, (fn, p) in steps.items():
                p.fill_(fill)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fn()
                e1.record()
                e1.synchronize()
                if r:                         # the first round warms up
                    ts[n].append(e0.elapsed_time(e1))
    del st, greedy
    return {n: _quartiles(t) for n, t in ts.items()}


def _sampled_step_draws(params):
    """``sample_loop``'s graphed step draws anew at each replay: 16 replays
    from one pinned state (token, position and cache slot put back each
    time) give more than one id, where a draw baked into the graph would
    give one; and a seed fixes the ids: two runs from one seed give the
    same ids, another seed other ids."""
    token = torch.full((1, 1), 17, dtype=torch.long, device=DEV)
    pos = torch.full((1,), 128, dtype=torch.long, device=DEV)
    with torch.inference_mode():
        st = _SampledStep(params, init_cache(CFG, 1, 256, device=DEV),
                          SAMPLED, token, pos, generator=torch.Generator(
                              device=DEV).manual_seed(3))
        st.capture()
        pinned = []
        for _ in range(16):
            st.token.fill_(17)
            st.pos.fill_(128)
            pinned.append(int(st.step()[0]))
    if len(set(pinned)) < 2:
        raise AssertionError(f"16 replays of the sampled step from one "
                             f"state drew one id: {pinned}")
    del st

    def ids(seed):
        cache = init_cache(CFG, 1, 256, device=DEV)
        gen = torch.Generator(device=DEV).manual_seed(seed)
        return sample_loop(params, token, pos, cache, 16, SAMPLED,
                           gen)[:, 0].tolist()

    a, b, c = ids(7), ids(7), ids(8)
    if a != b or a == c:
        raise AssertionError(f"sample_loop seeds: {a} / {b} / {c}")
    log(f"sample_loop's graph: 16 replays from one pinned state drew "
        f"{len(set(pinned))} distinct ids {pinned}; seed 7 gave {a} twice, "
        f"seed 8 {c}")


def _batched_rows(model, prompts, feed):
    """The logits rows of a padded batch, teacher-forced: the ragged
    prefill's last real rows, then one batched step per id of ``feed`` (a
    list per row); a list over steps of [B, V] f32 on the CPU."""
    B, n = len(prompts), len(feed[0])
    lens = torch.tensor([len(p) for p in prompts], device=DEV)
    toks = torch.zeros((B, int(lens.max())), dtype=torch.long)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = torch.tensor(p)
    cache = init_cache(CFG, B, int(lens.max()) + n + 1, device=DEV)
    rows = [_prefill_ragged(model, toks.to(DEV), lens, cache).float().cpu()]
    for t in range(n - 1):
        tok = torch.tensor([[f[t]] for f in feed], device=DEV)
        rows.append(model_step(model, tok, lens + t, cache)[:, -1]
                    .float().cpu())
    return rows


def _proven_equal(got, want, refs, others, histories, what):
    """Ids ``got`` against ``want`` step by step: each step's logits row of
    the reference (``refs``) against the other computation's (``others``);
    where the reference's penalized top-2 margin exceeds twice the largest
    difference times the penalty 1.1 the argmax is proven the same, and the
    ids may part only at a step not proven. ``histories`` None: no penalty
    (margin over twice the difference). Returns the steps proven."""
    proven = 0
    for t, (a, b) in enumerate(zip(others, refs)):
        err = (a - b).abs().max().item()
        if histories is None:
            pen, rp = b.topk(2).values, 1.0
        else:
            pen, rp = _penalized(b, histories + want[:t]).topk(2).values, 1.1
        sure = (pen[0] - pen[1]).item() > 2 * rp * err
        if got[t] != want[t]:
            if sure:
                raise AssertionError(f"{what}: id {got[t]} != {want[t]} at "
                                     f"step {t} despite the margin")
            break
        proven += sure
    return proven


def _batch_of_prompts(model, params):
    """``Model.generate`` over four ragged prompts (128, 512, 1024 and 1975
    tokens, 32 new each, greedy): the padded prefill's time, the batched
    step's, and the ids against the row-wise ``Model.generate``'s where the
    margins prove them (the batch prefills the 128-token row through K2 at
    M = 7900 where the row alone takes K5, and decodes at M = 4)."""
    g = torch.Generator().manual_seed(19)
    prompts = [torch.randint(3, V, (n,), generator=g).tolist()
               for n in (128, 512, 1024, T_PREFILL)]
    kw = dict(max_new_tokens=N_SAMPLED, stop_at_eos=False, ignore_prompt=True)
    out, total = _host_ms(lambda: run_path(
        "generate_batch4", GEN_PREFILL, lambda: model.generate(prompts,
                                                               **kw)))
    for o in out:
        _check_ids(o, N_SAMPLED, "generate batch of 4")
    lens = torch.tensor([len(p) for p in prompts], device=DEV)
    toks = torch.zeros((4, T_PREFILL), dtype=torch.long)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = torch.tensor(p)
    toks = toks.to(DEV)

    def prefill():
        cache = init_cache(CFG, 4, T_PREFILL + N_SAMPLED, device=DEV)
        return _host_ms(lambda: _prefill_ragged(params, toks, lens,
                                                cache))[1]

    prefill()
    pre = min(prefill() for _ in range(3))
    step = (total - pre) / (N_SAMPLED - 1)
    rowwise = [model.generate(p, **kw)[0] for p in prompts]
    with torch.inference_mode():
        refs = [_step_rows(params, CFG, p, f[:-1])
                for p, f in zip(prompts, rowwise)]
        batch = _batched_rows(params, prompts, rowwise)
    proven = sum(_proven_equal(out[b], rowwise[b], refs[b],
                               [r[b] for r in batch], prompts[b],
                               f"batch row {b} vs row-wise")
                 for b in range(4))
    log(f"Model.generate, 4 prompts of 128/512/1024/1975 tokens, "
        f"{N_SAMPLED} new each: {total:.1f} ms; the padded prefill "
        f"(M = 4 x 1975) {pre:.2f} ms, then {step:.3f} ms a batched step "
        f"(host clock); ids equal the row-wise ones at {proven} steps the "
        f"margins prove, up to each row's first unproven parting")
    if proven < 4:
        raise AssertionError("batch of prompts: too few proven steps")
    return dict(batch4_prefill_ms=pre, batch4_step_ms=step,
                batch4_proven_steps=proven)


def _beams(model, params):
    """``Model.generate(num_beams=4)`` on a 128-token prompt, 32 new
    tokens: the beam step's host time (the run less the prompt's one-row
    prefill and its copy to the other rows, over its steps); one beam step
    (``_beam_step``: the eager forward of the 4 rows, ``log_softmax`` and
    the joint top-4) on the device's clock, CUDA events around each of 10
    calls after a warm-up, the median; and
    ``reorder_batch``'s device time at this run's cache (S = 160) and at S
    = 2048, bf16, against the bytes it moves."""
    g = torch.Generator().manual_seed(23)
    prompt = torch.randint(3, V, (128,), generator=g).tolist()
    out, total = _host_ms(lambda: run_path(
        "generate_beams4", ("qmm4_npack", "qmm_general", "flash_prefill",
                            "flash_decode"), lambda: model.generate(
            prompt, max_new_tokens=N_SAMPLED, num_beams=4)[0]))
    new = out[len(prompt):]
    _check_ids(new, len(new), "beam search")
    one = torch.tensor([prompt], device=DEV)

    def prefill(cache):
        prefill_step(params, one, torch.zeros(1, dtype=torch.long,
                                              device=DEV), cache.rows(0, 1))
        copy_kv(cache, [0] * 3, range(1, 4), len(prompt))

    def timed_prefill():
        cache = init_cache(CFG, 4, len(prompt) + N_SAMPLED, device=DEV)
        return _host_ms(lambda: prefill(cache))[1]

    timed_prefill()
    pre = min(timed_prefill() for _ in range(3))
    step = (total - pre) / max(1, len(new) - 1)
    ts = []
    with torch.inference_mode():
        cache = init_cache(CFG, 4, len(prompt) + N_SAMPLED, device=DEV)
        prefill(cache)
        args = (torch.full((4, 1), 17, dtype=torch.long, device=DEV),
                torch.full((4,), len(prompt), dtype=torch.long, device=DEV),
                torch.zeros(4, device=DEV), cache,
                torch.ones(4, dtype=torch.bool, device=DEV),
                torch.zeros(V, device=DEV), 4)
        for r in range(11):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            _beam_step(params, *args)
            e1.record()
            e1.synchronize()
            if r:
                ts.append(e0.elapsed_time(e1))
        del cache
    dev_step = statistics.median(ts)
    res = dict(beams4_step_ms=step, beams4_step_device_ms=dev_step,
               beams4_prefill_ms=pre)
    perm = torch.tensor([1, 0, 3, 2], device=DEV)
    for S in (len(prompt) + N_SAMPLED, S_CACHE):
        cache, spare = (init_cache(CFG, 4, S, device=DEV) for _ in range(2))
        ms = time_ms([lambda: reorder_batch(cache, perm, spare)], reps=10)
        nbytes = 2 * 2 * cache.k.numel() * cache.k.element_size()
        bnd = nbytes / HBM_BPS * 1e3
        log(f"reorder_batch, 4 beams, S={S}: {ms:.4f} ms for "
            f"{nbytes / 1e9:.3f} GB read and written "
            f"({nbytes / (ms * 1e-3) / 1e12:.3f} TB/s; bound {bnd:.4f} ms)")
        res[f"reorder_ms_S{S}"] = ms
        del cache, spare
    log(f"Model.generate num_beams=4, 128-token prompt: {total:.1f} ms, "
        f"{len(new)} new ids; one-row prefill and copy {pre:.2f} ms, then "
        f"{step:.3f} "
        f"ms a beam step (host clock, the reorder and the host's bookkeeping "
        f"included); one _beam_step {dev_step:.3f} ms on the device's clock "
        f"(median of 10, min {min(ts):.3f}, max {max(ts):.3f}); ids {new}")
    return res


def _streaming(model, params):
    """``Model.generate(streaming=True)`` with a 512-position cache, 4
    sinks, a 256-token prompt and 600 new tokens, bf16 and int8 KV: the
    shifts counted (two: at 256 and 510 new tokens), each timed on the host
    clock in the run, and one shift's device time at the 7B's width."""
    g = torch.Generator().manual_seed(29)
    prompt = torch.randint(3, V, (256,), generator=g).tolist()
    res = {}
    for kv, kvdt, attn in (("bf16", torch.bfloat16, ("flash_prefill",
                                                      "flash_decode")),
                           ("int8", torch.int8, ("flash_prefill_i8",
                                                 "flash_decode_i8"))):
        shifts, orig = [], ST.shift_cache_impl

        def counted(*a, **k):
            _, ms = _host_ms(lambda: orig(*a, **k))
            shifts.append(ms)

        ST.shift_cache_impl = counted
        try:
            out, total = _host_ms(lambda: run_path(
                f"generate_streaming_{kv}", ("qmm4_npack", "qmm_a8") + attn,
                lambda: model.generate(prompt, max_new_tokens=600,
                                       streaming=True, max_len=512, n_keep=4,
                                       kv_dtype=kv, stop_at_eos=False,
                                       ignore_prompt=True)[0]))
        finally:
            ST.shift_cache_impl = orig
        _check_ids(out, 600, f"streaming {kv}")
        if len(shifts) < 2:
            raise AssertionError(f"streaming {kv}: {len(shifts)} shifts")
        cache = init_cache(CFG, 1, 512, kvdt, device=DEV)
        dev_ms = time_ms([lambda: ST.shift_cache_impl(
            cache, params.rope_inv_freqs, CFG, 4, 254)], reps=10)
        nbytes = 2 * sum(t.numel() * t.element_size() for t in (
            cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None)
        log(f"streaming {kv} KV, 512 positions, 600 new tokens: {total:.1f} "
            f"ms ({total / 600:.3f} ms a token, host clock); {len(shifts)} "
            f"shifts, host ms {[round(x, 3) for x in shifts]}; one shift's "
            f"device time {dev_ms:.4f} ms for {nbytes / 1e9:.3f} GB read and "
            f"written at most (bound {nbytes / HBM_BPS * 1e3:.4f} ms)")
        res.update({f"stream_{kv}_ms_token": total / 600,
                    f"stream_{kv}_shifts": len(shifts),
                    f"stream_{kv}_shift_ms": dev_ms})
        del cache
    return res


def _chi_square_p(draws, probs):
    """The chi-square p-value of ``draws`` [N] against ``probs`` [V] (bins
    expecting fewer than 5 draws pooled); raises on a draw outside the
    support."""
    from scipy.stats import chisquare
    counts = np.bincount(draws, minlength=len(probs))
    if counts[probs == 0].sum():
        raise AssertionError("a draw outside the kept set")
    exp = probs * len(draws)
    big = exp >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(exp[big], exp[~big].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    return chisquare(obs, exp * obs.sum() / exp.sum()).pvalue


def _sampler(params):
    """``sample_batched`` and ``sample`` with the filters (temperature 0.8,
    top-k 40, top-p 0.95) on one logits row over the 7B's vocab, replicated
    in 4096 rows: each one's draws against the filtered softmax that the port's plain
    filters give on the CPU (chi-square, p > 1e-4). Then the sampler's
    device times at B = 1 and 4: ``sample`` with the filters and the
    penalty, and ``sample_batched`` with filters and mirostat."""
    g = torch.Generator(device=DEV).manual_seed(31)
    row = torch.randn((1, V), generator=g, device=DEV) * 3
    bp = batch_params([SAMPLED] * 4096).to(DEV)
    tok, _ = sample_batched(row.expand(4096, V).contiguous(), bp,
                            enable=("filters",), generator=g)
    host = row.cpu() / torch.full_like(row.cpu(), SAMPLED.temperature)
    kept = top_p_filter(top_k_filter(host, SAMPLED.top_k), SAMPLED.top_p)
    kept = kept[0].double()
    probs = torch.softmax(kept, -1).numpy() * (kept.numpy() > -1e29)
    probs /= probs.sum()
    p = _chi_square_p(tok.cpu().numpy(), probs)
    tok1, _ = sample(row.expand(4096, V).contiguous(), SAMPLED, generator=g)
    p1 = _chi_square_p(tok1.cpu().numpy(), probs)
    if not (p > 1e-4 and p1 > 1e-4):
        raise AssertionError(f"draws against the filtered softmax: "
                             f"chi-square p {p} (sample_batched), {p1} "
                             "(sample)")
    res = dict(sampler_chi_square_p=p, sample_chi_square_p=p1)
    hist = torch.randint(3, V, (4, 64), device=DEV)
    for B in (1, 4):
        logits = torch.randn((B, V), generator=g, device=DEV) * 3
        noise = draw_noise((B, V), DEV, g)
        bpb = batch_params([SAMPLED] * B).to(DEV)
        mu = torch.full((B,), 10.0, device=DEV)
        ms = time_ms([lambda: sample(logits, SAMPLED, prev_tokens=hist[:B],
                                     noise=noise)], reps=10)
        msb = time_ms([lambda: sample_batched(logits, bpb, mu,
                                              prev_tokens=hist[:B],
                                              noise=noise)], reps=10)
        log(f"sampler at B={B}, vocab {V}: sample (penalty, temperature, "
            f"top-k, top-p, draw) {ms:.4f} ms; sample_batched (filters and "
            f"mirostat) {msb:.4f} ms (device)")
        res.update({f"sample_ms_B{B}": ms, f"sample_batched_ms_B{B}": msb})
    log(f"4096 draws from one 32000-wide row (top-k 40, top-p 0.95, "
        f"temperature 0.8) against the filtered softmax: chi-square p = "
        f"{p:.4g} (sample_batched), {p1:.4g} (sample)")
    return res


def phase_sampling(params):
    """Phase 4i on phase 4's 7B: ``Model.generate`` sampled (one seed twice,
    then another), ``sample_loop``'s graphed step against ``decode_loop``'s
    at fill 128 (batch 1 and 4), a batch of four ragged prompts, beam search
    (4 beams), StreamingLLM with bf16 and int8 KV, and the sampler's draws
    and device times; each ``Model.generate`` a path with its own launch
    counts."""
    model = Model().init_params(params, CFG)
    g = torch.Generator().manual_seed(37)
    prompt = torch.randint(3, V, (512,), generator=g).tolist()
    kw = dict(max_new_tokens=N_SAMPLED, do_sample=True, top_k=40, top_p=0.95,
              temperature=0.8, stop_at_eos=False, ignore_prompt=True)
    runs = [run_path(f"generate_sampled_{i}", GEN_PREFILL,
                     lambda: model.generate(prompt, seed=seed, **kw)[0])
            for i, seed in enumerate((5, 5, 6))]
    for r in runs:
        _check_ids(r, N_SAMPLED, "sampled generate")
    if runs[0] != runs[1] or runs[0] == runs[2]:
        raise AssertionError(f"sampled generate, seeds 5, 5, 6: {runs}")
    log(f"Model.generate sampled (512-token prompt, top-k 40, top-p 0.95, "
        f"temperature 0.8): seed 5 twice {runs[0]}, seed 6 {runs[2]}")
    run_path("sample_loop_seeds", GEN_STEPS,
             lambda: _sampled_step_draws(params))
    res = {}
    for B in (1, 4):
        q = run_path(f"sample_loop_B{B}", GEN_STEPS,
                     lambda: step_graphs_ms(params, 128, B))
        log(f"decode step at fill 128, batch {B} (device time of one graph "
            f"replay, {AB_REPS} each, in turns): " + "; ".join(
                f"{n} median {v['median']:.4f} ms (q25 {v['q25']:.4f}, q75 "
                f"{v['q75']:.4f})" for n, v in q.items()))
        res.update({f"{n}_step_ms_B{B}": v["median"] for n, v in q.items()})
    res.update(_batch_of_prompts(model, params))
    res.update(_beams(model, params))
    res.update(_streaming(model, params))
    res.update(_sampler(params))
    return res


def phase_formats(fmts=("nf4", "q4_0", "q4_j_i8_g128")):
    """The same 7B shape in each format of ``fmts``, one model at a time:
    ``Model.generate`` (300-token prompt, 16 new tokens, greedy, bf16 KV),
    the 1975-token TTFT and decode ms/token at fill 128, each a path of its
    own with the launch counts set to 0 just before it; a format of
    UNFUSED_FORMAT_PATHS also generates with the fused path off, and serves
    two short queries through the batch-8 paged bf16 server with it on,
    each a path of its own."""
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(3, V, (300,), generator=gen).tolist()
    res = {}
    for fmt in fmts:
        pre, dec = FORMAT_PATHS[fmt]
        t = time.time()
        params = init_random(CFG, seed=0, quant=QUANTS.get(fmt, fmt),
                             device=DEV)
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
        if fmt in UNFUSED_FORMAT_PATHS:
            with fusion(UNFUSED):
                plain = run_path(f"generate_{fmt}_unfused",
                                 UNFUSED_FORMAT_PATHS[fmt],
                                 lambda: model.generate(
                                     prompt, max_new_tokens=16,
                                     do_sample=False, stop_at_eos=False)[0])
            log(f"{fmt}: Model.generate unfused new ids {plain[300:]}")
            _check_ids(plain[300:], 16, f"generate {fmt} unfused")
            with fusion(FUSED):
                _server_short(params, CFG, ((
                    f"server_{fmt}_fused", dict(kv_mode="paged",
                                                page_size=256),
                    FUSED_SERVER_PATHS[fmt], [prompt[:90], prompt[:200]],
                    8),))
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
# phase 4c: Gemma-2-9B at full width and depth
# ---------------------------------------------------------------------------

# Gemma-2-9B as published in google/gemma-2-9b's config.json: 42 layers,
# hidden 3584, 16 heads over 8 KV heads of 256, FFN 14336, vocab 256000
# with tied embeddings, sliding window 4096 (on the even layers),
# attn_logit_softcapping 50, final_logit_softcapping 30,
# query_pre_attn_scalar 256, rope_theta 10000, max_position_embeddings
# 8192, rms_norm_eps 1e-6, hidden_activation gelu_pytorch_tanh, bos 2,
# eos 1. The (1 + w) norms, the post norms and the sqrt(hidden) embedding
# scale are the family's (neural_tpu_torch/models/gemma.py).
G2_CFG = ModelConfig(
    arch="gemma2", vocab_size=256000, hidden_size=3584, n_layers=42,
    n_heads=G2_HQ, n_kv_heads=G2_HKV, head_dim=G2_DH,
    intermediate_size=14336, norm_eps=1e-6, norm_offset=1.0,
    act="gelu_tanh", post_attn_norm=True, post_ffn_norm=True,
    attn_softcap=G2_SOFTCAP, logit_softcap=30.0, attn_scale=256 ** -0.5,
    sliding_window=G2_W, rope_theta=10000.0, tie_word_embeddings=True,
    embed_scale=math.sqrt(3584), max_seq_len=G2_S, bos_token_id=2,
    eos_token_id=1)
G2_GEN = ("qmm4_npack", "qmm_a8", "flash_prefill", "flash_decode")
G2_GEN_INT8 = ("qmm4_npack", "qmm_a8", "flash_prefill_i8",
               "flash_decode_i8")


def phase_gemma2():
    """Gemma-2-9B at q4_j, random weights from seed 0 drawn and quantized
    on the card: ``Model.generate`` (512-token prompt, 16 new tokens) with
    bf16 and int8 KV, decode ms/token at fills 128 and 6000 (bf16 KV) and
    6000 (int8 KV), TTFT at 1975 and 6000 tokens; every cache holds 8192
    positions. Each is a path with its own launch counts."""
    t = time.time()
    torch.cuda.reset_peak_memory_stats()
    params = init_random(G2_CFG, seed=0, quant="q4_j", device=DEV)
    torch.cuda.synchronize()
    nbytes = sum(b.numel() * b.element_size() for b in params.buffers())
    log(f"init_random Gemma-2-9B q4_j on the card: {time.time() - t:.1f} s, "
        f"{nbytes / 1e9:.3f} GB of weights and embedding; decode bound "
        f"{nbytes / HBM_BPS * 1e3:.3f} ms/token before the KV read")
    model = Model().init_params(params, G2_CFG)
    gen = torch.Generator().manual_seed(9)
    prompt = torch.randint(3, G2_CFG.vocab_size, (512,),
                           generator=gen).tolist()
    res = {}
    for kv, required in (("bf16", G2_GEN), ("int8", G2_GEN_INT8)):
        out = run_path(f"gemma2_generate_{kv}", required,
                       lambda: model.generate(prompt, max_new_tokens=16,
                                              do_sample=False,
                                              stop_at_eos=False,
                                              kv_dtype=kv)[0])
        _check_ids(out[512:], 16, f"gemma2 generate {kv}", G2_CFG.vocab_size)
        log(f"gemma2 Model.generate greedy, {kv} KV, 512-token prompt: new "
            f"ids {out[512:]}")
    dec = ("qmm4_npack", "flash_decode")
    for fill, kv_dtype, required in ((128, torch.bfloat16, dec),
                                     (G2_FILL, torch.bfloat16, dec),
                                     (G2_FILL, torch.int8,
                                      ("qmm4_npack", "flash_decode_i8"))):
        kv = "int8" if kv_dtype == torch.int8 else "bf16"
        ms = run_path(f"gemma2_decode_{kv}_fill{fill}", required,
                      lambda: decode_ms(params, fill, kv_dtype=kv_dtype,
                                        cfg=G2_CFG, S=G2_S))
        log(f"gemma2 decode (slope n=4..36, batch 1, {kv} KV): fill {fill} "
            f"{ms:.3f} ms/token ({1e3 / ms:.1f} tok/s)")
        res[f"gemma2_decode_{'i8kv_' if kv == 'int8' else ''}ms_fill{fill}"] \
            = ms
    for T in (T_PREFILL, G2_FILL):
        ms = run_path(f"gemma2_prefill_{T}", ("qmm_a8", "flash_prefill"),
                      lambda: ttft_ms(params, cfg=G2_CFG, T=T, S=G2_S))
        log(f"gemma2 TTFT {T}-token prefill (last-row logits, bf16 KV): "
            f"{ms:.2f} ms")
        res[f"gemma2_ttft_{T}_ms"] = ms
    res["gemma2_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"gemma2 peak device memory {res['gemma2_peak_gib']:.2f} GiB")
    del model, params
    torch.cuda.empty_cache()
    return res


def phase_gemma2_card_vs_plain():
    """A 2-layer copy of Gemma-2-9B at full width, its window cut to 32 so
    that it is active on every prompt here: ``Model.generate`` on the card
    (300-token prompt, 4 new tokens; a path with launch counts), its
    logits fed the card's ids against the CPU plain path; then, on this
    copy, the paged int8 Scheduler check that phase 5 runs on the Llama
    copy (prompts of 20-64 tokens)."""
    cfg2 = dataclasses.replace(G2_CFG, n_layers=2, sliding_window=32)
    card = init_random(cfg2, seed=3, quant="q4_j", device=DEV)
    host = init_random(cfg2, seed=3, quant="q4_j", device=DEV).to("cpu")
    gen = torch.Generator().manual_seed(10)
    ids = torch.randint(3, cfg2.vocab_size, (300,), generator=gen).tolist()
    model = Model().init_params(card, cfg2)
    new = run_path("card_gemma2", G2_GEN, lambda: model.generate(
        ids, max_new_tokens=4, do_sample=False,
        stop_at_eos=False)[0])[len(ids):]
    _check_ids(new, 4, "card gemma2", cfg2.vocab_size)
    rel_tol = 5e-2     # int8 activation codes can move, as for q4_j Llama
    worst, provable, _ = _steps_card_vs_plain(card, host, cfg2, ids,
                                              new[:3], rel_tol)
    log(f"gemma2 card vs plain (2 layers, full width, window 32, 300-token "
        f"prompt, fed the card's ids {new}): logits max err "
        f"{worst:.3g}·max|logit| (tol {rel_tol}); argmax provably "
        f"comparable at {provable} of 4 steps, equal at all of them")
    if provable < 2:
        raise AssertionError("too few gemma2 steps with a margin wide "
                             "enough to compare the argmax")
    sched_worst = _sched_card_vs_plain(card, host, cfg2, rel_tol)
    del card, host, model
    torch.cuda.empty_cache()
    return dict(gemma2_card_vs_plain_rel_err=worst,
                gemma2_sched_card_vs_plain_rel_err=sched_worst)


# ---------------------------------------------------------------------------
# phase 5: the card against the plain path on the CPU
# ---------------------------------------------------------------------------


def _compare_rows(card_rows, host_rows, rel_tol, what="card vs plain"):
    """Logits rows of the card and of the CPU's plain path: within
    ``rel_tol`` of max|logit| at every step, and the argmax equal wherever
    the plain top-2 margin exceeds twice that step's largest logit
    difference. Returns (worst relative difference, steps so proven,
    argmax equal at each step)."""
    worst, provable, sames = 0.0, 0, []
    for step, (a, b) in enumerate(zip(card_rows, host_rows)):
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
            raise AssertionError(f"{what} logits, step {step}: max err "
                                 f"{err} > {tol}")
        if margin > 2 * err:
            provable += 1
            if not same:
                raise AssertionError(f"{what} argmax differs at step {step} "
                                     f"despite margin {margin}")
    return worst, provable, sames


def _steps_card_vs_plain(card, host, cfg2, ids, feed, rel_tol):
    """Logits of the prefill's last row and of one decode step per id of
    ``feed``, on the card and on the CPU's plain path, held to each other
    by :func:`_compare_rows`."""
    return _compare_rows(_step_rows(card, cfg2, ids, feed),
                         _step_rows(host, cfg2, ids, feed), rel_tol)


def phase_card_vs_plain():
    cfg2 = dataclasses.replace(CFG, n_layers=COPY_LAYERS)
    card = init_random(cfg2, seed=1, quant="q4_j", device=DEV)
    host = init_random(cfg2, seed=1, quant="q4_j", device=DEV).to("cpu")
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(3, V, (300,), generator=gen).tolist()
    n_new = 8
    with fusion(UNFUSED):
        g_card = greedy_generate(card, cfg2, ids, max_new_tokens=n_new + 1,
                                 stop_at_eos=False)[len(ids):]
    g_host = greedy_generate(host, cfg2, ids, max_new_tokens=n_new + 1,
                             stop_at_eos=False)[len(ids):]
    # bf16 activations: last-bit differences (split-K order in K1 and K5,
    # where K3 rounds P, the card's rsqrt/exp) move int8 activation codes
    # of the next K2 product by a step, and layers amplify that; the
    # tiny model shows 1.8e-2 between the JAX package and the port on the
    # CPU
    rel_tol = 5e-2
    feed = g_card[:n_new]
    host_cache = init_cache(cfg2, 1, len(ids) + N_STEPS, device="cpu")
    host_rows = _step_rows(host, cfg2, ids, feed, cache=host_cache)
    with fusion(UNFUSED):
        card_rows = _step_rows(card, cfg2, ids, feed)
    worst, provable, sames = _compare_rows(card_rows, host_rows, rel_tol)
    for step in range(n_new):
        if all(sames[:step + 1]) and g_host[step] != g_card[step]:
            raise AssertionError(f"free-running greedy ids differ at step "
                                 f"{step} while every argmax so far agreed")
    log(f"card unfused vs plain ({cfg2.n_layers} layer(s), full width, "
        f"300-token prompt): "
        f"logits max err {worst:.3g}·max|logit| (tol {rel_tol}); greedy card "
        f"{g_card}, plain {g_host}; argmax provably comparable at "
        f"{provable} of {n_new + 1} steps, equal at all of them")
    if provable < 3:
        raise AssertionError("too few steps with a margin wide enough to "
                             "compare the argmax")
    fused_worst = _fused_card_vs_plain(card, cfg2, ids, feed, g_host,
                                       host_rows, rel_tol)
    fused_worst.update(_fused_steps_card_vs_plain(card, host, len(ids),
                                                  host_cache))
    sched_worst = _sched_card_vs_plain(card, host, cfg2, rel_tol)
    fused_worst.update(_sched_beyond_greedy_card_vs_plain(card, host, cfg2,
                                                          ids, rel_tol))
    fused_worst.update(_sampling_card_vs_plain(card, host, cfg2, ids,
                                               rel_tol))
    del card, host
    # the formats' copies are cut to one layer, which runs every kernel of
    # each format, to keep the script inside its time limit
    return worst, sched_worst, fused_worst, _formats_card_vs_plain(cfg2)


@contextlib.contextmanager
def _ranked(module, calls, forced=None):
    """Record each ``rank_beams`` call made through ``module`` (the
    Scheduler's or ``runtime.beam``'s): its logits rows, scores, alive and
    stop masks and the parents, ids and scores it chose, on the CPU. With
    ``forced`` (another run's records), call k returns that run's k-th
    choice in place of its own, so this run follows the other's beams
    (teacher forcing) while its own choice is recorded beside them."""
    orig = module.rank_beams

    def rec(logits, scores, alive, eos_mask, W):
        out = orig(logits, scores, alive, eos_mask, W)
        calls.append(dict(logits=logits.double().cpu(),
                          scores=scores.double().cpu(), alive=alive.cpu(),
                          eos=eos_mask.double().cpu(), parents=out[0].cpu(),
                          ids=out[1].cpu(), new=out[2].cpu()))
        if forced is None:
            return out
        if len(calls) > len(forced):
            raise AssertionError(f"the forced run ranked {len(calls)} "
                                 f"expansions, the run it follows "
                                 f"{len(forced)}")
        c, dev = forced[len(calls) - 1], logits.device
        return c["parents"].to(dev), c["ids"].to(dev), c["new"].to(dev)

    module.rank_beams = rec
    try:
        yield
    finally:
        module.rank_beams = orig


def _totals(c):
    logp = torch.log_softmax(c["logits"], -1) + c["eos"][None]
    logp = torch.where(c["alive"][:, None], logp, torch.full_like(logp,
                                                                  -1e30))
    return (c["scores"][:, None] + logp).reshape(-1)


def _rows_apart(got, ref):
    """Per expansion of two runs of one beam group (``_ranked`` records),
    the largest difference of their live rows' logits over the
    reference's largest |logit|."""
    out = []
    for a, b in zip(got, ref):
        live = a["alive"] & b["alive"]
        la, lb = a["logits"][live], b["logits"][live]
        out.append((la - lb).abs().max().item() / lb.abs().max().item())
    return out


def _beams_held(got, ref, W, rel_tol, what):
    """A beam group's expansions (``got``) against a reference run forced
    to follow its beams (``ref``, :func:`_ranked` with ``forced=got``): at
    every expansion the live rows' logits within rel_tol·max|logit| of
    the reference's (a row reordered wrong, or logits left from another
    step, sees another history), and the run's choice the joint top W of
    its own rows' totals (score plus log-prob, f64, up to a 1e-4 tie). An
    expansion is proven where the reference's top W+1 totals lie each
    more than twice the largest total difference apart: there the
    reference's own choice must be the run's. Returns (worst relative
    difference, expansions proven)."""
    if len(got) != len(ref):
        raise AssertionError(f"{what}: {len(got)} expansions, the forced "
                             f"reference {len(ref)}")
    apart = _rows_apart(got, ref)
    proven = 0
    for k, (a, b) in enumerate(zip(got, ref)):
        if not apart[k] <= rel_tol:
            raise AssertionError(f"{what}: expansion {k}: logits apart by "
                                 f"{apart[k]:.4g}·max|logit| (tol "
                                 f"{rel_tol})")
        ta, tb = _totals(a), _totals(b)
        chosen = a["parents"].long() * a["logits"].shape[-1] + a["ids"].long()
        rest = torch.ones_like(ta, dtype=torch.bool)
        rest[chosen] = False
        tie = 1e-4 * max(1.0, ta.max().abs().item())
        if ta[chosen].min() < ta[rest].max() - tie:
            raise AssertionError(f"{what}: expansion {k} chose beyond the "
                                 f"top {W} of its own rows")
        live = (ta > -1e29) & (tb > -1e29)
        delta = (ta - tb)[live].abs().max().item()
        top = tb.topk(W + 1).values
        top = top[top > -1e29]
        sure = bool(((top[:-1] - top[1:]) > 2 * delta).all())
        if sure and not (torch.equal(a["parents"], b["parents"])
                         and torch.equal(a["ids"], b["ids"])):
            raise AssertionError(f"{what}: expansion {k}: the reference "
                                 f"chose otherwise despite the margins "
                                 f"(delta {delta})")
        proven += sure
    return max(apart), proven


def _beams_card_vs_plain(card, host, cfg2, ids, rel_tol):
    """Beam search (4 beams, 8 new tokens, a 24-token prompt) on the card
    against the CPU's plain path: rank by rank, equal ids and scores within
    2·rel_tol·max|logit| (a score is a mean of log-probs, each within twice
    a logit's difference), except at a near tie of the plain run's scores
    (within the same bound), which a rounding may order either way."""
    prompt = ids[:24]
    hyps = run_path("card_vs_plain_beams", ("qmm4_npack", "qmm_general",
                                            "flash_prefill", "flash_decode"),
                    lambda: beam_search(card, cfg2, prompt, beam_size=4,
                                        max_new_tokens=8))
    ref = beam_search(host, cfg2, prompt, beam_size=4, max_new_tokens=8)
    scale = _step_rows(host, cfg2, prompt, [])[0].abs().max().item()
    tol = 2 * rel_tol * scale
    equal, worst = 0, 0.0
    for i, (a, b) in enumerate(zip(hyps, ref)):
        if a.ids != b.ids:
            gaps = [abs(b.score - r.score) for r in ref if r is not b]
            if not gaps or min(gaps) >= tol:
                raise AssertionError(f"beam {i}: card {a.ids} != plain "
                                     f"{b.ids} with no near tie")
            continue
        worst = max(worst, abs(a.score - b.score))
        if abs(a.score - b.score) > tol:
            raise AssertionError(f"beam {i}: score {a.score} against "
                                 f"{b.score} (tol {tol})")
        equal += 1
    log(f"beam search card vs plain ({cfg2.n_layers} layer(s)): {equal} of "
        f"{len(ref)} hypotheses equal, scores within {worst:.3g} (tol "
        f"{tol:.3g}); card {[h.ids[len(prompt):] for h in hyps]}, plain "
        f"{[h.ids[len(prompt):] for h in ref]}")
    if equal < 1:
        raise AssertionError("beam search: no hypothesis held equal")
    return worst


def _shift_card_vs_plain(host, cfg2, ids):
    """The first StreamingLLM shift of a full 64-position cache (4 sinks, 30
    dropped), the CPU's prefilled cache copied to the card: shifted on both
    sides, the values and their scales equal, bf16 keys within one bf16
    step (at most 2^-7 relative: the rotation's f32 cos/sin may round an
    ulp apart), int8 key codes within one step and their scales within one
    bf16 step."""
    worst = {}
    for kvdt in (torch.bfloat16, torch.int8):
        hc = init_cache(cfg2, 1, 64, kvdt, device="cpu")
        prefill_step(host, torch.tensor([ids[:64]]),
                     torch.zeros(1, dtype=torch.long), hc)
        cc = type(hc)(*(None if t is None else t.to(DEV)
                        for t in (hc.k, hc.v, hc.k_scale, hc.v_scale)))
        inv = host.rope_inv_freqs
        ST.shift_cache_impl(hc, inv, cfg2, 4, 30)
        ST.shift_cache_impl(cc, inv.to(DEV), cfg2, 4, 30)
        for name in ("v", "v_scale"):
            a, b = getattr(cc, name), getattr(hc, name)
            if b is not None and not torch.equal(a.cpu(), b):
                raise AssertionError(f"shift {kvdt}: {name} differs")
        k, rk = cc.k.cpu().float(), hc.k.float()
        if kvdt == torch.int8:
            ks, rks = cc.k_scale.cpu().float(), hc.k_scale.float()
            ok = (k - rk).abs().max() <= 1 and bool(
                ((ks - rks).abs() <= 2 ** -7 * rks.abs()).all())
        else:
            ok = bool(((k - rk).abs() <= 2 ** -7 * rk.abs() + 1e-6).all())
        worst[str(kvdt)] = (k - rk).abs().max().item()
        if not ok:
            raise AssertionError(f"shift {kvdt}: keys part by "
                                 f"{worst[str(kvdt)]}")
    log(f"StreamingLLM shift card vs plain (64 positions, 4 sinks, 30 "
        f"dropped): values equal, keys within {worst}")
    return worst


def _lm_head_32001_card_vs_plain(rel_tol):
    """C7: a one-layer copy with a quantized lm_head over a vocab of 32001
    (an untied fine-tune's), which neither K1 nor K5 takes (both refuse it
    on the card, checked): its products take the counted ``qmm_plain``
    route, the prefill's last row and every decode step, held against the
    CPU's plain path as phase 5's copy is."""
    cfg3 = dataclasses.replace(CFG, n_layers=COPY_LAYERS, vocab_size=32001)
    card = init_random(cfg3, seed=4, quant="q4_j", device=DEV)
    host = init_random(cfg3, seed=4, quant="q4_j", device=DEV).to("cpu")
    qt = card.lm_head.qt
    if Q.route(1, D, 32001, qt) != "plain":
        raise AssertionError("the 32001-wide lm_head does not route plain")
    x = torch.randn((1, D), device=DEV).bfloat16()
    for what, fn in (("K1", lambda: Q.qmm_native(
            x, qt.planes[0], qt.scales, None, qt.group_size, 4,
            torch.float32)), ("K5", lambda: Q.qmm_general(
                x, qt, torch.float32))):
        try:
            fn()
        except ValueError:
            continue
        raise AssertionError(f"{what} took N = 32001")
    g = torch.Generator().manual_seed(41)
    ids = torch.randint(3, 32001, (24,), generator=g).tolist()
    feed = torch.randint(3, 32001, (4,), generator=g).tolist()
    rows = run_path("card_lm_head_32001", ("qmm_plain", "qmm4_npack",
                                           "flash_prefill", "flash_decode"),
                    lambda: _step_rows(card, cfg3, ids, feed))
    plain = LAUNCHES["card_lm_head_32001"]["qmm_plain"]
    worst, provable, _ = _compare_rows(rows, _step_rows(host, cfg3, ids,
                                                        feed),
                                       rel_tol, "lm_head 32001 card vs plain")
    log(f"C7: lm_head over 32001 through qmm_plain ({plain} products; K1 and "
        f"K5 refuse it): logits max err {worst:.3g}·max|logit| (tol "
        f"{rel_tol}), argmax provably comparable at {provable} of "
        f"{len(feed) + 1} steps, equal at all of them")
    del card, host
    return worst


def _sampling_card_vs_plain(card, host, cfg2, ids, rel_tol):
    """Phase 5's checks of the sampling slice on its one-layer copy."""
    return {"beams_card_vs_plain_score_err": _beams_card_vs_plain(
                card, host, cfg2, ids, rel_tol),
            "shift_card_vs_plain_k_err": _shift_card_vs_plain(host, cfg2,
                                                              ids),
            "lm_head_32001_card_vs_plain_rel_err":
                _lm_head_32001_card_vs_plain(rel_tol)}


def _fused_card_vs_plain(card, cfg2, ids, feed, g_host, host_rows, rel_tol):
    """Phase 5's copy on the card with the fused path on (and with GLU),
    held against the unfused plain path's rows already computed on the
    CPU: there the fused path without GLU is the unfused chain bit for
    bit, so the CPU reference stands for it; with GLU the activation is
    rounded once where the unfused graph rounds twice, one bf16 step of
    h (2^-8 relative) at some elements, well inside the same 5e-2.
    Greedy ids on the card equal the plain path's up to the first step
    where an argmax is unproven or the runs part."""
    res = {}
    for mode in (FUSED, FUSED_GLU):
        with fusion(mode):
            rows = run_path(f"card_vs_plain_{mode[0]}",
                            FUSED_DECODE[mode[0]],
                            lambda: _step_rows(card, cfg2, ids, feed))
            g_fused = greedy_generate(card, cfg2, ids,
                                      max_new_tokens=len(feed) + 1,
                                      stop_at_eos=False)[len(ids):]
        worst, provable, sames = _compare_rows(
            rows, host_rows, rel_tol, f"card {mode[0]} vs plain")
        for step in range(len(feed)):
            if all(sames[:step + 1]) and g_host[step] != g_fused[step]:
                raise AssertionError(f"{mode[0]}: greedy ids differ at step "
                                     f"{step} while every argmax so far "
                                     "agreed")
        log(f"card {mode[0]} vs plain ({cfg2.n_layers} layer(s)): logits "
            f"max err "
            f"{worst:.3g}·max|logit| (tol {rel_tol}); greedy card {g_fused}, "
            f"plain {g_host}; argmax provably comparable at {provable} of "
            f"{len(feed) + 1} steps, equal at all of them")
        if provable < 3:
            raise AssertionError(f"{mode[0]}: too few steps with a margin "
                                 "wide enough to compare the argmax")
        res[f"card_vs_plain_{mode[0]}_rel_err"] = worst
    return res


# phase 5's fused decode steps from one cache, card against the CPU's plain
# path under the same switches. The card's steps part from the CPU's by
# 8.5e-3 (fused) and 9.0e-3·max|logit| (fused + GLU) on this copy (H100,
# first run), K4's and K1's last bits against the plain versions', with or
# without GLU: 2e-2, under the 5e-2 of the teacher-forced run with its
# prefill. GLU's single rounding of act(g)·u moves one layer's logits by
# 4.6e-3·max|logit| on the CPU, under that noise, so the card's own GLU
# shift (GLU on against off, on the card) is what is held to the CPU's:
# within a factor of GLU_SHIFT of it. A wrong prologue moves the logits by
# far more; a GLU switch that changed nothing would move them by 0.
STEPS_TOL = 2e-2
GLU_SHIFT = 2.0
N_STEPS = 16
# NTPU_FUSED_DECODE=interpret with GLU: the fused path's plain version on
# the CPU
INTERPRET_GLU = ("interpret_glu", "interpret", "1")


def _rel(rows, refs):
    """The largest difference of two lists of logits rows, relative to
    each reference row's max|logit|."""
    return max(((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(rows, refs))


def _fused_steps_card_vs_plain(card, host, n, host_cache):
    """N_STEPS teacher-forced decode steps (seeded ids) from one prompt
    cache: the CPU's prefilled ``host_cache`` copied to the card, so the
    steps' inputs agree and only the steps' own roundings part the two
    sides. Fused without GLU on the card against the CPU's unfused steps
    (on the CPU the fused path computes the same values), fused with GLU
    against the CPU under ``NTPU_FUSED_DECODE=interpret`` and
    ``NTPU_FUSE_GLU=1`` (the same single rounding), both within STEPS_TOL,
    the argmax proven equal at 3 steps or more. Then the GLU shift, GLU on
    against off, on the card against the CPU's."""
    gen = torch.Generator().manual_seed(3)
    feed = torch.randint(3, V, (N_STEPS,), generator=gen).tolist()
    host_rows = {}
    for mode in (UNFUSED, INTERPRET_GLU):
        with fusion(mode):
            host_rows[mode[0]] = _decode_rows(host, n, feed, host_cache)
    card_rows, res = {}, {}
    for mode, ref in ((FUSED, "unfused"), (FUSED_GLU, "interpret_glu")):
        cache = type(host_cache)(*(None if t is None else t.to(DEV) for t in (
            host_cache.k, host_cache.v, host_cache.k_scale,
            host_cache.v_scale)))
        with fusion(mode):
            rows = card_rows[mode[0]] = run_path(
                f"card_vs_plain_steps_{mode[0]}", FUSED_DECODE[mode[0]],
                lambda: _decode_rows(card, n, feed, cache))
        worst, provable, _ = _compare_rows(
            rows, host_rows[ref], STEPS_TOL, f"card {mode[0]} steps vs plain")
        log(f"card {mode[0]} decode steps vs plain {ref}, one prompt cache: "
            f"logits max err {worst:.3g}·max|logit| (tol {STEPS_TOL}); "
            f"argmax provably comparable at {provable} of {N_STEPS} steps, "
            "equal at all of them")
        if provable < 3:
            raise AssertionError(f"{mode[0]} steps: too few steps with a "
                                 "margin wide enough to compare the argmax")
        res[f"card_vs_plain_steps_{mode[0]}_rel_err"] = worst
    shift_card = _rel(card_rows["fused_glu"], card_rows["fused"])
    shift_host = _rel(host_rows["interpret_glu"], host_rows["unfused"])
    log(f"GLU on against off, decode steps: card {shift_card:.3g}, CPU "
        f"{shift_host:.3g}·max|logit| (held within {GLU_SHIFT}x)")
    if not shift_host / GLU_SHIFT <= shift_card <= shift_host * GLU_SHIFT:
        raise AssertionError(f"the card's GLU shift {shift_card} is not "
                             f"within {GLU_SHIFT}x of the CPU's {shift_host}")
    res.update(glu_shift_card_rel=shift_card, glu_shift_plain_rel=shift_host)
    return res


# asymmetric int2 and int5 (uint8 zero-points, group 32), what
# ``quant_config_from_args("int2" | "int5", alg="asym")`` gives; no preset
# holds them, and K1 has an entry point for each
QUANTS = {
    "int2_asym": QuantConfig(bits=2, group_size=32, sym=False, act_bits=8),
    "int5_asym": QuantConfig(bits=5, group_size=32, sym=False, act_bits=8),
    "int6_g128_a8": quant_config_from_args("int6", group_size=128),
}

# the formats with no full-width path, and the kernels a card run of each
# must launch: a 24-token prompt prefills through K5's tiles (M=24 > 16),
# its one-row lm_head and the decode steps through K1's branch for codes
# at rest, through K5's gemv for the stored layouts
_K5_BOTH = ("qmm_general+tc", "qmm_general+gemv")
PLAIN_FORMATS = {
    "fp4": _K5_BOTH, "fp8": _K5_BOTH, "fp8_e5m2": _K5_BOTH, "int1": _K5_BOTH,
    "int2": ("qmm_general+tc", "qmm2_npack"),
    "int2_asym": ("qmm_general+tc", "qmm2_npack_asym"),
    "int3": ("qmm_general+tc", "qmm4_npack"),
    "int5": ("qmm_general+tc", "qmm8_native"),
    "int5_asym": ("qmm_general+tc", "qmm8_native_asym"),
    "q8_0": ("qmm_general+tc", "qmm8_native"),
    "int8": ("qmm_general+tc", "qmm8_native"),
}


def _formats_card_vs_plain(cfg2, rel_tol=2e-2):
    """Each format of PLAIN_FORMATS: a copy at full width (``cfg2``: one
    layer since the script's time limit pressed, two before) runs
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


def _sched_card_vs_plain(card, host, cfg2, rel_tol, kv_dtype=torch.int8):
    """The copy through the Scheduler (paged KV, int8 unless
    ``kv_dtype`` says otherwise, batch 4, 6 requests) on the card, decode
    step eager so each step's logits can be read, and on the CPU's plain
    path: per request, logits within the tolerance and greedy ids equal at
    every token whose plain top-2 margin exceeds twice the logit
    difference, up to the first token where the two sides' ids part (past
    it their inputs differ)."""
    gen = torch.Generator().manual_seed(5)
    lens = torch.randint(20, 64, (6,), generator=gen).tolist()
    prompts = [torch.randint(3, V, (n,), generator=gen).tolist()
               for n in lens]
    n_new = 3           # the plain path's CPU time sets the size
    done, recs = [], []
    for model in (card, host):
        rec = _LogitsRecorder(model)
        sched = Scheduler(model, cfg2, max_batch=4, max_len=256,
                          kv_mode="paged", page_size=64, kv_dtype=kv_dtype,
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
    log(f"{cfg2.arch} scheduler card vs plain ({cfg2.n_layers} layer(s), "
        f"paged "
        f"{'int8' if kv_dtype == torch.int8 else 'bf16'}, batch 4, "
        f"window {cfg2.sliding_window}, prompts "
        f"{lens}): logits max err {worst:.3g}·max|logit| (tol {rel_tol}); "
        f"ids card {[done[0][i] for i in range(6)]}, plain "
        f"{[done[1][i] for i in range(6)]}; provably comparable at "
        f"{provable} tokens, equal at all of them")
    if provable < 3:
        raise AssertionError("too few scheduler steps with a margin wide "
                             "enough to compare the argmax")
    return worst


GREEDY_NP = SamplingParams(greedy=True, repeat_penalty=1.0)


def _sched_beams_card_vs_plain(card, host, cfg2, ids, rel_tol):
    """A beam group (3 beams, 8 new tokens, a 24-token prompt) beside a
    greedy request through the Scheduler, slots bf16 and then paged int8:
    on the card (its decode steps graphed, a path each), then on the CPU's
    plain path forced to follow the card's beams. Every expansion's logits
    rows are held to the plain ones and the choices proven where the
    margins allow (:func:`_beams_held`); the hypotheses equal."""
    prompt = ids[:24]
    res, proven = {}, 0
    for mode, kv, attn in (("slots", torch.bfloat16, ("flash_prefill",
                                                       "flash_decode")),
                           ("paged", torch.int8, ("flash_prefill_i8",
                                                  "paged_decode_i8"))):
        calls, hyps = [], []
        for model in (card, host):
            def run():
                sched = Scheduler(model, cfg2, max_batch=4, max_len=64,
                                  kv_mode=mode, page_size=16, kv_dtype=kv,
                                  sampling=GREEDY_NP)
                sched.add_request("beam", prompt, max_new_tokens=8,
                                  num_beams=3)
                sched.add_request("greedy", ids[30:50], max_new_tokens=8)
                return {q.request_id: q for q in sched.run_to_completion()}
            calls.append([])
            forced = None if model is card else calls[0]
            with _ranked(SCHED, calls[-1], forced):
                done = run() if model is host else run_path(
                    f"card_vs_plain_sched_beams_{mode}",
                    ("qmm4_npack", "qmm_general") + attn, run)
            _check_served(done["greedy"].output_ids, 8, "greedy beside "
                          "a beam group", cfg2)
            hyps.append(done["beam"].hypotheses)
        worst, n = _beams_held(*calls, 3, rel_tol,
                               f"scheduler beams {mode} card vs plain")
        if [h for h, _ in hyps[0]] != [h for h, _ in hyps[1]]:
            raise AssertionError(f"scheduler beams {mode}: card hypotheses "
                                 f"{hyps[0]} != forced plain {hyps[1]}")
        log(f"scheduler beam group card vs plain ({mode}, {kv}): the plain "
            f"run forced to the card's beams; logits within {worst:.3g}·"
            f"max|logit| (tol {rel_tol}) at all {len(calls[0])} expansions, "
            f"{n} proven by the margins; hypotheses {hyps[0]}")
        res[f"sched_beams_{mode}_rel_err"] = worst
        res[f"sched_beams_{mode}_proven"] = n
        proven += n
    if proven < 2:
        raise AssertionError(f"scheduler beams card vs plain: {proven} "
                             "expansions proven by the margins")
    return res


def _held_shift(worst):
    """``shift_cache_impl`` wrapped for the Scheduler: the slot row as it
    was copied to the CPU before the card shifts it, then the card's
    shifted row held to the plain shift of that copy (values and scales
    equal, bf16 keys within one bf16 step); ``worst`` collects the keys'
    largest difference."""
    orig = SCHED.shift_cache_impl

    def shift(rows, inv, cfg, n_keep, n_discard):
        before = type(rows)(*(None if t is None else t.cpu()
                              for t in (rows.k, rows.v, rows.k_scale,
                                        rows.v_scale)))
        orig(rows, inv, cfg, n_keep, n_discard)
        orig(before, None if inv is None else inv.cpu(), cfg, n_keep,
             n_discard)
        if not torch.equal(rows.v.cpu(), before.v):
            raise AssertionError("scheduler shift: values differ")
        k, rk = rows.k.cpu().float(), before.k.float()
        worst.append((k - rk).abs().max().item())
        if not bool(((k - rk).abs() <= 2 ** -7 * rk.abs() + 1e-6).all()):
            raise AssertionError(f"scheduler shift: keys part by "
                                 f"{worst[-1]}")
        return rows
    return shift


def _sched_stream_card_vs_plain(card, host, cfg2, ids, rel_tol):
    """StreamingLLM slots through the Scheduler (bf16 KV, 64 positions, 4
    sinks, 30 dropped, prompts of 60 and 61 tokens, 6 new each: each slot
    shifts once) on the card, its decode steps graphed, and on the CPU's
    plain path, each step's logits rows read from the step's output
    (:class:`_SlotRows`): logits within rel_tol, ids equal where the plain
    margin proves them, up to the first parting; each card shift against
    the plain shift of the same row."""
    prompts = [ids[100:160], ids[160:221]]
    worst_k, recs, done = [], [], []
    for model in (card, host):
        sched = Scheduler(model, cfg2, max_batch=2, max_len=64,
                          streaming=True, n_keep=4, n_discard=30,
                          sampling=GREEDY_NP)
        rec = _SlotRows(sched, {0, 1})
        for i, p in enumerate(prompts):
            sched.add_request(i, p, max_new_tokens=6)
        orig = SCHED.shift_cache_impl
        if model is card:
            SCHED.shift_cache_impl = _held_shift(worst_k)
        try:
            run = lambda: {q.request_id: q.output_ids
                           for q in sched.run_to_completion()}
            done.append(run() if model is host else run_path(
                "card_vs_plain_sched_stream", ("qmm4_npack", "qmm_general",
                                               "flash_prefill",
                                               "flash_decode"), run))
        finally:
            SCHED.shift_cache_impl = orig
        recs.append(rec.rows)
    if len(worst_k) < 2:
        raise AssertionError(f"scheduler streaming: {len(worst_k)} shifts "
                             "on the card")
    proven, worst = 0, 0.0
    for i in range(len(prompts)):
        for t in range(6):
            a, b = recs[0][(i, t)], recs[1][(i, t)]
            err = (a - b).abs().max().item()
            worst = max(worst, err / b.abs().max().item())
            if not err <= rel_tol * b.abs().max().item():
                raise AssertionError(f"scheduler streaming logits, request "
                                     f"{i} token {t}: max err {err}")
            top2 = b.topk(2).values
            sure = (top2[0] - top2[1]).item() > 2 * err
            if done[0][i][t] != done[1][i][t]:
                if sure:
                    raise AssertionError(f"scheduler streaming ids differ "
                                         f"at request {i} token {t} despite "
                                         "the margin")
                break
            proven += sure
    log(f"scheduler streaming card vs plain (64 positions, 2 slots, one "
        f"shift each): logits max err {worst:.3g}·max|logit| (tol "
        f"{rel_tol}); card shifts' keys within {max(worst_k):.3g} of the "
        f"plain shift; ids card {done[0]}, plain {done[1]}; proven at "
        f"{proven} tokens")
    if proven < 3:
        raise AssertionError("scheduler streaming: too few proven tokens")
    return {"sched_stream_card_vs_plain_rel_err": worst,
            "sched_stream_shift_k_err": max(worst_k)}


def _sched_block_card(card, cfg2, ids):
    """Decode blocks of 4 on the card (paged int8, batch 4, 6 requests of
    20-60 tokens, 12 new each, the default repetition penalty): ids equal
    the single steps' exactly; the single steps are held to the CPU by
    :func:`_sched_card_vs_plain`."""
    prompts = [ids[10 * n:10 * n + 20 + 8 * n] for n in range(6)]
    out = []
    for block in (1, 4):
        sched = Scheduler(card, cfg2, max_batch=4, max_len=256,
                          kv_mode="paged", page_size=64, kv_dtype=torch.int8,
                          decode_block=block)
        for i, p in enumerate(prompts):
            sched.add_request(i, p, max_new_tokens=12)
        out.append(run_path(f"card_sched_block{block}",
                            ("qmm4_npack", "paged_decode_i8"),
                            lambda: {q.request_id: q.output_ids
                                     for q in sched.run_to_completion()}))
        if block > 1 and not sched._blocks:
            raise AssertionError("no decode block ran")
    if out[0] != out[1]:
        raise AssertionError(f"decode blocks {out[1]} != single steps "
                             f"{out[0]}")
    log(f"scheduler decode blocks of 4 on the card = single steps: ids "
        f"equal over 6 requests, 12 new each")


def _sched_beyond_greedy_card_vs_plain(card, host, cfg2, ids, rel_tol):
    """Phase 5's checks of serving beyond greedy on its one-layer copy."""
    res = _sched_beams_card_vs_plain(card, host, cfg2, ids, rel_tol)
    res.update(_sched_stream_card_vs_plain(card, host, cfg2, ids, rel_tol))
    _sched_block_card(card, cfg2, ids)
    return res


# ---------------------------------------------------------------------------
# phase 6: the server at full width
# ---------------------------------------------------------------------------

# prompt tails in the 32/64/128 buckets prefill through K5
SERVE_PAGED_I8 = ("qmm4_npack", "qmm_a8", "qmm_general", "flash_prefill_i8",
                  "paged_decode_i8")


def _serve(srv, prompts, n_new, cfg=CFG, timeout=300.0, queries=None):
    """Issue every prompt at once (or ``queries``, ids 0..n-1, as they
    are), wait for Empty() under a timeout that raises; return (finished
    sequences by id, issue time, wall seconds)."""
    queries = queries or [Query(i, p, n_new) for i, p in enumerate(prompts)]
    t0 = time.time()
    srv.issueQuery(queries)
    while not srv.Empty():
        if time.time() - t0 > timeout:
            raise TimeoutError(f"server did not answer {len(queries)} "
                               f"queries in {timeout} s")
        time.sleep(0.002)
    wall = time.time() - t0
    with srv._lock:
        done, srv.finished = {q.request_id: q for q in srv.finished}, []
    if sorted(done) != list(range(len(queries))):
        raise AssertionError(f"answered {sorted(done)} of "
                             f"{len(queries)} queries")
    for i, q in done.items():
        out = q.output_ids
        stopped = out and out[-1] in cfg.eos_token_ids and len(out) < n_new
        if not (len(out) == n_new or stopped) \
                or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"query {i}: bad ids {out}")
    return done, t0, wall


def _graph_vs_eager(params, mode=None):
    """The same 8 requests through two paged int8 Schedulers, one replaying
    the decode-step CUDA graph, one running the step eagerly: equal ids and
    equal pool bytes (the trash page aside). With ``mode`` (the fusion
    switches both run under), the graph's K1 launches are that mode's: all
    of the batch-8 step's 225 through the fused entry points."""
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
        if graph and mode is not None:
            for g in sched._graphs.values():
                check_step_launches(g.launches, mode, "server decode step")
    (ids_g, pool_g), (ids_e, pool_e) = runs
    if ids_g != ids_e:
        raise AssertionError(f"graphed server steps {ids_g} != eager {ids_e}")
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(pool_g, name), getattr(pool_e, name)
        if not torch.equal(a[:, :-1], b[:, :-1]):
            raise AssertionError(f"graphed server steps wrote another {name} "
                                 "pool than the eager steps")
    log(f"server decode step{'' if mode is None else ' ' + mode[0]} (CUDA "
        f"graph) = eager steps: ids and pool bytes equal over 8 requests "
        f"(prompts {lens}), 10 new tokens each")
    del runs, pool_g, pool_e
    torch.cuda.empty_cache()


def _server_timed(params, cfg, name, required, prompts):
    """The batch-8 ``ModelServer`` over a paged int8 pool (page 256,
    max_len 2048) answers ``prompts`` (32 new tokens each, issued at once)
    after a warm-up query that captures its decode graph, as the path
    ``name`` with launch counts: aggregate tok/s, the decode iteration's
    median ms at 8 running slots (host clock), TTFT from issue (median,
    max; it includes the wait for a slot)."""
    srv = ModelServer(params, cfg, max_batch=8, max_len=S_CACHE,
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
        _serve(srv, [prompts[0][:600]], 4, cfg)
        step_ms.clear()
        done, t0, wall = run_path(name, required,
                                  lambda: _serve(srv, prompts, 32, cfg))
    finally:
        srv.stop()
    n_tok = sum(len(q.output_ids) for q in done.values())
    full = [ms for n, ms in step_ms if n == 8]
    ttft = [(q.first_token_time - t0) * 1e3 for q in done.values()]
    if not full:
        raise AssertionError("no decode iteration ran with 8 slots")
    res = dict(tok_s=n_tok / wall,
               decode_iter_ms_8slots=statistics.median(full),
               ttft_median_ms=statistics.median(ttft), ttft_max_ms=max(ttft),
               wall_s=wall)
    log(f"{name} (batch 8, page 256, {len(prompts)} queries, prompts "
        f"{[len(p) for p in prompts]}, 32 new each): {n_tok} tokens in "
        f"{wall:.2f} s = {res['tok_s']:.1f} tok/s aggregate; decode "
        f"iteration with 8 running slots median "
        f"{res['decode_iter_ms_8slots']:.3f} ms over {len(full)}; TTFT from "
        f"issue median {res['ttft_median_ms']:.1f} ms, max "
        f"{res['ttft_max_ms']:.1f} ms")
    for i in range(3):
        log(f"  query {i} ({len(prompts[i])} tokens): {done[i].output_ids}")
    del srv, sched
    torch.cuda.empty_cache()
    return res


def _server_short(params, cfg, runs):
    """Short server runs, each a path with launch counts: (name, server
    kwargs, kernels it must launch, prompts, new tokens)."""
    for name, kw, required, queries, n_new in runs:
        srv = ModelServer(params, cfg, max_batch=8, max_len=S_CACHE,
                          memory_dtype="auto", **kw)
        try:
            done, _, wall = run_path(name, required,
                                     lambda: _serve(srv, queries, n_new, cfg))
        finally:
            srv.stop()
        log(f"{name}: {len(queries)} queries, {n_new} new each, in "
            f"{wall:.2f} s; query 0: {done[0].output_ids}")
        del srv
        torch.cuda.empty_cache()


def _server_prompts():
    gen = torch.Generator().manual_seed(6)
    lens = torch.randint(32, 1501, (12,), generator=gen).tolist()
    return [torch.randint(3, V, (n,), generator=gen).tolist() for n in lens]


def phase_server(params):
    _graph_vs_eager(params)
    for mode in (FUSED, FUSED_GLU):
        with fusion(mode):
            run_path(f"server_{mode[0]}", FUSED_DECODE[mode[0]][:-1]
                     + ("paged_decode_i8",),
                     lambda: _graph_vs_eager(params, mode))
    prompts = _server_prompts()
    res = {f"server_{k}": v for k, v in _server_timed(
        params, CFG, "server_paged_int8", SERVE_PAGED_I8, prompts).items()}
    _server_short(params, CFG, (
        ("server_slots_bf16", dict(kv_mode="slots"),
         ("qmm4_npack", "qmm_a8", "flash_prefill", "flash_decode"),
         [p[:n] for p, n in zip(prompts, (64, 300, 700, 1200))], 16),
        ("server_paged_bf16", dict(kv_mode="paged", page_size=256),
         ("qmm4_npack", "flash_prefill", "paged_decode"),
         [p[:n] for p, n in zip(prompts, (90, 200))], 8)))
    return res


# ---------------------------------------------------------------------------
# phase 6c: serving beyond greedy on the 7B
# ---------------------------------------------------------------------------

MIROSTAT = SamplingParams(mirostat=2)
MIX_KINDS = ["greedy"] * 6 + ["sampled"] * 2 + ["mirostat", "beam"] \
    + ["greedy"] * 2
STREAM_LEN, STREAM_NEW = 512, 600
# the server's logits rows against a batch-1 or beam_search computation of
# the same tokens on the card: other kernels (K4 against K6, K1 at another
# M), whose last-bit differences 32 layers of random weights amplify to
# 4-7% of max|logit| in one step, steady over 600 tokens and both shifts
SERVE_TOL = 1e-1
# the same rows through the same kernels at the same shapes, eager against
# graphed: equal to the bit
SAME_ROUTE_TOL = 0.0


def _mix_queries():
    """Phase 6c's 12 queries in issue order, 32 new tokens each: 6 greedy,
    2 sampled (top-k 40, top-p 0.95, temperature 0.8), 1 mirostat v2, a
    4-beam query on a 128-token prompt, 2 more greedy; the other prompts
    are phase 6's (32-1500 tokens)."""
    prompts = _server_prompts()
    g = torch.Generator().manual_seed(43)
    beam_prompt = torch.randint(3, V, (128,), generator=g).tolist()
    sp = {"sampled": SAMPLED, "mirostat": MIROSTAT}
    return [Query(i, beam_prompt if k == "beam" else prompts[i], 32,
                  sampling=sp.get(k), num_beams=4 if k == "beam" else None)
            for i, k in enumerate(MIX_KINDS)]


def _event_ms(fn, reps=10):
    """The median over ``reps`` calls of the device time between CUDA
    events around one call of ``fn`` (its launches from the host and any
    small host-to-card copy included), after a warm-up call."""
    fn()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    return statistics.median(ts)


def _timed_steps(sched):
    """Wrap a Scheduler's decode step: each call's (running slots, a beam
    group running, host ms) is appended to the returned list."""
    steps, decode_step = [], sched._decode_step

    def timed():
        n = len(sched.running)
        beam = any(q.beam is not None for q in sched.running.values())
        t = time.perf_counter()
        decode_step()
        steps.append((n, beam, (time.perf_counter() - t) * 1e3))

    sched._decode_step = timed
    return steps


@contextlib.contextmanager
def _timed_copies(calls):
    """Time each ``copy_kv`` of the Scheduler (a beam prompt's share,
    then its reorders) on the host's clock around a synchronize; append
    (pages or rows, ms) to ``calls``."""
    orig = SCHED.copy_kv

    def timed(cache, src, dst, n=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        orig(cache, src, dst, n)
        torch.cuda.synchronize()
        calls.append((len(src), (time.perf_counter() - t) * 1e3))

    SCHED.copy_kv = timed
    try:
        yield
    finally:
        SCHED.copy_kv = orig


def _plain_copy(cache, src, dst, n=None):
    """``copy_kv``'s plain version: every source row or page staged to the
    host first, then each destination written from its copy, one at a
    time."""
    for c in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if c is None:
            continue
        if n is not None:
            c = c[:, :, :, :n]
        held = [c[:, i].to("cpu", copy=True) for i in src]
        for i, h in zip(dst, held):
            c[:, i].copy_(h)


def _beam_run(params, beam_q, copy, graphed, forced=None):
    """The beam query alone through a paged int8 Scheduler of the server's
    shape (batch 8, max_len 2048, page 256), its KV copies made by
    ``copy``, its decode steps graphed or eager, following ``forced``'s
    choices if given: (its ``_ranked`` records, its sequence)."""
    sched = Scheduler(params, CFG, max_batch=8, max_len=S_CACHE,
                      kv_mode="paged", page_size=256, kv_dtype=torch.int8)
    if not graphed:
        sched._graphs = None
    orig, calls = SCHED.copy_kv, []
    SCHED.copy_kv = copy
    try:
        with _ranked(SCHED, calls, forced):
            sched.add_request(0, beam_q.token_ids, beam_q.max_new_tokens,
                              num_beams=4)
            done = sched.run_to_completion()
    finally:
        SCHED.copy_kv = orig
    del sched
    torch.cuda.empty_cache()
    return calls, done[0]


def _beam_without_reorders(params, beam_q):
    """The same-route hold against a broken run: the beam query through a
    graphed Scheduler whose reorders are skipped (its prompt's share still
    copied), then the eager plain-copy reference forced to its choices.
    Its rows must part from the reference's. Returns (the largest
    relative difference, reorders skipped)."""
    copies = []

    def share_only(cache, src, dst, n=None):
        if not copies:
            copy_kv(cache, src, dst, n)
        copies.append(len(src))

    calls, _ = _beam_run(params, beam_q, share_only, graphed=True)
    ref, _ = _beam_run(params, beam_q, _plain_copy, graphed=False,
                       forced=calls)
    apart = max(_rows_apart(calls, ref))
    if len(copies) < 2 or not apart > SAME_ROUTE_TOL:
        raise AssertionError(f"a beam run with its {len(copies) - 1} "
                             f"reorders skipped stays within {apart:.4g}·"
                             f"max|logit| of its reference: the hold "
                             "cannot see a wrong reorder")
    return apart, len(copies) - 1


def _mixed_traffic(params):
    """Item 1: phase 6's paged int8 ``ModelServer`` (batch 8, max_len 2048,
    page 256) answers the mix (a path with launch counts); the same 8
    greedy prompts alone through the same server. Greedy ids equal the
    greedy-only run's (a row's numbers do not depend on the other rows).
    The beam query is held, teacher-forced (:func:`_beams_held`), to two
    references that follow its beams: the same Scheduler route with eager
    steps and the plain host-staged copy (:func:`_beam_run`), whose rows
    must equal the server's (SAME_ROUTE_TOL) with 4 expansions or more
    proven by the margins; and ``beam_search`` (a contiguous cache, K4,
    its rows reordered by ``reorder_batch``) within SERVE_TOL, its
    hypotheses equal. :func:`_beam_without_reorders` shows that the first
    hold rejects a run whose reorders are skipped."""
    queries = _mix_queries()
    greedy = [q.id for q, k in zip(queries, MIX_KINDS) if k == "greedy"]
    srv = ModelServer(params, CFG, max_batch=8, max_len=S_CACHE,
                      kv_mode="paged", page_size=256, memory_dtype="int8")
    copies, calls = [], []
    try:
        sched = srv.scheduler
        # warm-up: the mix cut short captures the step graphs it needs
        _serve(srv, None, 8, queries=[
            Query(q.id, q.token_ids[:64], 8, sampling=q.sampling,
                  num_beams=q.num_beams) for q in queries])
        steps = _timed_steps(sched)
        with _timed_copies(copies), _ranked(SCHED, calls):
            done, _, wall = run_path(
                "server_mixed", SERVE_PAGED_I8,
                lambda: _serve(srv, None, 32, queries=queries))
        alone, _, _ = _serve(srv, None, 32, queries=[
            Query(j, queries[i].token_ids, 32) for j, i in enumerate(greedy)])
    finally:
        srv.stop()
    for j, i in enumerate(greedy):
        if done[i].output_ids != alone[j].output_ids:
            raise AssertionError(f"greedy query {i} in the mixed batch "
                                 f"{done[i].output_ids} != alone "
                                 f"{alone[j].output_ids}")
    beam_q = queries[MIX_KINDS.index("beam")]
    T = len(beam_q.token_ids)
    got = done[beam_q.id].hypotheses
    same, seq = _beam_run(params, beam_q, _plain_copy, graphed=False,
                          forced=calls)
    exact, proven = _beams_held(calls, same, 4, SAME_ROUTE_TOL,
                                "server beam query vs its eager plain-copy "
                                "reference")
    if seq.hypotheses != got:
        raise AssertionError(f"server beams {got} != the reference's "
                             f"{seq.hypotheses}")
    if proven < 4:
        raise AssertionError(f"server beam query: {proven} expansions "
                             "proven by the margins")
    ref_calls = []
    with _ranked(BEAM, ref_calls, forced=calls):
        ref = beam_search(params, CFG, beam_q.token_ids, beam_size=4,
                          max_new_tokens=32, kv_dtype=torch.int8)
    worst, _ = _beams_held(calls, ref_calls, 4, SERVE_TOL,
                           "server beam query vs beam_search")
    if [ids for ids, _ in got] != [h.ids[T:] for h in ref]:
        raise AssertionError(f"server beams {got} != beam_search's "
                             f"{[h.ids[T:] for h in ref]} on the same "
                             "choices")
    apart, skipped = _beam_without_reorders(params, beam_q)
    n_tok = sum(len(q.output_ids) for q in done.values())
    with_b = [ms for _, b, ms in steps if b]
    without = [ms for n, b, ms in steps if not b and n == 8]
    if not with_b or not without:
        raise AssertionError("the mix ran no decode iteration with a beam "
                             "group, or none with 8 plain rows")
    share, reorders = copies[0], copies[1:]
    res = dict(mixed_tok_s=n_tok / wall,
               mixed_iter_ms_beam=statistics.median(with_b),
               mixed_iter_ms_8plain=statistics.median(without),
               page_reorder_ms=statistics.median(ms for _, ms in reorders)
               if reorders else None,
               beam_prompt_share_ms=share[1], beam_same_route_rel_err=exact,
               beam_proven=proven, beam_search_rel_err=worst,
               beam_no_reorder_rel_err=apart)
    log(f"server mixed traffic (6+2 greedy, 2 sampled, 1 mirostat v2, 4 "
        f"beams on 128 tokens; 32 new each): {n_tok} tokens in {wall:.2f} s "
        f"= {res['mixed_tok_s']:.1f} tok/s; decode iteration median "
        f"{res['mixed_iter_ms_beam']:.3f} ms with the beam group running "
        f"({len(with_b)}), {res['mixed_iter_ms_8plain']:.3f} ms at 8 plain "
        f"rows ({len(without)}) (host clock); the prompt's pages shared in "
        f"{share[1]:.3f} ms ({share[0]} pages), {len(reorders)} page "
        f"reorders, median {res['page_reorder_ms']} ms, pages "
        f"{sorted({n for n, _ in reorders})} (host clock around a "
        f"synchronize); greedy ids equal the greedy-only run's at all 8 "
        f"queries; the beam query teacher-forced: its logits rows within "
        f"{exact:.3g}·max|logit| of the eager plain-copy Scheduler's (tol "
        f"{SAME_ROUTE_TOL}) at all {len(calls)} expansions, {proven} "
        f"proven by the margins, and within {worst:.3g} of beam_search's "
        f"(tol {SERVE_TOL}), hypotheses equal to both; with its {skipped} "
        f"reorders skipped a run parts from its reference by {apart:.3g}·"
        f"max|logit|; best {got[0][0]}")
    for i in (6, 7, 8):
        log(f"  query {i} ({MIX_KINDS[i]}): {done[i].output_ids}")
    return res, queries


def _mix_seeds(params, queries):
    """Item 2: the mix through the Scheduler itself (no thread), seed 5
    twice and seed 6: one seed gives the same ids, the other seed other
    sampled ids, and the greedy and beam ids do not move."""
    def run(seed):
        sched = Scheduler(params, CFG, max_batch=8, max_len=S_CACHE,
                          kv_mode="paged", page_size=256,
                          kv_dtype=torch.int8, seed=seed)
        for q in queries:
            sched.add_request(q.id, q.token_ids, q.max_new_tokens,
                              sampling=q.sampling,
                              num_beams=q.num_beams or 1)
        out = {q.request_id: q.output_ids for q in sched.run_to_completion()}
        del sched
        torch.cuda.empty_cache()
        return out

    a = run_path("scheduler_mixed_seed5", SERVE_PAGED_I8, lambda: run(5))
    b, c = run(5), run(6)
    drawn = [i for i, k in enumerate(MIX_KINDS) if k in ("sampled",
                                                         "mirostat")]
    fixed = [i for i in range(len(MIX_KINDS)) if i not in drawn]
    if a != b:
        raise AssertionError("the mix with seed 5 twice gave other ids")
    if all(a[i] == c[i] for i in drawn) or any(a[i] != c[i] for i in fixed):
        raise AssertionError(f"seed 6 against 5: drawn ids {[c[i] for i in drawn]}"
                             f" / {[a[i] for i in drawn]}")
    log(f"scheduler mix, seed 5 twice: equal ids; seed 6: other ids at "
        f"{sum(a[i] != c[i] for i in drawn)} of {len(drawn)} sampled "
        "queries, the greedy and beam ids unchanged")


class _RowStep:
    """A batch-1 decode step returning its f32 logits row, captured in a
    CUDA graph (``runtime.generate._Graph``), for teacher-forced runs at
    the 7B's width: ``row(token, pos)`` sets the static token and position
    and replays."""

    def __init__(self, model, cache, token, pos):
        self.token = torch.full((1, 1), token, dtype=torch.long, device=DEV)
        self.pos = torch.full((1,), pos, dtype=torch.long, device=DEV)
        self.g = _Graph(lambda: model(self.token, self.pos, cache)[:, -1])

    def row(self, token, pos):
        self.token.fill_(token)
        self.pos.fill_(pos)
        return self.g.replay()[0].float().cpu()


def _stream_ref_rows(params, prompt, ids, kv, until):
    """Teacher-forced batch-1 logits rows of a stream (``stream_generate``'s
    computation) fed ``ids`` after ``prompt``: the prefill's last row, then
    one step per id, the row shifted before the write that would overflow
    it; ``until`` rows."""
    cache = init_cache(CFG, 1, STREAM_LEN, kv, device=DEV)
    n_discard = (STREAM_LEN - 4) // 2
    with torch.inference_mode():
        rows = [prefill_step(params, torch.tensor([prompt], device=DEV),
                             torch.zeros(1, dtype=torch.long, device=DEV),
                             cache)[0, -1].float().cpu()]
        pos, step = len(prompt), None
        for tok in ids[:until - 1]:
            if pos >= STREAM_LEN:
                ST.shift_cache_impl(cache, params.rope_inv_freqs, CFG, 4,
                                    n_discard)
                pos -= n_discard
            if step is None:
                step = _RowStep(params, cache, tok, pos)
            rows.append(step.row(tok, pos))
            pos += 1
    return rows


class _SlotRows:
    """Records, on a Scheduler, the f32 logits row each token of the
    requests ``rids`` was drawn from, keyed (request id, token index): the
    prefill's last row, then its row of each decode step (the step's
    logits output, graphed or eager)."""

    def __init__(self, sched, rids):
        self.rows = {}
        one, step = sched._sample_one, sched._decode_sample_step

        def sample_one(row, seq):
            if seq.request_id in rids:
                self.rows[(seq.request_id, 0)] = row.float().cpu()
            return one(row, seq)

        def decode_sample_step():
            at = {s: (q.request_id, len(q.output_ids))
                  for s, q in sched.running.items() if q.request_id in rids}
            ids, logits = step()
            for slot, key in at.items():
                self.rows[key] = logits[slot].float().cpu()
            return ids, logits

        sched._sample_one = sample_one
        sched._decode_sample_step = decode_sample_step


def _stream_eager_equal(params, prompt, kv, rows, n_new):
    """The server's streaming slot against the same Scheduler route run
    eagerly: ``prompt`` alone through a streaming slots Scheduler of the
    server's shape, decode steps eager, ``n_new`` tokens (past the first
    shift); its logits rows must equal the server's first ``rows`` to the
    bit, so the graphed steps read the shifted row. Returns n_new."""
    sched = Scheduler(params, CFG, max_batch=8, max_len=STREAM_LEN,
                      kv_dtype=kv, streaming=True, n_keep=4,
                      sampling=GREEDY_NP)
    sched._graphs = None
    rec = _SlotRows(sched, {0})
    sched.add_request(0, prompt, max_new_tokens=n_new)
    sched.run_to_completion()
    for t in range(n_new):
        if not torch.equal(rec.rows[(0, t)], rows[t]):
            raise AssertionError(f"streaming slot, token {t}: the graphed "
                                 f"server's logits differ from the eager "
                                 f"Scheduler's by "
                                 f"{(rec.rows[(0, t)] - rows[t]).abs().max()}")
    del sched
    torch.cuda.empty_cache()
    return n_new


def _streaming_slots(params):
    """Item 3: ``ModelServer(shift_roped_k=True, ctx_size=512, n_keep=4,
    kv_mode="slots")``, bf16 and then int8 KV, greedy without penalty, 8
    queries of 256 tokens with 600 new each (every slot shifts twice); a
    path each. Query 0's logits rows, all of them, through both shifts of
    its slot and the graphed steps after them, within SERVE_TOL of a
    batch-1 stream fed the server's own ids (``stream_generate``'s
    computation, teacher-forced), and to the bit equal to an eager
    Scheduler's through the first shift (:func:`_stream_eager_equal`); its
    ids against ``stream_generate``'s,
    equal where the margins prove them, up to the first parting. The
    shifts counted, and one slot's shift timed on the card at the 7B's
    width."""
    g = torch.Generator().manual_seed(47)
    prompts = [torch.randint(3, V, (256,), generator=g).tolist()
               for _ in range(8)]
    res = {}
    for kv, kvdt, md, attn in (
            ("bf16", torch.bfloat16, "auto", ("flash_prefill",
                                              "flash_decode")),
            ("int8", torch.int8, "int8", ("flash_prefill_i8",
                                          "flash_decode_i8"))):
        srv = ModelServer(params, CFG, max_batch=8, ctx_size=STREAM_LEN,
                          shift_roped_k=True, n_keep=4, kv_mode="slots",
                          memory_dtype=md, sampling=GREEDY_NP)
        shifts, orig = [], SCHED.shift_cache_impl

        def counted(*a):
            _, ms = _host_ms(lambda: orig(*a))
            shifts.append(ms)

        rec = _SlotRows(srv.scheduler, {0})
        SCHED.shift_cache_impl = counted
        try:
            done, _, wall = run_path(
                f"server_streaming_{kv}", ("qmm4_npack", "qmm_a8") + attn,
                lambda: _serve(srv, prompts, STREAM_NEW, timeout=600.0))
        finally:
            SCHED.shift_cache_impl = orig
            srv.stop()
        if len(shifts) < 2 * len(prompts):
            raise AssertionError(f"streaming {kv}: {len(shifts)} shifts")
        want = ST.stream_generate(params, CFG, prompts[0], STREAM_NEW,
                                  STREAM_LEN, n_keep=4,
                                  kv_dtype=kvdt)[len(prompts[0]):]
        got = done[0].output_ids      # shorter if it drew the stop id
        until = next((t + 1 for t in range(len(got)) if got[t] != want[t]),
                     len(got))
        refs = _stream_ref_rows(params, prompts[0], got, kvdt, len(got))
        rows = [rec.rows[(0, t)] for t in range(len(got))]
        apart = [(a - b).abs().max().item() / b.abs().max().item()
                 for a, b in zip(rows, refs)]
        log(f"streaming {kv}: query 0's rows against the batch-1 stream, "
            f"largest relative difference per 50 tokens: "
            f"{[round(max(apart[i:i + 50]), 4) for i in range(0, len(apart), 50)]}")
        if not max(apart) <= SERVE_TOL:
            t = max(range(len(apart)), key=apart.__getitem__)
            raise AssertionError(f"streaming {kv}: token {t}'s logits part "
                                 f"from the batch-1 stream's by "
                                 f"{apart[t]:.4g}·max|logit|")
        # the first row computed after the slot's first shift
        first = STREAM_LEN - len(prompts[0]) + 1
        if len(got) <= first:
            raise AssertionError(f"streaming {kv}: query 0 stopped at "
                                 f"{len(got)} ids, before its first shift")
        proven = _proven_equal(got, want, refs[:until], rows[:until], None,
                               f"streaming {kv} slot vs stream_generate")
        n_eager = _stream_eager_equal(params, prompts[0], kvdt, rows,
                                      first + 16)
        cache = init_cache(CFG, 8, STREAM_LEN, kvdt, device=DEV)
        dev_ms = _event_ms(lambda: ST.shift_cache_impl(
            cache.rows(3, 1), params.rope_inv_freqs, CFG, 4,
            (STREAM_LEN - 4) // 2))
        del cache
        n_tok = sum(len(q.output_ids) for q in done.values())
        log(f"server streaming {kv} (8 queries of 256 tokens, {STREAM_NEW} "
            f"new each, 512 positions): {n_tok / wall:.1f} tok/s; "
            f"{len(shifts)} shifts, host ms median "
            f"{statistics.median(shifts):.3f}; one slot's shift "
            f"{dev_ms:.4f} ms on the card (events around the call); query "
            f"0's logits rows within {max(apart):.3g}·max|logit| of the "
            f"batch-1 stream fed its ids over all {len(got)} tokens (tol "
            f"{SERVE_TOL}; {max(apart[first:]):.3g} after its first shift), "
            f"and equal to the bit to an eager Scheduler's over its first "
            f"{n_eager} (through the first shift); "
            f"it equals stream_generate over its first {until} ids (to the "
            f"end or the first parting), {proven} proven by the margins")
        if proven < 4:
            raise AssertionError(f"streaming {kv}: too few proven steps")
        res.update({f"stream_{kv}_server_tok_s": n_tok / wall,
                    f"stream_{kv}_server_shifts": len(shifts),
                    f"stream_{kv}_slot_shift_ms": dev_ms,
                    f"stream_{kv}_proven": proven,
                    f"stream_{kv}_rel_err": max(apart)})
        del srv
        torch.cuda.empty_cache()
    return res


def _decode_blocks(params):
    """Item 4: 8 greedy queries (phase 6's first 8 prompts, 64 new each)
    through the paged int8 server with ``decode_block`` 1 and 8, two
    warm-up queries first (they capture the single step's graph and the
    block's); equal ids, tok/s of both."""
    prompts = _server_prompts()[:8]
    out, res = [], {}
    for k in (1, 8):
        srv = ModelServer(params, CFG, max_batch=8, max_len=S_CACHE,
                          kv_mode="paged", page_size=256, memory_dtype="int8",
                          decode_block=k)
        try:
            _serve(srv, [prompts[0][:300], prompts[1][:300]], 16)
            done, _, wall = run_path(
                f"server_decode_block{k}", ("qmm4_npack", "qmm_a8",
                                            "flash_prefill_i8",
                                            "paged_decode_i8"),
                lambda: _serve(srv, prompts, 64))
            if k > 1 and not srv.scheduler._blocks:
                raise AssertionError("no decode block ran")
        finally:
            srv.stop()
        out.append({i: q.output_ids for i, q in done.items()})
        res[f"block{k}_tok_s"] = sum(map(len, out[-1].values())) / wall
        del srv
        torch.cuda.empty_cache()
    if out[0] != out[1]:
        raise AssertionError("decode blocks of 8 gave other ids than "
                             "single steps")
    log(f"server decode blocks (8 greedy queries, 64 new each): "
        f"decode_block 8 {res['block8_tok_s']:.1f} tok/s against "
        f"{res['block1_tok_s']:.1f} at 1; ids equal")
    return res


def _torch_op_times(params):
    """The torch ops of this slice timed alone at the 7B's width (events
    around one call, its host launches included): the page reorder (3
    beam rows' pages, int8 pool of page 256, 1 and 6 pages each), the slot
    reorder (3 of 4 rows, bf16, over 160 and 2048 positions), against
    the bytes each reads and writes."""
    res = {}
    pool = init_paged_cache(CFG, 8, S_CACHE, None, 256, torch.int8, DEV)
    for per in (1, 6):
        src = list(range(per * 3))
        dst = list(range(32, 32 + per * 3))
        ms = _event_ms(lambda: copy_kv(pool, src, dst))
        nbytes = 2 * len(src) * sum(t[:, 0].numel() * t.element_size()
                                    for t in (pool.k, pool.v, pool.k_scale,
                                              pool.v_scale))
        log(f"page reorder, 3 rows x {per} page(s) of 256, int8: {ms:.4f} "
            f"ms for {nbytes / 1e6:.1f} MB read and written (bound "
            f"{nbytes / HBM_BPS * 1e3:.4f} ms)")
        res[f"page_reorder_ms_{per}p"] = ms
    del pool
    cache = init_cache(CFG, 8, S_CACHE, device=DEV)
    for n in (160, S_CACHE):
        ms = _event_ms(lambda: copy_kv(cache, [0, 0, 2], [1, 2, 3], n))
        nbytes = 2 * 2 * 3 * L * H * n * DH * 2
        log(f"slot reorder, 3 of 4 rows, bf16, {n} positions: {ms:.4f} ms "
            f"for {nbytes / 1e6:.1f} MB read and written (bound "
            f"{nbytes / HBM_BPS * 1e3:.4f} ms)")
        res[f"slot_reorder_ms_{n}"] = ms
    del cache
    torch.cuda.empty_cache()
    return res


def phase_serving_beyond_greedy(params):
    """Phase 6c on phase 6's 7B: mixed traffic through the paged int8
    server, the mix's seeds through the Scheduler, StreamingLLM slots (bf16
    and int8), decode blocks, and the slice's torch ops timed alone."""
    res, queries = _mixed_traffic(params)
    _mix_seeds(params, queries)
    res.update(_streaming_slots(params))
    res.update(_decode_blocks(params))
    res.update(_torch_op_times(params))
    return {f"6c_{k}": v for k, v in res.items()}


# ---------------------------------------------------------------------------
# phases 4d, 4e, 5c and 6b: Bloom-7B1, ChatGLM-6B and MPT-7B
# ---------------------------------------------------------------------------

# bigscience/bloom-7b1's config.json: 30 layers, hidden 4096, 32 heads
# (head dim 128), FFN 4 x 4096, vocab 250880 with tied embeddings,
# layer_norm_epsilon 1e-5, bos 1, eos 2; the family's ALiBi, LayerNorms with
# biases, embedding LayerNorm, projection biases and tanh GELU come from
# neural_tpu_torch/models/bloom.py
BLOOM_CFG = bloom.config_from_hf(types.SimpleNamespace(
    vocab_size=250880, hidden_size=4096, n_layer=BLOOM_L, n_head=H,
    layer_norm_epsilon=1e-5, bos_token_id=1, eos_token_id=2))
# THUDM/chatglm-6b's config.json: 28 layers, hidden 4096, 32 heads,
# inner_hidden_size 16384, vocab 130528 with an untied lm_head,
# layernorm_epsilon 1e-5, max_sequence_length 2048, bos 130004, eos 130005,
# position_encoding_2d; the residual alpha sqrt(2 * 28) = sqrt(56), the 2-D
# GLM RoPE and the prefix mask come from neural_tpu_torch/models/chatglm.py
CHATGLM_CFG = chatglm.config_from_hf(types.SimpleNamespace(
    position_encoding_2d=True, vocab_size=130528, hidden_size=4096,
    num_layers=CHATGLM_L, num_attention_heads=H, inner_hidden_size=16384,
    layernorm_epsilon=1e-5, max_sequence_length=2048, bos_token_id=130004,
    eos_token_id=130005))
# mosaicml/mpt-7b's config.json: 32 layers, d_model 4096, 32 heads,
# expansion_ratio 4, vocab 50432 tied, max_seq_len 2048, ALiBi; no biases,
# LayerNorms without bias, exact GELU (neural_tpu_torch/models/mpt.py)
MPT_CFG = mpt.config_from_hf(types.SimpleNamespace(
    d_model=4096, n_heads=H, n_layers=32, expansion_ratio=4,
    vocab_size=50432, max_seq_len=2048, attn_config={"alibi": True}))
BLOOM_GEN = ("qmm4_npack", "qmm_a8", "flash_prefill+alibi",
             "flash_decode+alibi")
BLOOM_GEN_INT8 = ("qmm4_npack", "qmm_a8", "flash_prefill_i8+alibi",
                  "flash_decode_i8+alibi")
CHATGLM_GEN = ("qmm4_npack", "qmm_a8", "flash_prefill+prefix",
               "flash_decode")
CHATGLM_GEN_INT8 = ("qmm4_npack", "qmm_a8", "flash_prefill_i8+prefix",
                    "flash_decode_i8")
# prompt tails in the 32/64/128 buckets prefill through K5
BLOOM_SERVE_I8 = ("qmm4_npack", "qmm_a8", "qmm_general",
                  "flash_prefill_i8+alibi", "paged_decode_i8+alibi")


def _init_full(cfg, what):
    t = time.time()
    torch.cuda.reset_peak_memory_stats()
    params = init_random(cfg, seed=0, quant="q4_j", device=DEV)
    torch.cuda.synchronize()
    nbytes = sum(b.numel() * b.element_size() for b in params.buffers())
    log(f"init_random {what} q4_j on the card: {time.time() - t:.1f} s, "
        f"{nbytes / 1e9:.3f} GB of weights and embedding; decode bound "
        f"{nbytes / HBM_BPS * 1e3:.3f} ms/token before the KV read")
    return params


def _generate_paths(params, cfg, what, paths):
    """``Model.generate`` (512-token prompt, 16 new tokens, greedy) once
    per (KV dtype, kernels it must launch), each a path."""
    model = Model().init_params(params, cfg)
    gen = torch.Generator().manual_seed(9)
    prompt = torch.randint(3, cfg.vocab_size, (512,), generator=gen).tolist()
    for kv, required in paths:
        out = run_path(f"{what}_generate_{kv}", required,
                       lambda: model.generate(prompt, max_new_tokens=16,
                                              do_sample=False,
                                              stop_at_eos=False,
                                              kv_dtype=kv)[0])
        _check_ids(out[512:], 16, f"{what} generate {kv}", cfg.vocab_size)
        log(f"{what} Model.generate greedy, {kv} KV, 512-token prompt: new "
            f"ids {out[512:]}")


def phase_bloom():
    """Bloom-7B1 at full depth, q4_j, random weights from seed 0 drawn and
    quantized on the card: ``Model.generate`` with bf16 and int8 KV, decode
    ms/token at fills 128 and 1975 (bf16 KV), TTFT at 1975 tokens, peak
    memory; each a path with its launch counts. Returns (numbers,
    params) for phase 6b."""
    params = _init_full(BLOOM_CFG, "Bloom-7B1")
    _generate_paths(params, BLOOM_CFG, "bloom",
                    (("bf16", BLOOM_GEN), ("int8", BLOOM_GEN_INT8)))
    res = {}
    for fill in (128, T_PREFILL):
        ms = run_path(f"bloom_decode_fill{fill}",
                      ("qmm4_npack", "flash_decode+alibi"),
                      lambda: decode_ms(params, fill, cfg=BLOOM_CFG))
        log(f"bloom decode (slope n=4..36, batch 1, bf16 KV): fill {fill} "
            f"{ms:.3f} ms/token ({1e3 / ms:.1f} tok/s)")
        res[f"bloom_decode_ms_fill{fill}"] = ms
    ms = run_path("bloom_prefill_1975", ("qmm_a8", "flash_prefill+alibi"),
                  lambda: ttft_ms(params, cfg=BLOOM_CFG))
    log(f"bloom TTFT 1975-token prefill (last-row logits, bf16 KV): "
        f"{ms:.2f} ms")
    res["bloom_ttft_1975_ms"] = ms
    res["bloom_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"bloom peak device memory {res['bloom_peak_gib']:.2f} GiB")
    return res, params


def phase_bloom_server(params):
    """Bloom-7B1 behind the batch-8 paged int8 ``ModelServer``, phase 6's
    12 queries; then a short paged bf16 run (K6's bf16 ALiBi branch)."""
    prompts = _server_prompts()
    res = {f"bloom_server_{k}": v for k, v in _server_timed(
        params, BLOOM_CFG, "bloom_server_paged_int8", BLOOM_SERVE_I8,
        prompts).items()}
    _server_short(params, BLOOM_CFG, (
        ("bloom_server_paged_bf16", dict(kv_mode="paged", page_size=256),
         ("qmm4_npack", "flash_prefill+alibi", "paged_decode+alibi"),
         [p[:n] for p, n in zip(prompts, (90, 200))], 8),))
    return res


def phase_chatglm():
    """ChatGLM-6B at full depth, q4_j (the lm_head too), random weights from
    seed 0: ``Model.generate`` with bf16 and int8 KV, decode ms/token at
    fill 128, TTFT at 1975 tokens (the whole prompt is the prefix), peak
    memory; each a path with its launch counts."""
    params = _init_full(CHATGLM_CFG, "ChatGLM-6B")
    _generate_paths(params, CHATGLM_CFG, "chatglm",
                    (("bf16", CHATGLM_GEN), ("int8", CHATGLM_GEN_INT8)))
    ms = run_path("chatglm_decode_fill128", ("qmm4_npack", "flash_decode"),
                  lambda: decode_ms(params, 128, cfg=CHATGLM_CFG))
    log(f"chatglm decode (slope n=4..36, batch 1, bf16 KV): fill 128 "
        f"{ms:.3f} ms/token ({1e3 / ms:.1f} tok/s)")
    ttft = run_path("chatglm_prefill_1975", ("qmm_a8", "flash_prefill+prefix"),
                    lambda: ttft_ms(params, cfg=CHATGLM_CFG))
    log(f"chatglm TTFT 1975-token prefill, all of it the prefix (last-row "
        f"logits, bf16 KV): {ttft:.2f} ms")
    res = dict(chatglm_decode_ms_fill128=ms, chatglm_ttft_1975_ms=ttft,
               chatglm_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"chatglm peak device memory {res['chatglm_peak_gib']:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    return res


ZOO_COPIES = (
    ("bloom", BLOOM_CFG, ("qmm_general", "qmm4_npack", "flash_prefill+alibi",
                          "flash_decode+alibi")),
    ("mpt", MPT_CFG, ("qmm_general", "qmm4_npack", "flash_prefill+alibi",
                      "flash_decode+alibi")),
    ("chatglm", CHATGLM_CFG, ("qmm_general", "qmm4_npack",
                              "flash_prefill+prefix", "flash_decode")))


def phase_zoo_card_vs_plain(rel_tol=2e-2):
    """One-layer full-width copies of Bloom-7B1, MPT-7B and ChatGLM-6B:
    ``Model.generate`` on the card (a path each: 100-token prompt, 4 new
    tokens), then its logits, fed the card's ids, against the plain path
    on the CPU, argmax equal wherever the margin proves it. Every product
    here has bf16 activations (100 rows take K5, not the int8 path), as in
    phase 5's formats, so the tolerance is theirs, 2e-2·max|logit|; then,
    on the Bloom copy, phase 5's paged int8 Scheduler check."""
    gen = torch.Generator().manual_seed(12)
    res = {}
    for i, (what, cfg, required) in enumerate(ZOO_COPIES):
        cfg2 = dataclasses.replace(cfg, n_layers=COPY_LAYERS)
        card = init_random(cfg2, seed=20 + i, quant="q4_j", device=DEV)
        host = init_random(cfg2, seed=20 + i, quant="q4_j",
                           device=DEV).to("cpu")
        ids = torch.randint(3, V, (100,), generator=gen).tolist()
        model = Model().init_params(card, cfg2)
        new = run_path(f"card_{what}", required, lambda: model.generate(
            ids, max_new_tokens=4, do_sample=False,
            stop_at_eos=False)[0])[len(ids):]
        _check_ids(new, 4, f"card {what}", cfg2.vocab_size)
        worst, provable, _ = _steps_card_vs_plain(card, host, cfg2, ids,
                                                  new[:3], rel_tol)
        log(f"{what} card vs plain ({cfg2.n_layers} layer(s), full width, "
            f"100-token prompt, "
            f"fed the card's ids {new}): logits max err {worst:.3g}·"
            f"max|logit| (tol {rel_tol}); argmax provably comparable at "
            f"{provable} of 4 steps, equal at all of them")
        if provable < 2:
            raise AssertionError(f"too few {what} steps with a margin wide "
                                 "enough to compare the argmax")
        res[f"{what}_card_vs_plain_rel_err"] = worst
        if what == "bloom":
            res["bloom_sched_card_vs_plain_rel_err"] = _sched_card_vs_plain(
                card, host, cfg2, rel_tol)
        del card, host, model
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 4f, 4g, 4h and 5d: GPTQ/AWQ, the mixed-bit and a8 layouts, head
# dim 64, RoPE scaling and more than 8 query heads per KV head
# ---------------------------------------------------------------------------

# mistralai/Mistral-7B-v0.1's config.json: 32 layers, hidden 4096, 32 heads
# over 8 KV heads of 128, FFN 14336, vocab 32000 untied, rope_theta 10000,
# rms_norm_eps 1e-5, max_position_embeddings 32768, bos 1, eos 2 (its
# sliding_window 4096 is not read, as the JAX package does not read it);
# the checkpoint takes the form of TheBloke/Mistral-7B-v0.1-GPTQ's
# quantize_config.json: bits 4, group_size 128, desc_act true
MISTRAL_HF = dict(
    model_type="mistral", vocab_size=V, hidden_size=D, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=H, num_key_value_heads=8,
    max_position_embeddings=32768, rms_norm_eps=1e-5, rope_theta=10000.0,
    tie_word_embeddings=False, bos_token_id=1, eos_token_id=2)
MISTRAL_CFG = llama.config_from_hf(types.SimpleNamespace(**MISTRAL_HF))
GPTQ_QUANTIZE_CONFIG = {"bits": 4, "group_size": 128, "desc_act": True,
                        "sym": False}
# GPTQ's same-Hessian rule: q/k/v share one act-order g_idx, gate/up
# another; o_proj and down_proj have their own
GPTQ_PROJ = (("self_attn.q_proj", "qkv"), ("self_attn.k_proj", "qkv"),
             ("self_attn.v_proj", "qkv"), ("self_attn.o_proj", "o"),
             ("mlp.gate_proj", "gu"), ("mlp.up_proj", "gu"),
             ("mlp.down_proj", "down"))


def _gptq_shape(name, cfg):
    Dq, Dkv, I = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim, \
        cfg.intermediate_size
    return {"self_attn.q_proj": (cfg.hidden_size, Dq),
            "self_attn.k_proj": (cfg.hidden_size, Dkv),
            "self_attn.v_proj": (cfg.hidden_size, Dkv),
            "self_attn.o_proj": (Dq, cfg.hidden_size),
            "mlp.gate_proj": (cfg.hidden_size, I),
            "mlp.up_proj": (cfg.hidden_size, I),
            "mlp.down_proj": (I, cfg.hidden_size)}[name]


def gptq_state_dict(cfg, seed, fmt="gptq"):
    """A GPTQ (act-order) or AWQ 4-bit group-128 state dict of a Llama-family
    ``cfg``, synthesized on the host from ``seed`` as safetensors holds one:
    qweight int32 words (random words are valid packed codes, mean 7.5),
    zero-points 7 or 8 packed (mean 7.5, so that the weights have no mean;
    GPTQ stores z - 1), f16 scales in [0.003, 0.005] (weights
    of about 0.02 rms, as ``init_random`` draws them, so that the logits
    stay finite and their argmax is no tie), g_idx int32 with equal groups
    in a random order, f16 norm weights of 1, embedding and lm_head
    N(0, 0.02) in f16."""
    rng = np.random.default_rng(seed)
    g = GPTQ_QUANTIZE_CONFIG["group_size"]

    def words(shape):
        return rng.integers(0, 1 << 32, shape, dtype=np.uint32).view(np.int32)

    def zero_words(G, N):
        z = rng.integers(7, 9, (G, N // 8, 8), dtype=np.uint32)
        if fmt == "gptq":
            z -= 1
        return np.bitwise_or.reduce(z << (4 * np.arange(8, dtype=np.uint32)),
                                    axis=2).view(np.int32)

    sd = {}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        gidx = {}
        for name, share in GPTQ_PROJ:
            K, N = _gptq_shape(name, cfg)
            base = p + name
            sd[base + ".qweight"] = words((K // 8, N) if fmt == "gptq"
                                          else (K, N // 8))
            sd[base + ".qzeros"] = zero_words(K // g, N)
            sd[base + ".scales"] = rng.uniform(
                0.003, 0.005, (K // g, N)).astype(np.float16)
            if fmt == "gptq":
                if share not in gidx:
                    gi = np.empty(K, np.int32)
                    gi[rng.permutation(K)] = np.arange(K, dtype=np.int32) // g
                    gidx[share] = gi
                sd[base + ".g_idx"] = gidx[share]
        for n in ("input_layernorm", "post_attention_layernorm"):
            sd[p + n + ".weight"] = np.ones(cfg.hidden_size, np.float16)
    normal = lambda shape: (rng.standard_normal(shape, np.float32)
                            * 0.02).astype(np.float16)
    sd["model.embed_tokens.weight"] = normal((cfg.vocab_size,
                                              cfg.hidden_size))
    sd["model.norm.weight"] = np.ones(cfg.hidden_size, np.float16)
    sd["lm_head.weight"] = normal((cfg.vocab_size, cfg.hidden_size))
    return sd


def write_safetensors(path, tensors):
    """numpy arrays → one ``.safetensors`` file: the 8-byte header length,
    the JSON header, the raw little-endian bytes in C order."""
    names = {np.dtype(np.int32): "I32", np.dtype(np.float16): "F16",
             np.dtype(np.float32): "F32"}
    header, off = {}, 0
    for k, a in tensors.items():
        header[k] = {"dtype": names[a.dtype], "shape": list(a.shape),
                     "data_offsets": [off, off + a.nbytes]}
        off += a.nbytes
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(h)) + h)
        for a in tensors.values():
            fh.write(np.ascontiguousarray(a).tobytes())


MISTRAL_GEN = ("act_order_gather", "qmm_general", "qmm4_npack_asym",
               "flash_prefill", "flash_decode")
MISTRAL_GEN_INT8 = ("act_order_gather", "qmm_general", "qmm4_npack_asym",
                    "flash_prefill_i8", "flash_decode_i8")


def phase_mistral_gptq():
    """Mistral-7B GPTQ at full depth: its state dict synthesized on the host
    (``gptq_state_dict``), converted on the card by
    ``params_from_gptq_state_dict`` (what ``Model.init(dir,
    use_gptq=True)`` calls); ``Model.generate`` with bf16 and int8 KV,
    decode ms/token at fills 128 and 1975, TTFT at 1975 tokens with bf16
    and int8 KV, peak memory from just after the conversion, each a path
    with its launch counts; a decode step must gather x three times a
    layer (wqkv, wo, w_gateup; w_down's perm is folded), one gather per
    four K1 launches; and one ``index_select`` timed alone at [1, 4096] and
    [1975, 4096]."""
    t = time.time()
    sd = gptq_state_dict(MISTRAL_CFG, seed=0)
    t_synth = time.time() - t
    resident = torch.cuda.memory_allocated()
    t = time.time()
    params = params_from_gptq_state_dict(sd, MISTRAL_CFG, bits=4,
                                         group_size=128, device=DEV)
    torch.cuda.synchronize()
    nbytes = sum(b.numel() * b.element_size() for b in params.buffers())
    log(f"Mistral-7B GPTQ state dict synthesized on the host in {t_synth:.1f}"
        f" s ({sum(a.nbytes for a in sd.values()) / 1e9:.3f} GB), converted "
        f"on the card in {time.time() - t:.1f} s: {nbytes / 1e9:.3f} GB of "
        f"weights, perms and embedding; decode bound "
        f"{nbytes / HBM_BPS * 1e3:.3f} ms/token before the KV read")
    del sd
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _generate_paths(params, MISTRAL_CFG, "mistral_gptq",
                    (("bf16", MISTRAL_GEN), ("int8", MISTRAL_GEN_INT8)))
    res = {}
    dec = ("act_order_gather", "qmm4_npack_asym", "flash_decode")
    for fill in (128, T_PREFILL):
        name = f"mistral_gptq_decode_fill{fill}"
        ms = run_path(name, dec, lambda: decode_ms(params, fill,
                                                   cfg=MISTRAL_CFG))
        c = LAUNCHES[name]
        if 4 * c["act_order_gather"] != 3 * c["qmm4_npack_asym"]:
            raise AssertionError(f"{name}: {c['act_order_gather']} gathers "
                                 f"for {c['qmm4_npack_asym']} K1 launches")
        log(f"mistral gptq decode (slope n=4..36, batch 1, bf16 KV): fill "
            f"{fill} {ms:.3f} ms/token ({1e3 / ms:.1f} tok/s)")
        res[f"mistral_gptq_decode_ms_fill{fill}"] = ms
    for kv_dtype, kv, k3 in ((torch.bfloat16, "bf16", "flash_prefill"),
                             (torch.int8, "int8", "flash_prefill_i8")):
        ms = run_path(f"mistral_gptq_prefill_{kv}",
                      ("act_order_gather", "qmm_general", k3),
                      lambda: ttft_ms(params, kv_dtype, cfg=MISTRAL_CFG))
        log(f"mistral gptq TTFT 1975-token prefill (last-row logits, {kv} "
            f"KV): {ms:.2f} ms")
        res[f"mistral_gptq_ttft_1975_{kv}_ms"] = ms
    res["mistral_gptq_peak_gib"] = (torch.cuda.max_memory_allocated()
                                    - resident) / 2 ** 30
    perm = params.layers[0].wqkv.perm
    for M in (1, T_PREFILL):
        x = torch.randn((M, D), device=DEV).bfloat16()
        ms = time_ms([lambda: x.index_select(1, perm)])
        res[f"gather_ms_m{M}"] = ms
        log(f"act-order gather, one index_select of [{M}, {D}] bf16: "
            f"{ms:.4f} ms ({4 * M * D / (ms * 1e-3) / 1e9:.0f} GB/s read + "
            "written)")
    log(f"mistral gptq peak device memory since the conversion, less the "
        f"{resident / 2 ** 30:.2f} GiB other phases left resident: "
        f"{res['mistral_gptq_peak_gib']:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    return res


# TinyLlama/TinyLlama-1.1B-Chat-v1.0's config.json: 22 layers, hidden 2048,
# 32 heads over 4 KV heads of 64, FFN 5632, vocab 32000 untied,
# rms_norm_eps 1e-5, rope_theta 10000, max_position_embeddings 2048
TINY_CFG = llama.config_from_hf(types.SimpleNamespace(
    model_type="llama", vocab_size=V, hidden_size=2048,
    intermediate_size=5632, num_hidden_layers=22, num_attention_heads=H,
    num_key_value_heads=4, max_position_embeddings=2048, rms_norm_eps=1e-5,
    rope_theta=10000.0, bos_token_id=1, eos_token_id=2))
ATTN_KERNELS = tuple(fn for k in (_cuda.FLASH_PREFILL, _cuda.FLASH_DECODE,
                                  _cuda.PAGED_DECODE) for fn in k.launches)


def _no_attention_kernels(path):
    """Head dim 64 takes ``attend_xla``'s torch ops: no K3/K4/K6 launch."""
    hit = {k: LAUNCHES[path][k] for k in ATTN_KERNELS if LAUNCHES[path][k]}
    if hit:
        raise AssertionError(f"{path}: attention kernels launched at head "
                             f"dim 64: {hit}")


def phase_tinyllama():
    """TinyLlama-1.1B at full depth, q4_j, random weights from seed 0:
    ``Model.generate`` with bf16 and int8 KV, the batch-8 paged int8
    Scheduler (8 requests of 40-1200 tokens, 16 new each), decode ms/token
    at fill 128, TTFT at 1975 tokens, peak memory less what other phases
    left resident; attention at head dim 64 is ``attend_xla``'s torch ops,
    so K3/K4/K6 must read 0 on every path."""
    resident = torch.cuda.memory_allocated()
    params = _init_full(TINY_CFG, "TinyLlama-1.1B")
    paths = (("bf16", ("qmm4_npack", "qmm_a8", "attend_xla")),
             ("int8", ("qmm4_npack", "qmm_a8", "attend_xla")))
    _generate_paths(params, TINY_CFG, "tinyllama", paths)
    for kv, _ in paths:
        _no_attention_kernels(f"tinyllama_generate_{kv}")
    gen = torch.Generator().manual_seed(14)
    lens = torch.randint(40, 1200, (8,), generator=gen).tolist()
    sched = Scheduler(params, TINY_CFG, max_batch=8, max_len=S_CACHE,
                      kv_mode="paged", page_size=256, kv_dtype=torch.int8)
    for i, n in enumerate(lens):
        sched.add_request(i, torch.randint(3, V, (n,), generator=gen)
                          .tolist(), max_new_tokens=16)
    done = run_path("tinyllama_sched_paged_int8",
                    ("qmm4_npack", "attend_xla_paged"),
                    lambda: {q.request_id: q.output_ids
                             for q in sched.run_to_completion()})
    _no_attention_kernels("tinyllama_sched_paged_int8")
    for i in range(8):
        _check_served(done[i], 16, f"tinyllama scheduler request {i}",
                      TINY_CFG)
    log(f"tinyllama paged int8 Scheduler (batch 8, prompts {lens}): "
        f"request 0 ids {done[0]}")
    del sched
    ms = run_path("tinyllama_decode_fill128", ("qmm4_npack", "attend_xla"),
                  lambda: decode_ms(params, 128, cfg=TINY_CFG))
    ttft = run_path("tinyllama_prefill_1975", ("qmm_a8", "attend_xla"),
                    lambda: ttft_ms(params, cfg=TINY_CFG))
    for path in ("tinyllama_decode_fill128", "tinyllama_prefill_1975"):
        _no_attention_kernels(path)
    log(f"tinyllama decode (slope n=4..36, batch 1, bf16 KV): fill 128 "
        f"{ms:.3f} ms/token ({1e3 / ms:.1f} tok/s); TTFT 1975-token prefill "
        f"{ttft:.2f} ms")
    res = dict(tinyllama_decode_ms_fill128=ms, tinyllama_ttft_1975_ms=ttft,
               tinyllama_peak_gib=(torch.cuda.max_memory_allocated()
                                   - resident) / 2 ** 30)
    del params
    torch.cuda.empty_cache()
    return res


# a registry that puts every K2 layout on one prefill: int2, int3 and int6
# (int8 code planes) at group 128 with int8 activations, sym and asym
K2_LAYOUTS_REG = QuantRegistry(rules=[
    ("wq", QuantConfig(bits=2, group_size=128, act_bits=8)),
    ("wk", QuantConfig(bits=2, group_size=128, sym=False, act_bits=8)),
    ("wv", QuantConfig(bits=3, group_size=128, act_bits=8)),
    ("wo", QuantConfig(bits=3, group_size=128, sym=False, act_bits=8)),
    ("w_gate", QuantConfig(bits=6, group_size=128, act_bits=8)),
    ("w_up", QuantConfig(bits=6, group_size=128, sym=False, act_bits=8))],
    default="q4_j")
# Llama-2-7B's width with ChatGLM-2-6B's attention heads (32 over 2, G = 16)
# and with StarCoder's (48 heads of 128 over 1, hidden 6144, FFN 24576)
G16_CFG = dataclasses.replace(CFG, n_kv_heads=2)
G48_CFG = dataclasses.replace(CFG, hidden_size=6144, n_heads=48,
                              n_kv_heads=1, intermediate_size=24576)


def _copy_card_vs_plain(what, card, host, cfg2, required, n_prompt=24,
                        rel_tol=2e-2, seed=15, n_new=3):
    """``Model.generate`` of a copy on the card (a path with launch
    counts; ``n_prompt`` tokens, ``n_new`` new), then its logits, fed the
    card's ids, against the CPU plain path; returns (the prompt, the card's
    new ids, the worst relative difference, the steps whose margin proved
    the argmax)."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(3, min(cfg2.vocab_size, V), (n_prompt,),
                        generator=gen).tolist()
    model = Model().init_params(card, cfg2)
    new = run_path(f"card_{what}", required, lambda: model.generate(
        ids, max_new_tokens=n_new, do_sample=False,
        stop_at_eos=False)[0])[len(ids):]
    _check_ids(new, n_new, f"card {what}", cfg2.vocab_size)
    worst, provable, _ = _steps_card_vs_plain(card, host, cfg2, ids, new,
                                              rel_tol)
    log(f"{what} card vs plain ({cfg2.n_layers} layer(s), full width, "
        f"{n_prompt}-token "
        f"prompt, fed the card's ids {new}): logits max err {worst:.3g}·"
        f"max|logit| (tol {rel_tol}); argmax provably comparable at "
        f"{provable} of {n_new + 1} steps, equal at all of them")
    return ids, new, worst, provable


def _g_many_card_paths(card, cfg2, what):
    """A copy with more than 8 query heads per KV head on the card alone:
    ``Model.generate`` with int8 KV (K4's int8 branch), and the paged
    Scheduler with bf16 and int8 pools (6 requests of 20-64 tokens, 3 new
    each; K6's), each a path with launch counts, ids in range."""
    gen = torch.Generator().manual_seed(16)
    ids = torch.randint(3, V, (24,), generator=gen).tolist()
    model = Model().init_params(card, cfg2)
    new = run_path(f"card_{what}_int8", ("flash_decode_i8+G>8",),
                   lambda: model.generate(ids, max_new_tokens=3,
                                          stop_at_eos=False,
                                          kv_dtype="int8")[0][24:])
    _check_ids(new, 3, f"{what} int8 KV")
    prompts = [torch.randint(3, V, (n,), generator=gen).tolist()
               for n in torch.randint(20, 64, (6,), generator=gen).tolist()]
    for kv_dtype, entry in ((torch.bfloat16, "paged_decode+G>8"),
                            (torch.int8, "paged_decode_i8+G>8")):
        sched = Scheduler(card, cfg2, max_batch=4, max_len=256,
                          kv_mode="paged", page_size=64, kv_dtype=kv_dtype)
        for i, p in enumerate(prompts):
            sched.add_request(i, p, max_new_tokens=3)
        done = run_path(f"sched_{what}_{entry}", (entry,),
                        lambda: {q.request_id: q.output_ids
                                 for q in sched.run_to_completion()})
        for i in range(len(prompts)):
            _check_served(done[i], 3, f"{what} scheduler {entry}", cfg2)
    log(f"{what} on the card: generate int8 KV ids {new}; paged bf16 and "
        "int8 Schedulers ran 6 requests each")


def _random_pair(cfg2, seed, quant):
    card = init_random(cfg2, seed=seed, quant=quant, device=DEV)
    host = init_random(cfg2, seed=seed, quant=quant, device=DEV).to("cpu")
    return card, host


def phase_copies_card_vs_plain():
    """One-layer full-width copies, card against the CPU plain path (logits
    within 2e-2·max|logit| where every product has bf16 activations, 5e-2
    where a prefill takes the int8 path, as phase 5's q4_j copy; argmax
    equal where the margin proves it): the Mistral GPTQ copy through
    ``Model.generate`` and the paged int8 Scheduler; the same copy written
    to a temporary directory under build/neural_tpu_torch/ (config.json,
    quantize_config.json, model.safetensors) and loaded by ``Model.init(dir,
    use_gptq=True)`` on the card, whose ids and logits must be the
    in-memory copy's; an AWQ copy; mix_int2_int4 (its g16 int2 asym at M=1
    through K5); every K2 layout on one 256-token prefill (int2, int3 and
    int6 at act_bits 8, sym and asym: the int3-a8 and int6-a8 copies);
    Llama-2-7B with linear RoPE scaling (factor 4); the TinyLlama copy
    (``attend_xla``; and its paged int8 Scheduler); Llama-2-7B's width
    with ChatGLM-2's heads (G = 16: K4 and, through the paged int8
    Scheduler, K6 past 8 heads a KV head), whose card-only paths and a
    copy with StarCoder's heads (G = 48) also run K4's int8 and K6's bf16
    branches past 8 heads (``_g_many_card_paths``)."""
    res = {}
    cfg2 = dataclasses.replace(MISTRAL_CFG, n_layers=COPY_LAYERS)
    sd = gptq_state_dict(cfg2, seed=30)
    card = params_from_gptq_state_dict(sd, cfg2, device=DEV)
    host = params_from_gptq_state_dict(sd, cfg2, device=DEV).to("cpu")
    gptq_req = ("act_order_gather", "qmm_general", "qmm4_npack_asym",
                "flash_prefill", "flash_decode")
    # random copies give flat logits (top-2 margins of 0.01-0.8
    # against differences of 0.03-0.08): as phase 5's formats, the argmax
    # must be proven at as many steps as there are copies, over all of them
    ids, new, res["mistral_gptq"], proven = _copy_card_vs_plain(
        "mistral_gptq", card, host, cfg2, gptq_req)
    res["mistral_gptq_sched"] = run_path(
        "sched_mistral_gptq", ("act_order_gather", "paged_decode_i8"),
        lambda: _sched_card_vs_plain(card, host, cfg2, 2e-2))
    del host
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as d:
        with open(os.path.join(d, "config.json"), "w") as fh:
            json.dump({**MISTRAL_HF, "num_hidden_layers": cfg2.n_layers}, fh)
        with open(os.path.join(d, "quantize_config.json"), "w") as fh:
            json.dump(GPTQ_QUANTIZE_CONFIG, fh)
        write_safetensors(os.path.join(d, "model.safetensors"), sd)
        filed = Model().init(d, use_gptq=True, device=DEV)
    new_f = run_path("card_mistral_gptq_file", gptq_req, lambda: filed.generate(
        ids, max_new_tokens=3, do_sample=False,
        stop_at_eos=False)[0])[len(ids):]
    with torch.inference_mode():
        a, b = (prefill_step(m, torch.tensor([ids], device=DEV),
                             torch.zeros(1, dtype=torch.long, device=DEV),
                             init_cache(cfg2, 1, 32, device=DEV))
                for m in (card, filed.params))
    if new_f != new or not torch.equal(a, b):
        raise AssertionError(f"Model.init(dir, use_gptq=True) gave ids "
                             f"{new_f}, the in-memory copy {new}, logits max "
                             f"diff {(a - b).abs().max().item()}")
    log(f"Model.init(dir, use_gptq=True) on the card: ids {new_f} and "
        "prefill logits equal to the in-memory copy's")
    del sd, card, filed
    torch.cuda.empty_cache()

    sd = gptq_state_dict(cfg2, seed=31, fmt="awq")
    card = params_from_gptq_state_dict(sd, cfg2, fmt="awq", device=DEV)
    host = params_from_gptq_state_dict(sd, cfg2, fmt="awq",
                                       device=DEV).to("cpu")
    _, _, res["mistral_awq"], n = _copy_card_vs_plain(
        "mistral_awq", card, host, cfg2,
        ("qmm_general", "qmm4_npack_asym", "flash_prefill", "flash_decode"))
    proven, copies = proven + n, 2
    if LAUNCHES["card_mistral_awq"]["act_order_gather"]:
        raise AssertionError("an AWQ checkpoint has no act-order gather")
    del sd, card, host
    llama2 = dataclasses.replace(CFG, n_layers=COPY_LAYERS)
    # the K2 copy's prefill takes the int8 path, whose activation codes move
    # a step where the card's bf16 roundings differ from the CPU's (as in
    # phase 5's q4_j copy): 5e-2, over 8 steps
    for i, (what, cfg2, quant, req, n_prompt, tol) in enumerate((
            ("mix_int2_int4", llama2, "mix_int2_int4",
             ("qmm_general", "qmm4_npack", "qmm4_npack_asym", "qmm8_native"),
             24, 2e-2),
            ("k2_layouts", llama2, K2_LAYOUTS_REG,
             ("quantize_act_i8",) + tuple(e for _, e, _, _ in K2_LAYOUTS),
             256, 5e-2),
            ("llama_rope_linear",
             dataclasses.replace(llama2, rope_scaling={"type": "linear",
                                                       "factor": 4.0}),
             "q4_j", ("qmm_general", "qmm4_npack", "flash_prefill",
                      "flash_decode"), 24, 2e-2),
            ("tinyllama", dataclasses.replace(TINY_CFG,
                                              n_layers=COPY_LAYERS), "q4_j",
             ("qmm_general", "qmm4_npack", "attend_xla"), 24, 2e-2),
            ("heads_g16", dataclasses.replace(G16_CFG, n_layers=COPY_LAYERS),
             "q4_j",
             ("qmm_general", "flash_prefill", "flash_decode+G>8"), 24,
             2e-2))):
        card, host = _random_pair(cfg2, 40 + i, quant)
        _, _, res[what], n = _copy_card_vs_plain(
            what, card, host, cfg2, req, n_prompt, tol,
            n_new=8 if what == "k2_layouts" else 3)
        proven, copies = proven + n, copies + 1
        if what == "llama_rope_linear":
            base = rope_freqs(DH, None, 10000.0)
            if not torch.equal(card.rope_inv_freqs.cpu(),
                               torch.from_numpy(base / 4.0)):
                raise AssertionError("linear RoPE scaling left the table "
                                     "unscaled")
        if what == "tinyllama":
            _no_attention_kernels("card_tinyllama")
            res["tinyllama_sched"] = run_path(
                "sched_tinyllama", ("attend_xla_paged",),
                lambda: _sched_card_vs_plain(card, host, cfg2, 2e-2))
            _no_attention_kernels("sched_tinyllama")
        if what == "heads_g16":
            res["heads_g16_sched"] = run_path(
                "sched_heads_g16", ("paged_decode_i8+G>8",),
                lambda: _sched_card_vs_plain(card, host, cfg2, 2e-2))
            _g_many_card_paths(card, cfg2, "heads_g16")
        del card, host
        torch.cuda.empty_cache()
    # StarCoder's heads at hidden 6144: the card's paths alone (the copy is
    # 2.3x a Llama copy's CPU time; its kernels are held to their plain
    # versions at these heads in phase 3)
    card = init_random(dataclasses.replace(G48_CFG, n_layers=2), seed=50,
                       quant="q4_j", device=DEV)
    _g_many_card_paths(card, dataclasses.replace(G48_CFG, n_layers=2),
                       "heads_g48")
    del card
    torch.cuda.empty_cache()
    if proven < copies:
        raise AssertionError(f"only {proven} steps over {copies} copies had "
                             "a margin wide enough to compare the argmax")
    return {f"{k}_card_vs_plain_rel_err": v for k, v in res.items()}


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
    # K5's two routes, counted apart (``qmm_general+gemv`` / ``+tc``)
    "K5_gemv": ("qmm_general+gemv", "neural_tpu_torch/csrc/qmm_general.cu",
                "neural_tpu/ops/qmatmul.py:485"),
    "K5_tc": ("qmm_general+tc", "neural_tpu_torch/csrc/qmm_general.cu",
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
    # K1's fusion options (``fuse``, :633-701): the nibble entry's
    # branches, and the int2 and int8-code fused entries
    **{f"K1_{b}": (f"qmm4_npack_fused+{b}",
                   "neural_tpu_torch/csrc/qmm4_npack.cu",
                   "neural_tpu/ops/qmatmul.py:619")
       for b in ("rms", "res", "glu")},
    "K1_int2_fused": ("qmm2_npack_fused",
                      "neural_tpu_torch/csrc/qmm4_npack.cu",
                      "neural_tpu/ops/qmatmul.py:619"),
    "K1_int8_fused": ("qmm8_native_fused",
                      "neural_tpu_torch/csrc/qmm4_npack.cu",
                      "neural_tpu/ops/qmatmul.py:619"),
    "K2_asym": ("qmm_a8_asym", "neural_tpu_torch/csrc/qmm_a8.cu",
                "neural_tpu/ops/qmatmul.py:161"),
    "K2_act": ("quantize_act_i8", "neural_tpu_torch/csrc/qmm_a8.cu",
               "neural_tpu/ops/qmatmul.py:161"),
    # the unfused graph's RMS norm on K1's row-scale routine: no Pallas
    # kernel; it replaces the XLA-fused norm of the JAX package
    "RMS": ("rms_norm_bf16", "neural_tpu_torch/csrc/rms_norm.cu",
            "neural_tpu/ops/norms.py:15 (XLA-fused, no pl.pallas_call)"),
    # the option branches, counted apart (``entry+branch`` launches)
    "K3_alibi": ("flash_prefill+alibi",
                 "neural_tpu_torch/csrc/flash_prefill.cu",
                 "neural_tpu/ops/attention.py:433"),
    "K3_i8_alibi": ("flash_prefill_i8+alibi",
                    "neural_tpu_torch/csrc/flash_prefill.cu",
                    "neural_tpu/ops/attention.py:433"),
    "K3_prefix": ("flash_prefill+prefix",
                  "neural_tpu_torch/csrc/flash_prefill.cu",
                  "neural_tpu/ops/attention.py:433"),
    "K3_i8_prefix": ("flash_prefill_i8+prefix",
                     "neural_tpu_torch/csrc/flash_prefill.cu",
                     "neural_tpu/ops/attention.py:433"),
    "K4_alibi": ("flash_decode+alibi", "neural_tpu_torch/csrc/flash_decode.cu",
                 "neural_tpu/ops/attention.py:110"),
    "K4_i8_alibi": ("flash_decode_i8+alibi",
                    "neural_tpu_torch/csrc/flash_decode.cu",
                    "neural_tpu/ops/attention.py:110"),
    "K6_alibi": ("paged_decode+alibi",
                 "neural_tpu_torch/csrc/paged_decode.cu",
                 "neural_tpu/ops/paged_attention.py:31"),
    "K6_i8_alibi": ("paged_decode_i8+alibi",
                    "neural_tpu_torch/csrc/paged_decode.cu",
                    "neural_tpu/ops/paged_attention.py:31"),
    # K2's other weight layouts, and decode past 8 query heads a KV head
    **{key: (entry, "neural_tpu_torch/csrc/qmm_a8.cu",
             "neural_tpu/ops/qmatmul.py:161")
       for key, entry, _, _ in K2_LAYOUTS},
    **{f"K4{s}_G>8": (f"flash_decode{s}+G>8",
                      "neural_tpu_torch/csrc/flash_decode.cu",
                      "neural_tpu/ops/attention.py:110") for s in ("", "_i8")},
    **{f"K6{s}_G>8": (f"paged_decode{s}+G>8",
                      "neural_tpu_torch/csrc/paged_decode.cu",
                      "neural_tpu/ops/paged_attention.py:31")
       for s in ("", "_i8")},
}


def attn_times(reps=30, seed=7):
    """Device ms of one K3 launch at the Llama-2-7B 1975-token prefill and
    one K4 launch at fill 1975 of 2048 (32 heads of 128, batch 1), bf16
    and int8 KV, inputs drawn from ``seed``; each the median of ``reps``
    CUDA-graph replays of 8 launches (K4 over 8 copies of its cache, so
    that the 50 MB L2 holds none). Self-contained: ``--ab`` runs this
    source in each tree, so the per-kernel gain is read on one card."""
    import statistics
    import torch
    from neural_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(seed)
    H, Dh, S, T = 32, 128, 2048, 1975

    def cache(int8):
        k = torch.randn((1, H, S, Dh), generator=gen, device="cuda")
        v = torch.rand((1, H, S, Dh), generator=gen, device="cuda") * 2 - 1
        if int8:
            (k, ks), (v, vs) = A.quantize_kv(k), A.quantize_kv(v)
            return k, v, ks, vs
        return k.bfloat16(), v.bfloat16()

    def device_ms(fns):
        for f in fns:
            f()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for f in fns:
                f()
        ts = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            g.replay()
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1) / len(fns))
        return statistics.median(ts)

    out = {}
    starts = torch.zeros(1, dtype=torch.int32, device="cuda")
    lengths = torch.full((1,), T, dtype=torch.int32, device="cuda")
    for int8 in (False, True):
        sfx = "_int8" if int8 else "_bf16"
        c0 = cache(int8)
        q = (torch.randn((1, T, H, Dh), generator=gen, device="cuda")
             * 4).bfloat16()
        k3 = A.flash_prefill_i8 if int8 else A.flash_prefill
        out["k3_1975" + sfx + "_ms"] = device_ms(
            [lambda: k3(q, *c0, starts, Dh ** -0.5)] * 8)
        caches = [c0] + [cache(int8) for _ in range(7)]
        q1 = (torch.randn((1, H, Dh), generator=gen, device="cuda")
              * 4).bfloat16()
        k4 = A.flash_decode_i8 if int8 else A.flash_decode
        out["k4_fill1975" + sfx + "_ms"] = device_ms(
            [lambda c=c: k4(q1, *c, lengths, Dh ** -0.5) for c in caches])
        del caches, c0, q, q1
        torch.cuda.empty_cache()
    return out


def k16_times(reps=30, seed=9):
    """Device ms of one K1 and one K6 launch at the Llama-2-7B decode
    shapes, inputs drawn from ``seed``, each the median of ``reps``
    CUDA-graph replays over copies of the weights or pool that the 50 MB
    L2 cannot hold: K1 over q4_j nibbles at M = 1 and 8 (a 4096 x 4096
    product; gate/up's 4096 x 11264 with the RMS-norm prologue; down's
    11264 x 4096 with the residual); K6 at the server's step (B = 8, fills
    1-2048, page 256, 32 heads over 32), bf16 and int8 pools, and at 48
    heads over 1. Self-contained: ``--ab`` runs this source in each tree,
    so the per-kernel gain is read on one card."""
    import math
    import statistics
    import torch
    from neural_tpu_torch.core.dtypes import PRESETS
    from neural_tpu_torch.core.qtensor import quantize, to_native
    from neural_tpu_torch.ops import attention as A
    from neural_tpu_torch.ops import paged_attention as PA
    from neural_tpu_torch.ops import qmatmul as Q
    gen = torch.Generator(device="cuda").manual_seed(seed)
    copies = lambda nbytes: max(1, math.ceil(2 * (50 << 20) / nbytes))

    def device_ms(fns):
        for f in fns:
            f()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for f in fns:
                f()
        ts = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            g.replay()
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1) / len(fns))
        return statistics.median(ts)

    out = {}
    for K, N, opt in ((4096, 4096, None), (4096, 11264, "rms"),
                      (11264, 4096, "res")):
        qt = to_native(quantize(torch.randn((K, N), generator=gen,
                                            device="cuda") * 0.02,
                                PRESETS["q4_j"]))
        ws = [(qt.planes[0].clone(), qt.scales.clone())
              for _ in range(copies(qt.planes[0].numel()))]
        for M in (1, 8):
            x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
            if opt is None:
                fns = [lambda w=w: Q.qmm_native(x, w[0], w[1], None, 128, 4,
                                                torch.bfloat16) for w in ws]
            else:
                kw = dict(res=torch.randn((M, N), generator=gen,
                                          device="cuda").bfloat16()) \
                    if opt == "res" else dict(norm=((1 + 0.3 * torch.randn(
                        K, generator=gen, device="cuda")).bfloat16(), 1e-5,
                        0.0))
                fns = [lambda w=w: Q.qmm_native_fused(
                    x, w[0], w[1], 128, 4, torch.bfloat16, **kw) for w in ws]
            name = f"k1_{K}x{N}" + ("" if opt is None else "_" + opt)
            out[f"{name}_m{M}_ms"] = device_ms(fns)
        del ws, qt
    cpu = torch.Generator().manual_seed(seed)
    fills, ps, D = [1, 2048, 1975, 128, 700, 1300, 33, 1024], 256, 128
    B, maxp = len(fills), 2048 // ps
    P = B * maxp + 1
    table = torch.randperm(P - 1, generator=cpu)[:B * maxp] \
        .reshape(B, maxp).to(torch.int32).to("cuda")
    lengths = torch.tensor(fills, dtype=torch.int32, device="cuda")
    for Hq, Hkv, int8 in ((32, 32, False), (32, 32, True), (48, 1, False)):
        q = (torch.randn((B, Hq, D), generator=gen, device="cuda")
             * 4).bfloat16()
        k = torch.randn((P, Hkv, ps, D), generator=gen, device="cuda")
        v = torch.rand((P, Hkv, ps, D), generator=gen, device="cuda") * 2 - 1
        if int8:
            (k, ks), (v, vs) = A.quantize_kv(k), A.quantize_kv(v)
            fn = lambda: PA.paged_decode_i8(q, k, v, ks, vs, table, lengths,
                                            D ** -0.5)
        else:
            k, v = k.bfloat16(), v.bfloat16()
            fn = lambda: PA.paged_decode(q, k, v, table, lengths, D ** -0.5)
        out[f"k6_server_{Hq}over{Hkv}{'_int8' if int8 else ''}_ms"] = \
            device_ms([fn] * 4)
        del q, k, v
        torch.cuda.empty_cache()
    return out


AB_CHILD = """\
import json, os, sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke as c
from neural_tpu_torch.ops import _cuda
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_num_threads(os.cpu_count() or 1)
_cuda.build_all(_cuda.KERNELS)
{attn_times}
print("ATT " + json.dumps(attn_times()), flush=True)
{k16_times}
print("K16 " + json.dumps(k16_times()), flush=True)
params = c.init_random(c.CFG, seed=0, quant="q4_j", device="cuda")
legs = c.phase_generation(params)
legs.update({"server_" + k: v for k, v in c._server_timed(
    params, c.CFG, "server_paged_int8", c.SERVE_PAGED_I8,
    c._server_prompts()).items()})
del params
torch.cuda.empty_cache()
legs.update(c.phase_formats(("nf4", "q4_0")))
print("AB " + json.dumps(legs), flush=True)
{k2_errors}
print("ERR " + json.dumps(k2_errors()), flush=True)
"""


def compare_legs(parent):
    """``python3 chip_smoke.py --ab PARENT``: K3 at the Llama-2-7B 1975-token
    prefill and K4 at fill 1975, bf16 and int8 KV (``attn_times``, this
    file's source run in each tree), K1 at M = 1 and 8 (plain, +rms, +res)
    and K6 at the server's step (bf16, int8, 48 heads over 1;
    ``k16_times``, the same way), phase 4's Llama-2-7B legs (decode at
    fills 128 and 1975, decode_i8kv, batch8, TTFT; the decode step's
    device time by fusion mode), the batch-8 paged int8 server (tok/s, the
    decode iteration at 8 slots, TTFT) and phase 4b's nf4 and
    q4_0 legs (TTFT, decode at fill 128) of the checkout at PARENT (an
    unpacked tree of an earlier commit) and of this one, each run in a
    process of its own, in the order parent, change, change, parent, on
    the same card; prints each run and, per leg, the change's mean over
    the parent's; then K2's largest difference from its plain version per
    entry point (``k2_errors``, this file's source run in each tree) on
    both."""
    import inspect
    log(f"nvidia-smi: {smi_line()}")
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {"parent": [], "change": []}
    errs = {}
    child = AB_CHILD.replace("{k2_errors}", inspect.getsource(k2_errors)) \
        .replace("{attn_times}", inspect.getsource(attn_times)) \
        .replace("{k16_times}", inspect.getsource(k16_times))
    for side in ("parent", "change", "change", "parent"):
        root = os.path.abspath(parent) if side == "parent" else here
        p = subprocess.run([sys.executable, "-c",
                            child.replace("{root!r}", repr(root))],
                           cwd=root, capture_output=True, text=True,
                           timeout=1200)
        if p.returncode:
            raise AssertionError(f"{side} ({root}) legs failed:\n"
                                 f"{p.stderr[-4000:]}")
        lines = p.stdout.splitlines()
        legs = json.loads(next(line for line in lines
                               if line.startswith("AB "))[3:])
        legs.update(json.loads(next(line for line in lines
                                    if line.startswith("ATT "))[4:]))
        legs.update(json.loads(next(line for line in lines
                                    if line.startswith("K16 "))[4:]))
        errs[side] = json.loads(next(line for line in lines
                                     if line.startswith("ERR "))[4:])
        log(f"{side}: {json.dumps(legs)}")
        runs[side].append(legs)
    log(f"K2 max |kernel - plain| per entry point, change: "
        f"{json.dumps(errs['change'])}; parent: {json.dumps(errs['parent'])}")
    mean = lambda side, k: statistics.mean(r[k] for r in runs[side])
    print(json.dumps({"change_over_parent": {
        k: mean("change", k) / mean("parent", k) for k in runs["parent"][0]
        if mean("parent", k)}}))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:2] == ["--ab"]:
        return compare_legs(sys.argv[2])
    # the slice's main path: every phase runs the fused decode path, which
    # the library leaves off by default (``models.transformer.fuse_mode``);
    # the A/B and the unfused references set the switches themselves
    os.environ.setdefault("NTPU_FUSED_DECODE", "1")
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
        for check in (check_k1, check_k2, check_k3, check_k4, check_k6,
                      check_k6_paging, check_k3_options, check_k4_alibi, check_k6_alibi,
                      check_k5, check_k1_branches, check_k1_fused,
                      check_k1_reruns, check_rms_norm, check_k2_asym,
                      check_k2_layouts, check_gptq_products,
                      check_many_heads):
            check(gen, results)
            torch.cuda.empty_cache()
    phase("3 kernels", kernels)
    log("K3/K4 cases slower than the kernel they replace: "
        + ("; ".join(f"{k} {lab}: {ms:.4f} ms against {old} ms"
                     for k, lab, ms, old in ATTN_SLOWER) or "none"))
    log("K1/K6 cases slower than before the redesign: "
        + ("; ".join(f"{k} {lab}: {ms:.4f} ms against {old} ms"
                     for k, lab, ms, old in K16_SLOWER) or "none"))
    window = window_speedups(results)
    branches = branch_costs(results)
    t = time.time()
    params = init_random(CFG, seed=0, quant="q4_j", device=DEV)
    torch.cuda.synchronize()
    log(f"init_random Llama-2-7B q4_j on the card: {time.time() - t:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    e2e = phase("4 generation", phase_generation, params)
    e2e.update(phase("4i sampling", phase_sampling, params))
    e2e.update(phase("4b formats", phase_formats))
    e2e.update(phase("4c gemma2", phase_gemma2))
    bloom_e2e, bloom_params = phase("4d bloom", phase_bloom)
    e2e.update(bloom_e2e)
    e2e.update(phase("6b bloom server", phase_bloom_server, bloom_params))
    del bloom_params
    torch.cuda.empty_cache()
    e2e.update(phase("4e chatglm", phase_chatglm))
    e2e.update(phase("4f mistral gptq", phase_mistral_gptq))
    e2e.update(phase("4g formats", phase_formats,
                     ("int6_g128_a8", "mix_i2_ffn")))
    e2e.update(phase("4h tinyllama", phase_tinyllama))
    worst, sched_worst, fused_worst, formats_worst = phase(
        "5 card vs plain", phase_card_vs_plain)
    gemma2_worst = phase("5b gemma2 card vs plain",
                         phase_gemma2_card_vs_plain)
    zoo_worst = phase("5c zoo card vs plain", phase_zoo_card_vs_plain)
    copies_worst = phase("5d copies card vs plain",
                         phase_copies_card_vs_plain)
    e2e.update(phase("6 server", phase_server, params))
    e2e.update(phase("6c serving beyond greedy", phase_serving_beyond_greedy,
                     params))
    del params
    torch.cuda.empty_cache()

    kernels = []
    for kid, (kname, src, repl) in KERNEL_META.items():
        r = results[kid]
        err = max(c["err"] for c in r.get("cases", {"": r}).values())
        by_path = {p: c[kname] for p, c in LAUNCHES.items() if c[kname]}
        if not by_path:
            raise AssertionError(f"{kname} was launched on no main path")
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "per": r["per"], "ok": True,
            **({"chain_ms": r["chain_ms"]} if "chain_ms" in r else {}),
            **({"cases": r["cases"]} if "cases" in r else {})})
    log(json.dumps({"e2e": e2e, "copy_tb_s": bw / 1e12,
                    "card_vs_plain_rel_err": worst,
                    "sched_card_vs_plain_rel_err": sched_worst,
                    "formats_card_vs_plain_rel_err": formats_worst,
                    **fused_worst,
                    **gemma2_worst, **zoo_worst, **copies_worst,
                    "window_over_no_window": window,
                    "k1_reruns": K1_RERUN,
                    "k16_slower": K16_SLOWER,
                    "option_on_over_off": branches,
                    "phase_seconds": seconds,
                    "seconds": time.time() - t_start}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
