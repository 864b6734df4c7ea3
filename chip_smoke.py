"""Smoke run of the PyTorch / CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi), and a measured
   device-to-device copy rate;
2. build: the four kernels of ``neural_tpu_torch/csrc`` from source;
3. kernels: each kernel against its plain PyTorch version on the same CUDA
   tensors at the Llama-2-7B q4_j main-path shapes, with its time, the
   plain version's time, one library call's time (a yardstick the port
   never calls) and its bound;
4. main path: a Llama-2-7B-shaped q4_j model (random weights from a seed,
   FFN 11008 padded to 11264) generates greedily through ``Model.generate``
   with every kernel's launch count set to 0 just before and read just
   after; then decode ms/token (slope of ``decode_loop`` n=4 vs n=36) at
   fills 128 and 1975, and the 1975-token prefill time (TTFT);
5. card vs plain: a 2-layer copy at the same width runs its prefill logits
   and greedy steps through the kernels on the card and through the plain
   path on the CPU; logits within tolerance, greedy ids equal.

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
from neural_tpu_torch.core.dtypes import PRESETS  # noqa: E402
from neural_tpu_torch.core.qtensor import (dequantize, quantize,  # noqa: E402
                                           to_native_packed)
from neural_tpu_torch.models.config import ModelConfig  # noqa: E402
from neural_tpu_torch.ops import _cuda  # noqa: E402
from neural_tpu_torch.ops import attention as A  # noqa: E402
from neural_tpu_torch.ops import qmatmul as Q  # noqa: E402
from neural_tpu_torch.runtime.generate import (decode_loop,  # noqa: E402
                                               greedy_generate, model_step,
                                               prefill_step)
from neural_tpu_torch.runtime.kvcache import init_cache  # noqa: E402

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
    b, o = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


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


def check_k1(gen, results):
    """Decode products at M=1: q/k/v/o, gate/up, down and the lm_head."""
    shapes = [(D, D, 4 * L, torch.bfloat16), (D, I_PAD, 2 * L, torch.bfloat16),
              (I_PAD, D, L, torch.bfloat16), (D, V, 1, torch.float32)]
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0)
    for K, N, count, odt in shapes:
        nbytes = K * N // 2 + K // 128 * N * 2
        ws = _qweight(K, N, gen, _copies(nbytes))
        x = torch.randn((1, K), generator=gen, device=DEV).bfloat16()
        planes, scales, qt = ws[0]
        out = Q.qmm4_npack(x, planes, scales, 128, odt)
        ref = Q.qmm4_npack_plain(x, planes, scales, 128, odt)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = (1e-2 if odt == torch.bfloat16 else 1e-4) * scale
        if not err <= tol:
            raise AssertionError(f"K1 {K}x{N}: max err {err} > tol {tol}")
        ms = time_ms([lambda p=p, s=s: Q.qmm4_npack(x, p, s, 128, odt)
                      for p, s, _ in ws])
        pms = time_ms([lambda: Q.qmm4_npack_plain(x, planes, scales, 128,
                                                  odt)], reps=5)
        wd = dequantize(qt, torch.bfloat16)
        wds = [wd] + [wd.clone() for _ in range(_copies(K * N * 2) - 1)]
        lms = time_ms([lambda w=w: torch.matmul(x, w) for w in wds])
        del wds, wd
        bnd, by = bound_ms(nbytes + K * 2 + N * (2 if odt == torch.bfloat16
                                                 else 4), 2 * K * N,
                           F32_FLOPS)
        log(f"K1 qmm4_npack M=1 {K}x{N} x{count}/token: err {err:.3g} "
            f"(tol {tol:.3g}) | kernel {ms:.4f} ms, plain {pms:.3f} ms, "
            f"torch.matmul bf16 {lms:.4f} ms, bound {bnd:.4f} ms ({by}); "
            f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s of weights")
        for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                     ("bound_ms", bnd)):
            agg[k] += count * v
        agg["err"] = max(agg["err"], err)
        del ws
    results["K1"] = dict(agg, bound_by="bytes", per="decode token "
                         "(225 launches)")


def check_k2(gen, results):
    """Prefill products at M=1975 through the int8-activation path."""
    M = T_PREFILL
    shapes = [(D, D, 4 * L), (D, I_PAD, 2 * L), (I_PAD, D, L)]
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0)
    for K, N, count in shapes:
        planes, scales, qt = _qweight(K, N, gen)[0]
        x = torch.randn((M, K), generator=gen, device=DEV).bfloat16()
        xq, sa = Q.act_quant_i8(x, 128)
        rq, rsa = Q.quantize_act_i8(x, 128)
        if not (torch.equal(xq, rq) and torch.equal(sa, rsa)):
            raise AssertionError(f"K2 act quant codes differ at {M}x{K}")
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
        bnd, by = bound_ms(nbytes, 4 * DH * H * fill, F32_FLOPS)
        log(f"K4 flash_decode fill={fill} S={S} H={H} x{L}/token: err "
            f"{err:.3g} (tol {tol}) | kernel {ms:.4f} ms, plain {pms:.3f} "
            f"ms, sdpa {lms:.4f} ms, bound {bnd:.4f} ms ({by}); "
            f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
        del kvs
    results["K4"] = dict(ms=L * ms, plain_ms=L * pms, library_ms=L * lms,
                         bound_ms=L * bnd, bound_by=by, err=err,
                         per="decode token at fill 1975 (32 launches)")


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------


def phase_main_path():
    t0 = time.time()
    params = init_random(CFG, seed=0, quant="q4_j", device=DEV)
    torch.cuda.synchronize()
    log(f"init_random Llama-2-7B q4_j on the card: {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    model = Model().init_params(params, CFG)
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(3, V, (n,), generator=gen).tolist()
               for n in (64, 512)]
    for kern in _cuda.KERNELS:
        kern.launches = 0
    outs = [model.generate(p, max_new_tokens=16, do_sample=False,
                           stop_at_eos=False)[0] for p in prompts]
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _cuda.KERNELS}
    log(f"main path: Model.generate greedy, prompts of 64 and 512 tokens, 16 "
        f"new each; launches {launches}")
    for p, o in zip(prompts, outs):
        new = o[len(p):]
        if len(new) != 16 or not all(0 <= t < V for t in new):
            raise AssertionError(f"bad generated ids {new}")
        log(f"  prompt {len(p)}: new ids {new}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

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

    def decode_ms(fill, lo=4, hi=36):
        token = torch.full((1, 1), 17, dtype=torch.long, device=DEV)

        def run(n):
            cache = init_cache(CFG, 1, S_CACHE, device=DEV)
            pos = torch.full((1,), fill, dtype=torch.long, device=DEV)
            torch.cuda.synchronize()
            t = time.perf_counter()
            decode_loop(params, token, pos, cache, n)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        run(lo)
        t_lo = min(run(lo) for _ in range(3))
        t_hi = min(run(hi) for _ in range(3))
        return (t_hi - t_lo) / (hi - lo) * 1e3

    d128, d1975 = decode_ms(128), decode_ms(T_PREFILL)
    log(f"decode (slope n=4..36, batch 1, bf16 KV): fill 128 {d128:.3f} "
        f"ms/token ({1e3 / d128:.1f} tok/s), fill 1975 {d1975:.3f} ms/token "
        f"({1e3 / d1975:.1f} tok/s)")

    tokens = torch.randint(0, V, (1, T_PREFILL), generator=gen).to(DEV)
    start = torch.zeros(1, dtype=torch.long, device=DEV)

    def ttft():
        cache = init_cache(CFG, 1, S_CACHE, device=DEV)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = prefill_step(params, tokens, start, cache)
        torch.cuda.synchronize()
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite prefill logits")
        return (time.perf_counter() - t) * 1e3

    ttft()
    ms = min(ttft() for _ in range(3))
    log(f"TTFT 1975-token prefill (last-row logits): {ms:.2f} ms")
    del params, model
    torch.cuda.empty_cache()
    return launches, dict(decode_ms_fill128=d128, decode_ms_fill1975=d1975,
                          ttft_1975_ms=ms)


# ---------------------------------------------------------------------------
# phase 5: the card against the plain path on the CPU
# ---------------------------------------------------------------------------


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
    # logits of the prefill's last row and of n_new decode steps fed the
    # card's ids, on both sides
    # bf16 activations: last-bit differences (split-K order in K1, where K3
    # rounds P, the card's rsqrt/exp) move int8 activation codes of the
    # next K2 product by a step, and two layers amplify that; the tiny
    # model shows 1.8e-2 between the JAX package and the port on the CPU
    rel_tol = 5e-2
    caches = [init_cache(cfg2, 1, 320, device=d) for d in (DEV, "cpu")]
    logits = [prefill_step(m, torch.tensor([ids], device=c.k.device),
                           torch.zeros(1, dtype=torch.long,
                                       device=c.k.device), c)
              for m, c in zip((card, host), caches)]
    worst, provable, agree = 0.0, 0, True
    for step in range(n_new + 1):
        a, b = logits[0][0, -1].float().cpu(), logits[1][0, -1].float()
        err = (a - b).abs().max().item()
        tol = rel_tol * b.abs().max().item()
        worst = max(worst, err / b.abs().max().item())
        top2 = b.topk(2).values
        margin = (top2[0] - top2[1]).item()
        # the argmax provably agrees where the plain top-2 margin exceeds
        # twice this step's largest logit difference
        same = int(a.argmax()) == int(b.argmax())
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
        agree = agree and same
        if step == n_new:
            break
        tok = g_card[step]
        logits = [model_step(m, torch.tensor([[tok]], device=c.k.device),
                             torch.tensor([len(ids) + step],
                                          device=c.k.device), c)
                  for m, c in zip((card, host), caches)]
        if agree and g_host[step] != tok:
            raise AssertionError(f"free-running greedy ids differ at step "
                                 f"{step} while every argmax so far agreed")
    log(f"card vs plain (2 layers, full width, 300-token prompt): logits "
        f"max err {worst:.3g}·max|logit| (tol {rel_tol}); greedy card "
        f"{g_card}, plain {g_host}; argmax provably comparable at "
        f"{provable} of {n_new + 1} steps, equal at all of them")
    if provable < 3:
        raise AssertionError("too few steps with a margin wide enough to "
                             "compare the argmax")
    return worst


# ---------------------------------------------------------------------------


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    t_start = time.time()
    smi, name, bw = phase_device()
    build_s = _cuda.build_all(_cuda.KERNELS)
    for k in _cuda.KERNELS:
        k.load()
    log(f"built {[k.source for k in _cuda.KERNELS]} in {build_s:.1f} s")

    results = {}
    gen = torch.Generator(device=DEV).manual_seed(0)
    for check in (check_k1, check_k2, check_k3, check_k4):
        check(gen, results)
        torch.cuda.empty_cache()
    launches, e2e = phase_main_path()
    worst = phase_card_vs_plain()

    meta = {
        "K1": ("qmm4_npack", "neural_tpu_torch/csrc/qmm4_npack.cu",
               "neural_tpu/ops/qmatmul.py:619"),
        "K2": ("qmm_a8", "neural_tpu_torch/csrc/qmm_a8.cu",
               "neural_tpu/ops/qmatmul.py:161"),
        "K3": ("flash_prefill", "neural_tpu_torch/csrc/flash_prefill.cu",
               "neural_tpu/ops/attention.py:433"),
        "K4": ("flash_decode", "neural_tpu_torch/csrc/flash_decode.cu",
               "neural_tpu/ops/attention.py:110"),
    }
    kernels = []
    for kid, (kname, src, repl) in meta.items():
        r = results[kid]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[kname], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "per": r["per"], "ok": True})
    log(json.dumps({"e2e": e2e, "copy_tb_s": bw / 1e12,
                    "card_vs_plain_rel_err": worst,
                    "seconds": time.time() - t_start}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
