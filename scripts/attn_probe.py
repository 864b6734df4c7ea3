"""A first look at K3 and K4 on the card: their build with ptxas's report,
each held against its plain version over its branches, and their time at
the main shapes.

    python3 scripts/attn_probe.py         # on the machine with the card

Builds ``flash_prefill.cu`` and ``flash_decode.cu`` with ``-Xptxas -v``
(the report goes to the git-ignored ``build/neural_tpu_torch/probe/``; its
register, spill and warning lines to standard output), then runs the
checks and the timings each in a child process with a time limit, so that
a kernel that hangs (a mis-set mbarrier count or phase waits forever) is
killed and reported instead of holding the card. Each check prints one
``CASE`` line: the case, the largest |kernel - plain| and whether the
output is finite. The timings are ``chip_smoke.time_ms`` of one launch.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (kernel, B, T, Hq, Hkv, S, head dim, start, fill, int8, softcap, window,
# ALiBi, prefix length): every branch, small and at the main shapes
CASES = [
    ("K3", 1, 200, 4, 2, 256, 128, 0, 0, False, 0.0, 0, False, 0),
    ("K3", 1, 200, 4, 2, 256, 128, 0, 0, True, 0.0, 0, False, 0),
    ("K3", 1, 200, 4, 2, 256, 256, 0, 0, False, 0.0, 0, False, 0),
    ("K3", 1, 200, 4, 2, 256, 256, 0, 0, True, 0.0, 0, False, 0),
    ("K3", 2, 300, 4, 4, 1000, 128, 500, 0, False, 0.0, 0, False, 0),
    ("K3", 2, 300, 4, 4, 1000, 128, 500, 0, True, 0.0, 0, False, 0),
    ("K3", 1, 700, 4, 2, 800, 256, 0, 0, False, 50.0, 256, False, 0),
    ("K3", 1, 700, 4, 2, 800, 256, 0, 0, True, 50.0, 256, False, 0),
    ("K3", 1, 700, 4, 4, 800, 128, 0, 0, False, 0.0, 0, True, 0),
    ("K3", 1, 700, 4, 4, 800, 128, 0, 0, False, 0.0, 0, False, 700),
    ("K3", 1, 700, 4, 4, 800, 128, 0, 0, True, 0.0, 0, True, 0),
    ("K3", 1, 700, 4, 4, 800, 128, 0, 0, True, 0.0, 0, False, 700),
    ("K3", 1, 1975, 32, 32, 2048, 128, 0, 0, False, 0.0, 0, False, 0),
    ("K3", 1, 1975, 32, 32, 2048, 128, 0, 0, True, 0.0, 0, False, 0),
    ("K3", 1, 512, 32, 32, 2048, 128, 1024, 0, False, 0.0, 0, False, 0),
    ("K4", 1, 1, 4, 4, 256, 128, 0, 200, False, 0.0, 0, False, 0),
    ("K4", 1, 1, 4, 4, 256, 128, 0, 200, True, 0.0, 0, False, 0),
    ("K4", 1, 1, 8, 2, 512, 256, 0, 300, False, 0.0, 0, False, 0),
    ("K4", 1, 1, 8, 2, 512, 256, 0, 300, True, 0.0, 0, False, 0),
    ("K4", 3, 1, 8, 8, 700, 128, 0, 650, False, 50.0, 200, False, 0),
    ("K4", 3, 1, 8, 8, 700, 128, 0, 650, True, 50.0, 200, False, 0),
    ("K4", 1, 1, 32, 32, 2048, 128, 0, 1975, False, 0.0, 0, True, 0),
    ("K4", 1, 1, 32, 32, 2048, 128, 0, 1975, True, 0.0, 0, True, 0),
    ("K4", 1, 1, 32, 2, 2048, 128, 0, 1975, False, 0.0, 0, False, 0),
    ("K4", 1, 1, 32, 2, 2048, 128, 0, 1975, True, 0.0, 0, False, 0),
    ("K4", 1, 1, 48, 1, 2048, 128, 0, 1975, False, 0.0, 0, False, 0),
    ("K4", 1, 1, 48, 1, 2048, 128, 0, 1975, True, 0.0, 0, False, 0),
    ("K4", 1, 1, 16, 8, 8192, 256, 0, 6000, False, 50.0, 4096, False, 0),
    ("K4", 1, 1, 16, 8, 8192, 256, 0, 6000, True, 50.0, 4096, False, 0),
    ("K4", 1, 1, 32, 32, 2048, 128, 0, 128, False, 0.0, 0, False, 0),
]
# K3: (T, S, start, Hq, Hkv, head dim, softcap, window, ALiBi); K4: (fill,
# Hq, Hkv, S, head dim, softcap, window, ALiBi)
K3_TIMES = [(1975, 2048, 0, 32, 32, 128, 0.0, 0, False),
            (1975, 2048, 0, 32, 32, 128, 0.0, 0, True),
            (512, 2048, 1024, 32, 32, 128, 0.0, 0, False),
            (6000, 8192, 0, 16, 8, 256, 50.0, 4096, False),
            (6000, 8192, 0, 16, 8, 256, 50.0, 0, False)]
K4_TIMES = [(1975, 32, 32, 2048, 128, 0.0, 0, False),
            (1975, 32, 32, 2048, 128, 0.0, 0, True),
            (128, 32, 32, 2048, 128, 0.0, 0, False),
            (1975, 32, 2, 2048, 128, 0.0, 0, False),
            (1975, 48, 1, 2048, 128, 0.0, 0, False),
            (6000, 16, 8, 8192, 256, 50.0, 4096, False),
            (6000, 16, 8, 8192, 256, 50.0, 0, False)]


def ptxas():
    """Each attention source built with ptxas's report."""
    from neural_tpu_torch.ops import _cuda
    out_dir = os.path.join(ROOT, "build", "neural_tpu_torch", "probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for src in ("flash_prefill.cu", "flash_decode.cu"):
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               os.path.join(out_dir, src + ".so"),
               os.path.join(_cuda.CSRC, src)]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    for src, proc in procs:
        out, _ = proc.communicate()
        with open(os.path.join(out_dir, f"ptxas_{src}.txt"), "w") as f:
            f.write(out)
        print(f"== {src}: nvcc exit {proc.returncode}")
        print("\n".join(line for line in out.splitlines()
                        if any(w in line for w in ("error", "warning",
                                                   "registers", "spill"))))


def _cache(gen, shape, int8):
    import torch
    from neural_tpu_torch.ops import attention as A
    k = torch.randn(shape, generator=gen, device="cuda")
    v = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
    if int8:
        (k, ks), (v, vs) = A.quantize_kv(k), A.quantize_kv(v)
        return (k, v, ks, vs)
    return (k.bfloat16(), v.bfloat16())


def check():
    """Every case against its plain version, one CASE line each."""
    import torch
    from neural_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case in CASES:
        kind, B, T, Hq, Hkv, S, D, start, fill, int8, cap, W, ali, pre = case
        try:
            slopes = torch.rand(Hq, generator=gen, device="cuda") * 0.5 \
                if ali else None
            kv = _cache(gen, (B, Hkv, S, D), int8)
            if kind == "K3":
                q = torch.randn((B, T, Hq, D), generator=gen, device="cuda")
                pos = torch.full((B,), start, dtype=torch.int32,
                                 device="cuda")
                prefix = torch.full((B,), pre, dtype=torch.int32,
                                    device="cuda") if pre else None
                fn = A.flash_prefill_i8 if int8 else A.flash_prefill
                pf = A.flash_prefill_i8_plain if int8 else \
                    A.flash_prefill_plain
                args = ((q * 4).bfloat16(), *kv, pos, D ** -0.5, cap, W,
                        slopes, prefix)
            else:
                q = torch.randn((B, Hq, D), generator=gen, device="cuda")
                pos = torch.tensor([max(1, fill - 37 * i) for i in range(B)],
                                   dtype=torch.int32, device="cuda")
                fn = A.flash_decode_i8 if int8 else A.flash_decode
                pf = A.flash_decode_i8_plain if int8 else \
                    A.flash_decode_plain
                args = ((q * 4).bfloat16(), *kv, pos, D ** -0.5, cap, W,
                        slopes)
            out = fn(*args)
            torch.cuda.synchronize()
            res = [(out - pf(*args)).abs().max().item(),
                   bool(torch.isfinite(out).all())]
        except Exception as e:     # reported, and the next case runs
            res = [repr(e)[:300], False]
        print("CASE", json.dumps([case] + res), flush=True)


def times():
    """Each kernel at the main shapes (K4 over 4 copies of its cache)."""
    import torch
    import chip_smoke as c
    from neural_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(1)
    print(c.smi_line())
    for int8 in (False, True):
        for T, S, start, Hq, Hkv, D, cap, W, ali in K3_TIMES:
            slopes = torch.rand(Hq, device="cuda") * 0.5 if ali else None
            kv = _cache(gen, (1, Hkv, S, D), int8)
            q = (torch.randn((1, T, Hq, D), generator=gen, device="cuda")
                 * 4).bfloat16()
            pos = torch.full((1,), start, dtype=torch.int32, device="cuda")
            fn = A.flash_prefill_i8 if int8 else A.flash_prefill
            ms = c.time_ms([lambda: fn(q, *kv, pos, D ** -0.5, cap, W,
                                       slopes)])
            ops = 4 * D * Hq * sum(min(start + t + 1, W or 1 << 30)
                                   for t in range(T))
            print(f"K3 int8={int8} T={T} S={S} start={start} D={D} W={W} "
                  f"alibi={ali}: {ms:.4f} ms, "
                  f"{ops / (ms * 1e-3) / 1e12:.0f} TFLOP/s")
        for fill, Hq, Hkv, S, D, cap, W, ali in K4_TIMES:
            slopes = torch.rand(Hq, device="cuda") * 0.5 if ali else None
            caches = [_cache(gen, (1, Hkv, S, D), int8) for _ in range(4)]
            q = (torch.randn((1, Hq, D), generator=gen, device="cuda")
                 * 4).bfloat16()
            lengths = torch.full((1,), fill, dtype=torch.int32,
                                 device="cuda")
            fn = A.flash_decode_i8 if int8 else A.flash_decode
            pf = A.flash_decode_i8_plain if int8 else A.flash_decode_plain
            ms = c.time_ms([lambda kv=kv: fn(q, *kv, lengths, D ** -0.5,
                                             cap, W, slopes)
                            for kv in caches])
            args = (q, *caches[1], lengths, D ** -0.5, cap, W, slopes)
            err = (fn(*args) - pf(*args)).abs().max().item()
            nbytes = 2 * min(fill, W or fill) * Hkv * D * (1 if int8 else 2)
            print(f"K4 int8={int8} fill={fill} Hq={Hq} Hkv={Hkv} D={D} "
                  f"W={W} alibi={ali}: {ms * 1e3:.2f} us, "
                  f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s; err after the "
                  f"replays {err:.3g}")


def child(what, timeout):
    """Run this file's ``what`` in a process of its own."""
    try:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            what], capture_output=True, text=True,
                           timeout=timeout, cwd=ROOT)
        print(p.stdout[-8000:], p.stderr[-3000:], sep="\n", flush=True)
        return p.returncode
    except subprocess.TimeoutExpired:
        print(f"{what}: killed after {timeout} s", flush=True)
        return 1


def main():
    import torch
    if not torch.cuda.is_available():
        print("attn_probe: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:] == ["--check"]:
        return check()
    if sys.argv[1:] == ["--times"]:
        return times()
    ptxas()
    from neural_tpu_torch.ops import _cuda
    _cuda.build_all([_cuda.FLASH_PREFILL, _cuda.FLASH_DECODE])
    sys.exit(child("--check", 300) or child("--times", 300))


if __name__ == "__main__":
    main()
