"""Where K2's and K5's tile time goes on the card.

Each kernel is built from its source as it is, and from copies with one
part of its tile loop taken out (K5: the dequant, the wgmma; K2: the
widening, the fold, the wgmma), and each build is timed at a Llama-2-7B
product shape (4096 x 4096). A copy without a part computes wrong numbers:
only its time is read, beside the whole kernel's, which is also held
against its plain version. The difference is what that part costs where
it does not overlap the rest.

    python3 scripts/k25_variants.py        # on the machine with the card

Writes its table to standard output. Builds go to the git-ignored
``build/neural_tpu_torch/variants/``.
"""
import ctypes
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as c  # noqa: E402
from neural_tpu_torch.core.dtypes import PRESETS, QuantConfig  # noqa: E402
from neural_tpu_torch.core.qtensor import quantize, to_native  # noqa: E402
from neural_tpu_torch.ops import _cuda  # noqa: E402
from neural_tpu_torch.ops import qmatmul as Q  # noqa: E402

OUT = os.path.join(ROOT, "build", "neural_tpu_torch", "variants")

# the parts of each loop, as (text in the source, what replaces it)
K5_PARTS = {
    "dequant": ("    tc_dequant<L>(p, st, ops + (kt % 3) * OP_BYTES, k0, k1, "
                "n_base, lut,\n                  tid);\n", ""),
    "wgmma": ("        qmm_tc::wgmma_bf16_n128(acc[i], qmm_tc::desc_sw128(a0), "
              "db, 1);", ""),
}
K2_PARTS = {
    "widen": ("    widen<LAYOUT>(st, ops + (kt % 3) * OP_BYTES, tid);", ""),
    "fold": ("      fold_group(prev, sa_prev, fold[(G - 1) % 3]);", ""),
    "wgmma": ("      qmm_tc::wgmma_s8_n128(cur, qmm_tc::desc_sw128(a0 + 32 * s),"
              "\n                            qmm_tc::desc(b0 + 256 * s, 128, "
              "SBO),\n                            (t > 0 || s > 0) ? 1 : 0);",
              ""),
}
K5_VARIANTS = ((), ("dequant",), ("wgmma",), ("dequant", "wgmma"))
K2_VARIANTS = ((), ("fold",), ("widen",), ("wgmma",),
               ("fold", "widen", "wgmma"))


def variant(kernel, parts, table):
    """The source of ``kernel`` without ``parts``, built into OUT; returns
    (name, nvcc process, library path)."""
    name = kernel.name + ("-no-" + "-".join(parts) if parts else "")
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    text = open(os.path.join(_cuda.CSRC, kernel.source)).read()
    for part in parts:
        old, new = table[part]
        if old not in text:
            raise AssertionError(f"{kernel.source}: the {part} text is gone")
        text = text.replace(old, new)
    for header in kernel.headers:
        with open(os.path.join(d, header), "w") as f:
            f.write(open(os.path.join(_cuda.CSRC, header)).read())
    src = os.path.join(d, kernel.source)
    with open(src, "w") as f:
        f.write(text)
    lib = src[:-3] + ".so"
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib, src]
    return name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True), lib


def use(kernel, lib):
    """Make ``kernel``'s wrapper launch the library at ``lib``."""
    h = ctypes.CDLL(lib)
    for fn, argtypes in kernel.functions.items():
        f = getattr(h, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    kernel._lib = h


def main():
    if not torch.cuda.is_available():
        print("k25_variants: no CUDA device", file=sys.stderr)
        sys.exit(2)
    print(c.smi_line(), flush=True)
    t = time.time()
    builds = [(_cuda.QMM_GENERAL, p, variant(_cuda.QMM_GENERAL, p, K5_PARTS))
              for p in K5_VARIANTS]
    builds += [(_cuda.QMM_A8, p, variant(_cuda.QMM_A8, p, K2_PARTS))
               for p in K2_VARIANTS]
    for _, _, (name, proc, _) in builds:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out[-3000:]}")
    print(f"built {len(builds)} variants in {time.time() - t:.1f} s",
          flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    K = N = 4096
    w = lambda cfg: to_native(quantize(
        torch.randn((K, N), generator=gen, device="cuda") * 0.02, cfg))
    x = lambda M: torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    k5_cases = [("K5 nf4 M=1975", w(PRESETS["nf4"]), x(1975)),
                ("K5 q4_0 M=1975", w(PRESETS["q4_0"]), x(1975)),
                ("K5 q4_j M=128", w(PRESETS["q4_j"]), x(128))]
    q = w(QuantConfig(bits=4, group_size=128, sym=True, act_bits=8))
    k2_cases = [("K2 q4_j M=1975", q, x(1975))]
    a8 = lambda xx, qt, odt: Q.qmm_a8(xx, qt.planes[0], qt.scales, 128, 128,
                                      odt, qt.zeros, 4)
    a8p = lambda xx, qt, odt: Q.qmm_a8_plain(xx, qt.planes[0], qt.scales,
                                             128, 128, odt, qt.zeros, 4)
    for kernel, parts, (name, _, lib) in builds:
        use(kernel, lib)
        five = kernel is _cuda.QMM_GENERAL
        fn = Q.qmm_general if five else a8
        plain = Q.qmm_general_plain if five else a8p
        for label, qt, xx in (k5_cases if five else k2_cases):
            ms = c.time_ms([lambda: fn(xx, qt, torch.bfloat16)])
            check = ""
            if not parts:
                err = (fn(xx, qt, torch.float32)
                       - plain(xx, qt, torch.float32)).abs().max().item()
                check = f"; max |kernel - plain| {err:.3g} (f32 out)"
            print(f"{label:16s} {'without ' + ', '.join(parts) if parts else 'whole kernel':32s}"
                  f" {ms * 1e3:8.1f} us{check}", flush=True)


if __name__ == "__main__":
    main()
