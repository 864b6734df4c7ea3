"""Where K3's and K4's time goes on the card.

Each kernel is built from its source as it is, and from copies with one
part of its loop taken out, and each build is timed at the Llama-2-7B main
shapes (K3: the 1975-token prefill, K4: decode at fill 1975 of 2048; bf16
and int8 KV) and at Gemma-2-9B's 6000-token prefill under the window. The
parts: the per-element mask, the online softmax, the PV product, and the
wait on the loads (the copies are not issued and each stage's barrier is
released at once, so the loop runs on whatever the ring holds). K4 is also
built with the merge of the splits always a second launch (``FOLD_HEADS``;
by default the last block of each row merges them up to 8 heads a KV
head). A copy
without a part computes wrong numbers: only its time is read, beside the
whole kernel's, which is also held against its plain version. The
difference is what that part costs where it does not overlap the rest.

    python3 scripts/attn_variants.py        # on the machine with the card

Writes its table to standard output. Builds go to the git-ignored
``build/neural_tpu_torch/variants/``.
"""
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as c  # noqa: E402
from k25_variants import use, variant  # noqa: E402
from neural_tpu_torch.ops import _cuda  # noqa: E402
from neural_tpu_torch.ops import attention as A  # noqa: E402

# the copies skip their loads: no bytes expected, no copy issued
NO_LOADS = [
    ("qmm_tc::mbar_expect(", "skip_expect("),
    ("qmm_tc::tma_load_3d(", "skip_load("),
    ('#include "qmm_tc.cuh"\n', '#include "qmm_tc.cuh"\n'
     "__device__ __forceinline__ void skip_expect(uint64_t* bar, uint32_t) "
     "{ qmm_tc::mbar_arrive(bar); }\n"
     "__device__ __forceinline__ void skip_load(void*, const CUtensorMap*, "
     "int, int, int, uint64_t*) {}\n"),
]


def _cut(begin, end, new=""):
    """Replace the text from `begin` up to (not including) `end`."""
    return ("cut", begin, end, new)


# the parts of each loop, as replacements in the source
K3_PARTS = {
    "mask": [("if (!interior(p, rg, k0, k0 + BKV, pm1)) {", "if (false) {")],
    "softmax": [_cut("      float mx_a = m_a, mx_b = m_b;",
                     "      if constexpr (I8) {   // the v scale",
                     "      alpha_a = alpha_b = 1.f;\n")],
    "pv": [("        wgmma_pv<D>(o, pa[kk],\n                    qmm_tc::"
            "desc_sw128_mn(vbase + kk * 16 * 128, BKV * 128));", "")],
    "wait": NO_LOADS,
}
K4_PARTS = {
    "mask": [("    if (edge) {\n", "    if (false) {\n")],
    "softmax": [_cut("    // online softmax over the tile, a warp per head",
                     "    __syncthreads();\n\n    if constexpr (I8) {")],
    "pv": [_cut("    if constexpr (I8) {\n      // f32 PV",
                "    __syncthreads();               // the stage is consumed")],
    "wait": NO_LOADS,
    "fold": [("constexpr int FOLD_HEADS = 8;",
              "constexpr int FOLD_HEADS = 0;")],
}
K3_VARIANTS = ((), ("mask",), ("softmax",), ("pv",), ("wait",))
K4_VARIANTS = ((), ("mask",), ("softmax",), ("pv",), ("wait",), ("fold",))


def _table(parts):
    """k25_variants.variant takes (old, new) pairs a part; a cut becomes
    the pair of the text it removes, read from the source."""
    def resolve(kernel):
        text = open(os.path.join(_cuda.CSRC, kernel.source)).read()
        out = {}
        for name, reps in parts.items():
            pairs = []
            for r in reps:
                if r[0] == "cut":
                    i = text.index(r[1])
                    pairs.append((text[i:text.index(r[2], i)], r[3]))
                else:
                    pairs.append(r)
            out[name] = pairs
        return out
    return resolve


def build(kernel, parts_list, table):
    """Each variant of `kernel` (one nvcc each, all at once)."""
    flat = {}
    for name, pairs in table.items():
        flat[name] = pairs
    builds = []
    for parts in parts_list:
        reps = {}
        for part in parts:
            for i, pair in enumerate(flat[part]):
                reps[f"{part}{i}"] = pair
        builds.append((parts, variant(kernel, tuple(reps), reps)))
    return builds


def cases():
    """(label, kernel, run, plain) at the main shapes, inputs from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    starts = torch.zeros(1, dtype=torch.int32, device="cuda")
    for int8 in (False, True):
        sfx = " int8" if int8 else ""
        for what, Hq, Hkv, Dh, S, T, cap, W in (
                ("llama 1975", 32, 32, 128, 2048, 1975, 0.0, 0),
                ("gemma2 6000 window", 16, 8, 256, 8192, 6000, 50.0, 4096)):
            q = (torch.randn((1, T, Hq, Dh), generator=gen, device="cuda")
                 * c.Q_SPREAD).bfloat16()
            kv = c._attn_cache(gen, (1, Hkv, S, Dh), int8)[0]
            args = (q, kv[0], kv[1], *(kv[2:] if int8 else ()), starts,
                    Dh ** -0.5, cap, W)
            fn = A.flash_prefill_i8 if int8 else A.flash_prefill
            pl = A.flash_prefill_i8_plain if int8 else A.flash_prefill_plain
            out.append((f"K3 {what}{sfx}", _cuda.FLASH_PREFILL,
                        [lambda a=args, f=fn: f(*a)],
                        lambda a=args, f=pl: f(*a)))
        for what, Hq, Hkv in (("llama fill 1975", 32, 32),
                              ("chatglm2 heads fill 1975", 32, 2)):
            caches = c._attn_cache(gen, (1, Hkv, 2048, 128), int8, 8)
            q = (torch.randn((1, Hq, 128), generator=gen, device="cuda")
                 * c.Q_SPREAD).bfloat16()
            ln = torch.full((1,), 1975, dtype=torch.int32, device="cuda")
            fn = A.flash_decode_i8 if int8 else A.flash_decode
            pl = A.flash_decode_i8_plain if int8 else A.flash_decode_plain
            args = [(q, kv[0], kv[1], *(kv[2:] if int8 else ()), ln,
                     128 ** -0.5) for kv in caches]
            out.append((f"K4 {what}{sfx}", _cuda.FLASH_DECODE,
                        [lambda a=a, f=fn: f(*a) for a in args],
                        lambda a=args[0], f=pl: f(*a)))
    return out


def main():
    if not torch.cuda.is_available():
        print("attn_variants: no CUDA device", file=sys.stderr)
        sys.exit(2)
    print(c.smi_line(), flush=True)
    t = time.time()
    builds = [(_cuda.FLASH_PREFILL, p, b) for p, b in build(
        _cuda.FLASH_PREFILL, K3_VARIANTS, _table(K3_PARTS)(_cuda.FLASH_PREFILL))]
    builds += [(_cuda.FLASH_DECODE, p, b) for p, b in build(
        _cuda.FLASH_DECODE, K4_VARIANTS, _table(K4_PARTS)(_cuda.FLASH_DECODE))]
    for _, _, (name, proc, _) in builds:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out[-3000:]}")
    print(f"built {len(builds)} variants in {time.time() - t:.1f} s",
          flush=True)
    todo = cases()
    for kernel, parts, (name, _, lib) in builds:
        use(kernel, lib)
        for label, k, runs, plain in todo:
            if k is not kernel:
                continue
            ms = c.time_ms(runs)
            check = ""
            if parts in ((), ("fold",)):
                err = (runs[0]() - plain()).abs().max().item()
                check = f"; max |kernel - plain| {err:.3g}"
            what = "without " + ", ".join(parts) if parts else "whole kernel"
            if parts == ("fold",):
                what = "merge always a second launch"
            print(f"{label:34s} {what:34s} {ms * 1e3:9.2f} us{check}",
                  flush=True)


if __name__ == "__main__":
    main()
