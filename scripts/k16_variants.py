"""Where K1's and K6's time goes on the card.

Each kernel is built from its source as it is, and from copies with one
part taken out, and each build is timed at the Llama-2-7B decode shapes:
K1 over q4_j nibbles at one 4096 x 4096 product (M = 1 and 8), at gate/up
(4096 x 11264, M = 1) and with the RMS-norm prologue at M = 8; K6 at the
server's batch-8 step (32 heads of 128, page 256, mixed fills; bf16 and
int8 pools) and at 32 heads over 2 and 48 over 1 (G > 8). The parts:

- K1 ``convert``: each code taken as raw bits instead of its centered
  value (no conversion instructions at all);
- K1 ``loads``: the weight plane is not read (each thread's words come
  from its indices; with TMA, no copy is issued and the stage's barrier is
  released at once);
- K1 ``merge``: the K splits are not added (the second launch, or the
  last block's merge, is left out);
- K6 ``groups``: the grid's third dimension (the query heads of a KV head,
  a group a block) cut to one group, so every KV head is read once.

A copy without a part computes wrong numbers: only its time is read,
beside the whole kernel's, which is also held against its plain version.
The difference is what that part costs where it does not overlap the rest.

    python3 scripts/k16_variants.py               # this tree's kernels
    python3 scripts/k16_variants.py --tree DIR    # another checkout's

``--tree`` imports the package and ``chip_smoke.py`` of an unpacked
checkout (``git archive <commit> | tar -x -C DIR``) and builds its
sources, so an earlier kernel's parts are timed by the same cases. Writes
its table to standard output; builds go to the git-ignored
``build/neural_tpu_torch/variants/`` of that tree.
"""
import argparse
import ctypes
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (part, [(text in a source or header, what replaces it), ...]): the texts
# of the earlier bodies (qmm4_npack.cu, decode_attn.cuh) and of their
# redesign (qmm4_npack.cu, decode_body.cuh); a part is applied where its
# text is found, and a part found nowhere is an error
PARTS = {
    "convert": [
        ("for (int f = 0; f < R; ++f) v[f] = Fields<CODE>::at(byte, f);",
         "for (int f = 0; f < R; ++f) v[f] = __uint_as_float(byte | "
         "0x3f800000u);"),
        ("Codes<CODE>::frag(wd[h], j, a[h]);",
         "for (int e = 0; e < 4; ++e) a[h][e] = word(wd[h][e % C::NW], "
         "j / 2) >> e;"),
    ],
    "loads": [
        ("const uint4 w = __ldg(reinterpret_cast<const uint4*>(wp + "
         "(size_t)r * N));",
         "const uint4 w = make_uint4(r, n0, k0, (uint32_t)(size_t)wp);"),
        ("qmm_tc::mbar_expect(&full[s], SB);",
         "qmm_tc::mbar_arrive(&full[s]);"),
        ("qmm_tc::tma_load(ring + s * SB,", "if (false) "
         "qmm_tc::tma_load(ring + s * SB,"),
    ],
    "merge": [
        ("  qmm4_reduce<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(\n"
         "      part, out, f.res, splits, MN, out_f32);\n", ""),
        ("if (n < p.N) merge_tile(p, n);", "if (false) merge_tile(p, n);"),
    ],
    "groups": [
        ("(G + MAXG - 1) / MAXG), 128, 0, st>>>", "1), 128, 0, st>>>"),
        ("(G + SM::MP - 1) / SM::MP), THREADS,", "1), THREADS,"),
    ],
}
K1_VARIANTS = ((), ("convert",), ("loads",), ("merge",),
               ("convert", "loads"))
K6_VARIANTS = ((), ("groups",))


def variant(root, kernel, parts, nvcc, flags):
    """The source of ``kernel`` (and its headers) without ``parts``, built
    under ``root``'s build directory; returns (name, nvcc process, library
    path)."""
    name = kernel.name + ("-no-" + "-".join(parts) if parts else "")
    out = os.path.join(root, "build", "neural_tpu_torch", "variants", name)
    os.makedirs(out, exist_ok=True)
    csrc = os.path.join(root, "neural_tpu_torch", "csrc")
    files = {f: open(os.path.join(csrc, f)).read()
             for f in (kernel.source, *kernel.headers)}
    for part in parts:
        hit = False
        for old, new in PARTS[part]:
            for f, text in files.items():
                if old in text:
                    files[f] = text.replace(old, new)
                    hit = True
        if not hit:
            raise AssertionError(f"{kernel.source}: no text of the part "
                                 f"{part!r}")
    for f, text in files.items():
        with open(os.path.join(out, f), "w") as fh:
            fh.write(text)
    src = os.path.join(out, kernel.source)
    lib = src[:-3] + ".so"
    cmd = [nvcc, *flags, "-o", lib, src]
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


def cases(c, torch, Q, PA, quantize, to_native, PRESETS, _cuda):
    """(label, kernel, runs, plain) at the main shapes, inputs from a
    seed; ``runs`` are closures over copies of the weights or the pool
    that defeat the 50 MB L2."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for M, K, N, rms in ((1, 4096, 4096, False), (8, 4096, 4096, False),
                         (1, 4096, 11264, False), (8, 4096, 11264, True)):
        qt = to_native(quantize(torch.randn((K, N), generator=gen,
                                            device="cuda") * 0.02,
                                PRESETS["q4_j"]))
        n = c._copies(qt.planes[0].numel())
        ws = [(qt.planes[0].clone(), qt.scales.clone()) for _ in range(n)]
        x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
        if rms:
            nw = (1 + 0.3 * torch.randn(K, generator=gen,
                                        device="cuda")).bfloat16()
            norm = (nw, 1e-5, 0.0)
            run = lambda w: Q.qmm_native_fused(x, w[0], w[1], 128, 4,
                                               torch.bfloat16, norm=norm)
            plain = lambda w=ws[0]: Q.qmm_native_fused_plain(
                x, w[0], w[1], 128, 4, torch.bfloat16, norm=norm)
            label = f"K1 rms M={M} {K}x{N}"
        else:
            run = lambda w: Q.qmm_native(x, w[0], w[1], None, 128, 4,
                                         torch.bfloat16)
            plain = lambda w=ws[0]: Q.qmm_native_plain(
                x, w[0], w[1], None, 128, 4, torch.bfloat16)
            label = f"K1 M={M} {K}x{N}"
        out.append((label, _cuda.QMM4, [lambda w=w, r=run: r(w) for w in ws],
                    plain))
    cpu = torch.Generator().manual_seed(6)
    fills, ps, D = [1, 2048, 1975, 128, 700, 1300, 33, 1024], 256, 128
    B, maxp = len(fills), 2048 // ps
    P = B * maxp + 1
    table = torch.randperm(P - 1, generator=cpu)[:B * maxp] \
        .reshape(B, maxp).to(torch.int32).to("cuda")
    lengths = torch.tensor(fills, dtype=torch.int32, device="cuda")
    for what, Hq, Hkv, int8s in (("server step", 32, 32, (False, True)),
                                 ("32 over 2", 32, 2, (False,)),
                                 ("48 over 1", 48, 1, (False,))):
        for int8 in int8s:
            q = (torch.randn((B, Hq, D), generator=gen, device="cuda")
                 * c.Q_SPREAD).bfloat16()
            kv = c._attn_cache(gen, (P, Hkv, ps, D), int8)[0]
            fn = PA.paged_decode_i8 if int8 else PA.paged_decode
            args = (q, kv[0], kv[1], *(kv[2:] if int8 else ()), table,
                    lengths, D ** -0.5)
            out.append((f"K6 {what}{' int8' if int8 else ''}",
                        _cuda.PAGED_DECODE, [lambda a=args, f=fn: f(*a)],
                        lambda q=q, kv=kv: PA.paged_decode_plain(
                            q, *kv, table, lengths, D ** -0.5)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    root = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("k16_variants: no CUDA device", file=sys.stderr)
        sys.exit(2)
    import chip_smoke as c
    from neural_tpu_torch.core.dtypes import PRESETS
    from neural_tpu_torch.core.qtensor import quantize, to_native
    from neural_tpu_torch.ops import _cuda
    from neural_tpu_torch.ops import paged_attention as PA
    from neural_tpu_torch.ops import qmatmul as Q
    print(c.smi_line(), flush=True)
    print(f"tree: {root}", flush=True)
    t = time.time()
    builds = [(k, p, variant(root, k, p, _cuda._nvcc(), _cuda.NVCC_FLAGS))
              for k, vs in ((_cuda.QMM4, K1_VARIANTS),
                            (_cuda.PAGED_DECODE, K6_VARIANTS)) for p in vs]
    for _, _, (name, proc, _) in builds:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out[-3000:]}")
    print(f"built {len(builds)} variants in {time.time() - t:.1f} s",
          flush=True)
    todo = cases(c, torch, Q, PA, quantize, to_native, PRESETS, _cuda)
    for kernel, parts, (name, _, lib) in builds:
        use(kernel, lib)
        for label, k, runs, plain in todo:
            if k is not kernel:
                continue
            if parts == ("groups",) and "over" not in label:
                continue
            ms = c.time_ms(runs)
            check = ""
            if not parts:
                err = (runs[0]().float() - plain().float()).abs().max()
                check = f"; max |kernel - plain| {err.item():.3g}"
            what = "without " + ", ".join(parts) if parts else "whole kernel"
            print(f"{label:24s} {what:28s} {ms * 1e3:9.2f} us{check}",
                  flush=True)


if __name__ == "__main__":
    main()
