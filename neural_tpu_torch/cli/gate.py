"""The accuracy gate on the port: the accuracy leg of the JAX package's
``scripts/gate.py``, on the card unless ``--device cpu``.

    python -m neural_tpu_torch.cli.gate                     # gate
    python -m neural_tpu_torch.cli.gate --update --out r.json

A tiny fixed-seed Llama (:func:`gate_cfg`) with f32 parameters, drawn by the
JAX ``init_random``'s numpy rule (``convert.hf.init_random_numpy``) so that
both gates score the same weights, its lm_head scaled by ``AMP``; a corpus
the port samples from it (temperature 0.9; the port's own generator, so the
tokens are not the JAX gate's); the sliding-window perplexity of each
``GATED`` quantization of the same weights over that corpus, as a ratio to
the f32 model's. Each ratio is held against the committed
``baselines/accuracy.json`` (read, never written): more than ``--tol`` above
its baseline fails the gate (exit 1). ``--update`` writes the ratios to the
path given with ``--out`` instead. The JAX gate's ``--perf`` leg is not
here: it times the port's benchmark, which does not exist yet.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ACC_BASE = os.path.join(ROOT, "baselines", "accuracy.json")

# the gated quantizations, the JAX gate's
GATED = ["q4_0", "q4_j", "int8", "int4_g128_asym", "int3", "int5",
         "mix_int2_int4", "mix_i2_ffn"]
# the lm_head's amplification: an untrained model's distribution is near
# uniform (perplexity ≈ vocab at every width); scaling the head peaks it so
# that quantization damage shows. Exact at every config: RTN scales are
# linear, so quantize(AMP·W) has W's codes and AMP·scales
AMP = 8.0


def gate_cfg():
    """The JAX gate's model: intermediate 384 divides every gated width's
    pack chunk."""
    from ..models.config import ModelConfig
    return ModelConfig(arch="llama", vocab_size=256, hidden_size=128,
                       n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
                       intermediate_size=384, max_seq_len=1024,
                       eos_token_id=-1)


def quant_of(name: str):
    """A gated name → what the converter takes."""
    from ..core.dtypes import QuantConfig
    if name == "int4_g128_asym":
        return QuantConfig(bits=4, group_size=128, sym=False)
    return name


def gate_model(quant=None, seed: int = 0, device=None):
    """The gate's f32 model at ``quant`` (None: unquantized), its lm_head
    times ``AMP`` before it is quantized."""
    from ..convert.hf import ARCH_MODULES, build_params, init_random_numpy
    cfg = gate_cfg()
    mod = ARCH_MODULES[cfg.arch]
    sd = init_random_numpy(cfg, seed)
    head = mod.hf_top_map(cfg)["lm_head"][0]
    sd[head] = sd[head] * np.float32(AMP)
    return build_params(sd, cfg, mod, quant, torch.float32, device), cfg


def build_corpus(n_tokens: int = 768, seed: int = 0, device=None):
    """The f32 model and the corpus it samples: four rows of
    ``n_tokens / 4`` tokens from fixed first tokens."""
    from ..runtime.generate import batched_generate
    from ..runtime.sampling import SamplingParams
    params, cfg = gate_model(None, seed, device)
    rng = np.random.default_rng(seed)
    rows = [[int(t)] for t in rng.integers(1, 256, 4)]
    outs = batched_generate(
        params, cfg, rows,
        SamplingParams(greedy=False, temperature=0.9, top_k=0, top_p=1.0,
                       repeat_penalty=1.0, repeat_last_n=0),
        max_new_tokens=n_tokens // 4, seed=seed, stop_at_eos=False)
    return params, cfg, [t for o in outs for t in o]


def ppl(params, cfg, corpus) -> float:
    from ..eval.perplexity import perplexity
    return perplexity(params, cfg, corpus, ctx_size=128, stride=64,
                      batch=4)["ppl"]


def accuracy_ratios(device=None, names=GATED, log=print) -> dict:
    """{"fp32_ppl": the f32 model's perplexity, name: ratio, ...}."""
    params, cfg, corpus = build_corpus(device=device)
    p_fp = ppl(params, cfg, corpus)
    ratios = {"fp32_ppl": round(p_fp, 4)}
    for name in names:
        qp, _ = gate_model(quant_of(name), 0, device)
        p_q = ppl(qp, cfg, corpus)
        ratios[name] = round(p_q / p_fp, 4)
        log(f"  {name}: ppl {p_q:.3f} ratio {p_q / p_fp:.4f}")
    return ratios


def regressions(ratios: dict, base: dict, tol: float) -> list:
    """(name, baseline, ratio) of each gated ratio more than ``tol`` above
    its baseline."""
    return [(n, base[n], ratios[n]) for n in GATED
            if n in base and n in ratios and ratios[n] > base[n] * (1 + tol)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m neural_tpu_torch.cli.gate",
        description="perplexity-ratio accuracy gate of the port")
    ap.add_argument("--update", action="store_true",
                    help="write the ratios to --out instead of gating")
    ap.add_argument("--out", help="where --update writes the ratios")
    ap.add_argument("--tol", type=float, default=0.10)
    ap.add_argument("--baseline", default=ACC_BASE,
                    help="the ratios to gate against")
    ap.add_argument("--device", help="'cpu' for the plain path; default "
                    "the card")
    args = ap.parse_args(argv)
    if args.update and not args.out:
        ap.error("--update writes only to a path given with --out")
    return args


def main(argv=None, out=print) -> int:
    args = parse_args(argv)
    log = lambda s: print(s, file=sys.stderr)
    log("accuracy gate: measuring PPL ratios on the fixed synthetic "
        "corpus...")
    ratios = accuracy_ratios(args.device, log=log)
    out(json.dumps(ratios))
    if args.update:
        with open(args.out, "w") as f:
            json.dump(ratios, f, indent=1)
        log(f"accuracy ratios written: {args.out}")
        return 0
    with open(args.baseline) as f:
        base = json.load(f)
    bad = regressions(ratios, base, args.tol)
    for name, b, r in bad:
        log(f"ACCURACY REGRESSION {name}: PPL ratio {b:.4f} → {r:.4f}")
    if not bad:
        log("accuracy gate: OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
