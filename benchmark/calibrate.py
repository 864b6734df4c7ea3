"""Readings that set a cell's correctness limit, on the card, in one
process for many seeds (the benchmark's own runs never run this):

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--controls act8,kv,both]

For each seed it builds the cell's program, drives a window of the cell's
own traffic, draws the check's sample as a run does, and prints one JSON
line: the program's widest gap (``program``) and, for each control, the
widest gap of the token that the reference computed one step below the
configuration's precision puts first (``act8``: the decode steps' inputs
rounded to int8 per row and group of 128; ``kv``: the cache one step
down, bf16 → int8 or int8 → int4; ``both``).
Each reading gives the numbers the check can compare (``max_gap``,
``median_gap``, ``miss_share``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402

CONTROLS = {"act8": dict(act_bits=8), "kv": dict(kv_bits=None),
            "both": dict(act_bits=8, kv_bits=None)}


def kv_step_down(mix: dict) -> int:
    md = mix.get("server", {}).get("memory_dtype") or mix.get("kv_dtype")
    return 4 if md == "int8" else 8


def readings(spec, cell, seed, seconds, controls, device="cuda"):
    """One seed's program and control gaps."""
    from benchmark.reference.model import Reference, first_tokens, numbers
    ctx, driver, setup_s, _ = harness.setup_cell(spec, cell, seed, False,
                                                 device)
    rec = driver.run_window(seconds)
    samples = harness.take_samples(ctx, driver, rec)
    failed = sum(1 for r in rec["requests"] if r["failed"])
    n_req = len(rec["requests"])
    del rec
    harness.free(driver)
    masked = ctx.limits["check"].get("masked_ids", [])
    t0 = time.perf_counter()
    ref = harness.served_rows(Reference(ctx.hf, seed, device), samples)
    out = dict(cell=cell, seed=seed, setup_s=setup_s, requests=n_req,
               failed=failed, samples=len(samples),
               tokens=sum(len(o) for _, o in samples),
               program=numbers([(r, o, masked)
                                for r, (_, o) in zip(ref, samples)]),
               ref_s=time.perf_counter() - t0)
    low_from = [len(p) for p, _ in samples]
    for name in controls:
        kw = dict(CONTROLS[name])
        if "kv_bits" in kw:
            kw["kv_bits"] = kv_step_down(ctx.mix)
        low = harness.served_rows(
            Reference(ctx.hf, seed, device, low_from=low_from, **kw), samples)
        out[name] = numbers([(r, first_tokens(l, masked), masked)
                             for r, l in zip(ref, low)])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", default="act8,kv,both")
    a = ap.parse_args(argv)
    spec = harness.Spec(Path(ROOT), Path(ROOT) / "benchmark")
    harness.set_cache_dirs(spec.root)
    ctl = [c for c in a.controls.split(",") if c]
    for seed in a.seeds:
        print(json.dumps(readings(spec, a.workload, seed, a.seconds, ctl)),
              flush=True)


if __name__ == "__main__":
    main()
