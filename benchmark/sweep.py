"""The knee of a served cell, found once on the card by a sweep of offered
rates (the benchmark's own runs never run this):

    python3 benchmark/sweep.py --workload <cell> --seed <n> \\
        --seconds <s> --rates 1.5 2 2.5 3

One process builds the program once; each rate gets a fresh server, the
cell's own mix at that rate, a window of ``--seconds`` and one JSON line:
the offered and completed request rates, tokens a second, the 95th
percentile of time to first token, and the waiting queue over the window
(its mean in the first and the second half). The knee is the highest rate
whose completions keep pace with its arrivals while the queue does not
grow through the window.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402
import numpy as np  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    a = ap.parse_args(argv)
    spec = harness.Spec(Path(ROOT), Path(ROOT) / "benchmark")
    harness.set_cache_dirs(spec.root)
    from neural_tpu_torch.ops import _cuda
    _cuda.build_all(_cuda.KERNELS)
    cell = spec.cell(a.workload)
    hf = spec.config(cell["config"])
    base = spec.mix(cell["traffic"])
    params, cfg = harness.build_model(hf, a.seed, "cuda")
    Driver = spec.driver(base["driver"])
    for rate in a.rates:
        mix = copy.deepcopy(base)
        mix["arrivals"]["rate"] = rate
        ctx = SimpleNamespace(hf=hf, mix=mix, seed=a.seed, trace=False,
                              device="cuda", cell=cell,
                              limits=spec.limits(a.workload))
        d = Driver(ctx, params, cfg)
        d.warm_up()
        rec = d.run_window(a.seconds)
        w0, w1 = rec["window"]
        reqs = rec["requests"]
        done_in = [r for r in rec["sent"] if "end" in r
                   and not r["failed"] and w0 <= r["end"] < w1]
        q = [(t, w) for t, w, _ in rec["queue"] if w0 <= t < w1]
        half = (w0 + w1) / 2
        first = [w for t, w in q if t < half]
        second = [w for t, w in q if t >= half]
        print(json.dumps(dict(
            rate=rate, due_in_window=len(reqs),
            completed_per_s=len(done_in) / a.seconds,
            offered_per_s=len(reqs) / a.seconds,
            tokens_per_s=rec["tokens_in_window"] / a.seconds,
            ttft_p95_ms=float(np.percentile(
                [(r["first"] - r["due"]) * 1e3 for r in reqs
                 if "end" in r and not r["failed"]], 95)) if reqs else None,
            failed=sum(r["failed"] for r in reqs),
            late=sum(r["late"] for r in reqs),
            queue_first_half=sum(first) / max(len(first), 1),
            queue_second_half=sum(second) / max(len(second), 1),
            queue_end=q[-1][1] if q else None)), flush=True)
        d.server.stop()
        d.server = d.sched = d._orig = None


if __name__ == "__main__":
    main()
