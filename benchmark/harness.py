"""The benchmark's one command, driven by data.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card it is
started on. Everything that belongs to one configuration, traffic mix or
metric is found by its name:

- ``BENCHMARK.json``'s configuration entry names its file (the model's
  Hugging Face ``config.json`` keys, plus what the benchmark assumes);
- ``benchmark/traffic/<mix>.json``: the mix, read by ``generator.py``; its
  ``driver`` names ``benchmark/drivers/<driver>.py``;
- ``benchmark/metrics/<metric>/reader.py``: one reader a metric, with any
  kernel-name pattern files beside it;
- ``benchmark/limits/<cell>.json``: the limit of each number the
  correctness check compares.

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics. The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number beside its limit.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

FORBIDDEN = ("jax", "jaxlib", "flax", "neural_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that a run must not hold, each
    compared whole (``neural_tpu_torch`` is not ``neural_tpu``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def load_file_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: Path, bench: Path):
        self.root, self.bench = root, bench
        self.data = json.loads((root / "BENCHMARK.json").read_text())

    def cell(self, name):
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise SystemExit(f"no config {name!r} in BENCHMARK.json")

    def mix(self, name):
        return json.loads((self.bench / "traffic" / f"{name}.json")
                          .read_text())

    def limits(self, cell):
        return json.loads((self.bench / "limits" / f"{cell}.json")
                          .read_text())

    def metrics(self, cell, trace):
        """The cell's metric entries for this kind of run."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric):
        d = self.bench / "metrics" / metric
        mod = load_file_module(d / "reader.py",
                               "bench_metric_" + metric.replace(".", "_")
                               .replace("-", "_"))
        return mod, d

    def driver(self, name):
        return load_file_module(self.bench / "drivers" / f"{name}.py",
                                f"bench_driver_{name}").Driver


def set_cache_dirs(root: Path):
    """Fixed directories inside the checkout for every build and kernel
    cache that a run could fill (the port builds its kernels into
    ``build/neural_tpu_torch/`` by itself)."""
    base = root / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)
    # a library that would load JAX by itself (transformers) is kept from
    # it
    os.environ.setdefault("USE_FLAX", "0")


def build_model(hf: dict, seed: int, device):
    """The port's decoder from the seeded weights, through its public
    conversion entry, at the configuration's format."""
    from types import SimpleNamespace as NS
    import torch
    from neural_tpu_torch.convert import build_params
    from neural_tpu_torch.models import llama
    from benchmark.weights import LazyStateDict
    cfg = llama.config_from_hf(NS(**hf))
    sd = LazyStateDict(hf, seed, device)
    with torch.inference_mode():
        params = build_params(sd, cfg, llama, quant=hf["assumed"]["quant"],
                              dtype=torch.bfloat16, device=device)
    sd.release()
    return params, cfg


def setup_cell(spec: Spec, cell_name: str, seed: int, trace: bool,
               device: str):
    """Build the kernels, the weights, the program and its driver, and warm
    up: everything a run counts as set-up → (ctx, driver, setup_s,
    notes)."""
    import torch
    cell = spec.cell(cell_name)
    hf = spec.config(cell["config"])
    mix = spec.mix(cell["traffic"])
    ctx = SimpleNamespace(hf=hf, mix=mix, seed=seed, trace=trace,
                          device=device, cell=cell,
                          limits=spec.limits(cell_name))
    notes = []
    t_set = time.perf_counter()
    if device == "cuda":
        from neural_tpu_torch.ops import _cuda
        built = _cuda.build_all(_cuda.KERNELS)
        notes.append(f"kernel build {built:.1f} s")
    params, cfg = build_model(hf, seed, device)
    driver = spec.driver(mix["driver"])(ctx, params, cfg)
    del params
    driver.warm_up()
    if trace:
        from benchmark.spans import warm_profiler
        warm_profiler()
    if device == "cuda":
        torch.cuda.synchronize()
    return ctx, driver, time.perf_counter() - t_set, notes


def take_samples(ctx, driver, rec):
    """The requests the check compares, drawn from the seed."""
    import numpy as np
    rng = np.random.default_rng([int(ctx.seed), 7])
    chk = ctx.limits["check"]
    return driver.samples(rec, rng, chk["min_tokens"], chk["max_requests"])


def free(driver):
    import torch
    driver.close()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(spec: Spec, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str):
    """One run of a cell → (result dict, stderr lines)."""
    import torch
    ctx, driver, setup_s, notes = setup_cell(spec, cell_name, seed, trace,
                                             device)
    if device == "cuda":
        # the peak of what the window holds, not of set-up's conversion
        torch.cuda.reset_peak_memory_stats()
    rec = driver.run_window(seconds)
    rec["setup_s"] = setup_s
    if rec.get("span") is not None:
        rec["span"].read()
    bad = forbidden_modules()
    if bad:
        return None, [f"forbidden modules loaded: {bad}"]
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    metrics = {}
    for m in spec.metrics(cell_name, trace):
        mod, d = spec.reader(m["name"])
        v = mod.read(rec, ctx, d)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    reqs = rec["requests"]
    failed = sum(1 for r in reqs if r["failed"])
    late = sum(1 for r in reqs if r.get("late"))
    if late:
        notes.append(f"late: {late} measured requests still held by the "
                     "server at the drain's end; not compared, not failed")
    notes += driver_notes(rec)
    samples = take_samples(ctx, driver, rec)
    span = rec.get("span")
    dev_info = {"platform": "gpu" if device == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name() if device == "cuda"
                else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace and span is not None:
        dev_info["busy_s"] = span.busy_s
        dev_info["window_s"] = span.window_s
        breakdown = {"device_ops": span.top_device_ops(),
                     "idle_gaps": span.idle_gaps()}
        notes.append(f"traced span {span.window_s:.3f} s: "
                     f"{len(span.kernels)} kernels, "
                     f"{len(rec['span_steps'])} steps, "
                     f"{span.graph_launches} graph launches; the profiler "
                     f"took {span.start_s:.3f} s to start and "
                     f"{span.stop_s:.3f} s to stop, outside the span")
        if not span.kernels:
            notes.append("the profiler recorded no device kernel in the "
                         "traced span; kernel and graph metrics left out")
    del rec, span
    free(driver)
    t_ref = time.perf_counter()
    checks = compare(ctx.hf, seed, device, samples, ctx.limits)
    notes.append(f"reference check {time.perf_counter() - t_ref:.1f} s over "
                 f"{len(samples)} requests, "
                 f"{sum(len(s[1]) for s in samples)} served tokens")
    correct = (failed == 0 and bool(samples) and len(reqs) > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    out = {"correct": correct, "attempted": len(reqs), "failed": failed,
           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out, notes


def driver_notes(rec):
    notes = []
    late = [r["issued"] - r["due"] for r in rec.get("sent", ())
            if "issued" in r]
    if late:
        late.sort()
        notes.append(f"generator lateness: max {late[-1] * 1e3:.3f} ms, "
                     f"p95 {late[int(0.95 * (len(late) - 1))] * 1e3:.3f} ms "
                     f"over {len(late)} requests")
    reqs = rec["requests"]
    notes.append(f"requests measured: {len(reqs)}, tokens in window: "
                 f"{rec['tokens_in_window']}")
    done = [r for r in reqs if not r["failed"] and r.get("first")]
    if rec["kind"] == "server" and done:
        # latency, for the record: above the knee the queue sets it, so it
        # is no bounded metric (PERF.md §2)
        import numpy as np
        ttft = [(r["first"] - r["due"]) * 1e3 for r in done]
        tpot = [(r["end"] - r["first"]) * 1e3 / max(len(r["out"]) - 1, 1)
                for r in done]
        notes.append("time to first token p50 / p90: "
                     f"{np.percentile(ttft, 50):.1f} / "
                     f"{np.percentile(ttft, 90):.1f} ms; per output token "
                     f"p50 / p90: {np.percentile(tpot, 50):.2f} / "
                     f"{np.percentile(tpot, 90):.2f} ms, over "
                     f"{len(done)} requests")
    return notes


def served_rows(ref, samples):
    """The reference's logits rows at every served position of each
    sampled (prompt, served tokens)."""
    seqs = [list(p) + list(o[:-1]) for p, o in samples]
    pos = [list(range(len(p) - 1, len(p) - 1 + len(o))) for p, o in samples]
    return ref.logits(seqs, pos) if samples else []


def compare(hf, seed, device, samples, limits):
    """The plain reference over each sampled prompt and its served tokens;
    each number the cell's limits file names, beside its limit."""
    from benchmark.reference.model import Reference, numbers
    rows = served_rows(Reference(hf, seed, device), samples)
    masked = limits["check"].get("masked_ids", [])
    got = numbers([(r, o, masked) for r, (_, o) in zip(rows, samples)])
    return {k: {"value": got[k], "limit": v}
            for k, v in limits["numbers"].items()}


def main(argv=None, root=None, device=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    bench = Path(__file__).resolve().parent
    root = Path(root) if root else bench.parent
    spec = Spec(root, root / "benchmark")
    set_cache_dirs(root)
    import torch
    if device is None:
        n = spec.cell(a.workload)["chips"]
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            print(f"needs {n} CUDA device(s); found {have}", file=sys.stderr)
            return 3
        device = "cuda"
        from benchmark.spans import power_limit
        print(f"card: {power_limit()}; peaks 1979 TOP/s int8, 989 TFLOP/s "
              "bf16, 3.35 TB/s (H100 SXM at 700 W)", file=sys.stderr)
    out, notes = run_cell(spec, a.workload, a.seed, a.seconds, bool(a.trace),
                          device)
    for n in notes:
        print(n, file=sys.stderr)
    bad = forbidden_modules()
    if out is None or bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0
