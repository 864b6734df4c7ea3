"""Verbosity, phase timings and per-op traces (reference
``NEURAL_SPEED_VERBOSE`` in {0, 1, 2}, README "Performance profiling"; the
per-node perf counters aggregated by ne_graph_profiling, ne_layers.c:12030;
model_print_timings, model_utils.cpp:1903).

``NEURAL_TPU_VERBOSE=1`` prints the wall time of each phase of a
generation or transcription; ``=2`` also traces the call with
``torch.profiler`` (CUDA activities on the card) and prints the ops that
took the most device time: the per-op table.
"""
from __future__ import annotations

import collections
import contextlib
import os
import time


def verbosity() -> int:
    """``NEURAL_TPU_VERBOSE`` as an int (0 when unset or not a number)."""
    try:
        return int(os.environ.get("NEURAL_TPU_VERBOSE", "0"))
    except ValueError:
        return 0


class Timings:
    """Accumulates phase times in ms (model_print_timings analog)."""

    def __init__(self):
        self.load_ms = 0.0
        self.prefill_ms = 0.0
        self.prefill_tokens = 0
        self.decode_ms = 0.0
        self.decode_tokens = 0

    @contextlib.contextmanager
    def phase(self, name: str, tokens: int = 0):
        t0 = time.time()
        yield
        dt = (time.time() - t0) * 1e3
        if name == "load":
            self.load_ms += dt
        elif name == "prefill":
            self.prefill_ms += dt
            self.prefill_tokens += tokens
        elif name == "decode":
            self.decode_ms += dt
            self.decode_tokens += tokens

    def report(self) -> str:
        lines = ["neural-tpu timings:"]
        if self.load_ms:
            lines.append(f"  load    : {self.load_ms:9.2f} ms")
        if self.prefill_tokens:
            lines.append(
                f"  prefill : {self.prefill_ms:9.2f} ms / "
                f"{self.prefill_tokens} tok "
                f"({self.prefill_ms / max(self.prefill_tokens, 1):.2f} ms/tok)")
        if self.decode_tokens:
            lines.append(
                f"  decode  : {self.decode_ms:9.2f} ms / "
                f"{self.decode_tokens} tok "
                f"({self.decode_ms / max(self.decode_tokens, 1):.2f} ms/tok)")
        return "\n".join(lines)

    def print_if_verbose(self):
        if verbosity() >= 1:
            print(self.report(), flush=True)


def top_ops(prof, top: int = 12):
    """The ``top`` ops of a finished ``torch.profiler`` run by self device
    time, [(name, ms)]; by self host time when it recorded no device time
    (a run on the CPU), and then the second value is False."""
    dev = collections.Counter()
    host = collections.Counter()
    for e in prof.key_averages():
        name = e.key[:48]
        dev[name] += (getattr(e, "self_device_time_total", None)
                      or getattr(e, "self_cuda_time_total", 0) or 0) / 1e3
        host[name] += e.self_cpu_time_total / 1e3
    dev = +dev
    if dev:
        return dev.most_common(top), True
    return host.most_common(top), False


@contextlib.contextmanager
def maybe_trace(tag: str = "generate", top: int = 12):
    """At ``NEURAL_TPU_VERBOSE >= 2``, trace the block with
    ``torch.profiler`` (CPU and, where a card is present, CUDA activities)
    and print its top ops by device time, or by host time where no device
    time was recorded. Profiling never breaks the traced call: a failure
    of the analysis is printed and swallowed."""
    if verbosity() < 2:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    try:
        rows, on_device = top_ops(prof, top)
        print(f"top {'device' if on_device else 'host'} ops ({tag}"
              f"{'' if on_device else ', no device time recorded'}):")
        for k, v in rows:
            print(f"  {v:10.3f} ms  {k}", flush=True)
    except Exception as e:  # profiling must never break generation
        print(f"[profiling] trace analysis failed: {e}", flush=True)
