"""A traced span of a run: ``torch.profiler`` over CPU and CUDA activities,
read back from its Chrome trace (written under the run's temporary
directory and deleted once read).

What it gives the metric readers: every device kernel (name, start, length
in seconds), the union of device activity (``busy_s``), the span's length
on the host's clock (``window_s``), the port's launch counts over it
(``ops/_cuda.py launch_counts()``), the device operations that took most
time, and the idle gaps labelled by the outermost host operation running
at the gap's middle.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Span:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.start_s = self.stop_s = None     # the profiler's own cost
        self.launches = {}    # the port's launch counts over the span
        self.kernels: List[Tuple[str, float, float]] = []
        self.device_ops: List[Tuple[str, float, float]] = []
        self.host_ops: List[Tuple[str, float, float, object]] = []
        self.graph_launches = 0

    def start(self):
        from neural_tpu_torch.ops import _cuda
        self._launch0 = _cuda.launch_counts()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=acts)
        t = time.perf_counter()
        self.prof.start()
        self.t0 = time.perf_counter()
        self.start_s = self.t0 - t

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.stop_s = time.perf_counter() - self.t1
        from neural_tpu_torch.ops import _cuda
        self.launches = {k: v - self._launch0.get(k, 0)
                         for k, v in _cuda.launch_counts().items()}

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def read(self):
        """Parse the trace; call once, after :meth:`stop`."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e.get("ts", 0)) * 1e-6, float(e.get("dur", 0)) \
                * 1e-6
            name = e.get("name", "")
            if cat in DEVICE_CATS:
                self.device_ops.append((name, ts, dur))
                if cat == "kernel":
                    self.kernels.append((name, ts, dur))
            elif cat in ("cpu_op", "user_annotation", "python_function"):
                self.host_ops.append((name, ts, dur, e.get("tid")))
            elif cat == "cuda_runtime" and "GraphLaunch" in name:
                self.graph_launches += 1
        self.prof = None
        return self

    # -- reductions --------------------------------------------------------
    def busy_intervals(self) -> List[Tuple[float, float]]:
        iv = sorted((ts, ts + d) for _, ts, d in self.device_ops)
        merged: List[List[float]] = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_s(self, match=None) -> float:
        return sum(d for n, _, d in self.kernels
                   if match is None or match(n))

    def top_device_ops(self, n: int = 10):
        acc: Dict[str, float] = defaultdict(float)
        for name, _, d in self.device_ops:
            acc[short(name)] += d
        return sorted(([k, v] for k, v in acc.items()),
                      key=lambda kv: -kv[1])[:n]

    def _top_level(self):
        """Per host thread, the operations that no other one encloses,
        sorted by start."""
        by_tid: Dict[object, List[Tuple[str, float, float]]] = \
            defaultdict(list)
        for name, ts, d, tid in self.host_ops:
            by_tid[tid].append((name, ts, d))
        out = []
        for ops in by_tid.values():
            ops.sort(key=lambda o: (o[1], -o[2]))
            top, end = [], -1.0
            for o in ops:
                if o[1] >= end:
                    top.append(o)
                    end = o[1] + o[2]
            out.append(([o[1] for o in top], top))
        return out

    def idle_gaps(self, n: int = 10):
        """Idle device time inside the span, summed by what the host was
        doing (the outermost host operation at each gap's middle)."""
        busy = self.busy_intervals()
        acc: Dict[str, float] = defaultdict(float)
        threads = self._top_level()
        for (a0, b0), (a1, _) in zip(busy, busy[1:]):
            gap = a1 - b0
            if gap <= 0:
                continue
            mid = b0 + gap / 2
            label, best = "no host op recorded", None
            for starts, top in threads:
                i = bisect.bisect_right(starts, mid) - 1
                if i >= 0:
                    name, ts, d = top[i]
                    if mid <= ts + d and (best is None or d > best):
                        label, best = short(name), d
            acc[label] += gap
        if busy:
            edge = self.window_s - (busy[-1][1] - busy[0][0])
            if edge > 0:
                acc["span edges (profiler start and stop)"] += edge
        return sorted(([k, v] for k, v in acc.items()),
                      key=lambda kv: -kv[1])[:n]


def warm_profiler():
    """One whole profiled session in set-up, on the main thread, over a few
    device operations and read back: a process's first start initialises
    the device tracer (about 10 s on the H100's machine), and a span
    started later, on any thread, records the device's kernels only after
    such a session."""
    sp = Span()
    sp.start()
    if torch.cuda.is_available():
        x = torch.ones(256, 256, device="cuda")
        for _ in range(4):
            x = x @ x / 256
    sp.stop()
    sp.read()


def short(name: str, n: int = 120) -> str:
    """A kernel's name without its template arguments and parameters."""
    s = name.replace("(anonymous namespace)::", "").replace("void ", "")
    for c in "<(":
        i = s.find(c)
        if i > 0:
            s = s[:i]
    return (s.strip() or name)[:n]


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None
