"""Helpers shared by the metric readers (``metrics/<name>/reader.py``)."""
from __future__ import annotations

from pathlib import Path
from typing import Callable, List

import numpy as np

from benchmark import roofline


def patterns(folder: Path, sub: str) -> List[str]:
    """Every non-empty, non-comment line of ``folder/sub/*.txt``: a kernel
    family's name patterns, one file a family."""
    out = []
    for f in sorted((folder / sub).glob("*.txt")):
        for line in f.read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                out.append(line)
    return out


def matcher(pats: List[str]) -> Callable[[str], bool]:
    return lambda name: any(p in name for p in pats)


def p90(values) -> float:
    """The 90th percentile: the highest with ten samples beyond it among
    the hundred or so requests a serving window holds."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 90))


def kv_bytes(mix: dict) -> float:
    """Bytes an element of the cell's KV cache."""
    md = mix.get("server", {}).get("memory_dtype") or mix.get("kv_dtype")
    return 1.0 if md == "int8" else 2.0


def traced(rec) -> bool:
    span = rec.get("span")
    return span is not None and bool(span.kernels)


def family_share(rec, ctx, folder: Path, which: str):
    """Needed work of the span's products of one kind over the device time
    of the kernel families that ran them, in %."""
    if not traced(rec):
        return None
    t = rec["span"].kernel_s(matcher(patterns(folder, "families")))
    need = roofline.family_least_s(roofline.Model(ctx.hf), rec["span_steps"],
                                   which)
    if t <= 0 or need <= 0:
        return None
    return 100.0 * need / t


