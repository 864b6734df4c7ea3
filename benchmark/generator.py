"""The one traffic generator: it reads a mix file (``traffic/<name>.json``)
and turns it, with the run's seed, into the requests of a run.

A mix gives its lengths as clipped lognormals and its arrivals as Poisson
(``"arrivals": {"kind": "poisson", "rate": r}``). Against seed-to-seed
noise the draws are stratified: each block of n requests takes the same
set of sizes (the distributions' quantiles at (i + 0.5) / n) and the same
set of gaps, each shuffled by the seed on its own, so every seed sends the
same work in another order. Prompt ids are drawn uniformly from ``vocab`` =
[lo, hi).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import List

import numpy as np


@dataclass
class Request:
    idx: int
    due: float            # seconds from the start of the schedule
    prompt: List[int]
    n_out: int
    block: int = 0        # which block of the stream it came from


def lognormal_quantiles(spec: dict, n: int) -> List[int]:
    """``n`` stratified sizes of ``{"median", "sigma", "min", "max"}``."""
    nd = NormalDist()
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        v = spec["median"] * math.exp(spec["sigma"] * z)
        out.append(int(min(max(round(v), spec["min"]), spec["max"])))
    return out


def poisson_gaps(rate: float, n: int) -> List[float]:
    """``n`` stratified exponential gaps of mean 1 / ``rate``."""
    return [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]


class Mix:
    """The request stream of a mix for one seed.

    With ``window_s``: a lead-in block (``lead_in_s``), then blocks of
    round(rate · window_s) requests whose gaps are scaled to sum to
    ``window_s``, so the window holds the same requests' sizes for every
    seed, in another order. Otherwise blocks of ``block`` requests."""

    def __init__(self, spec: dict, seed: int, window_s: float = None):
        self.spec = spec
        self.rng = np.random.default_rng(int(seed))
        self.lo, self.hi = spec.get("vocab", [3, 32000])
        self.rate = float(spec["arrivals"]["rate"])
        self.block = int(spec.get("block", 64))
        self.blocks = []          # (requests, seconds) of each block
        if window_s:
            lead = float(spec.get("lead_in_s", 0.0))
            if lead > 0:
                self.blocks.append((max(1, round(self.rate * lead)), lead))
            self.window_block = (max(1, round(self.rate * window_s)),
                                 float(window_s))
        else:
            self.window_block = (self.block, None)
        # the index of the block that the window holds
        self.window_index = len(self.blocks)
        self._queue: List[tuple] = []
        self._t = 0.0
        self._n = 0
        self._blk = -1

    def _refill(self):
        n, secs = self.blocks.pop(0) if self.blocks else self.window_block
        self._blk += 1
        p = self.rng.permutation(lognormal_quantiles(self.spec["prompt"], n))
        o = self.rng.permutation(lognormal_quantiles(self.spec["output"], n))
        g = poisson_gaps(self.rate, n)
        if secs:
            g = [x * secs / sum(g) for x in g]
        g = self.rng.permutation(g)
        self._queue += [(a, b, c, self._blk) for a, b, c in zip(p, o, g)]

    def next(self) -> Request:
        """The next request of the stream, due one gap after the one
        before it (the first at 0)."""
        if not self._queue:
            self._refill()
        p, o, g, blk = self._queue.pop(0)
        ids = self.rng.integers(self.lo, self.hi, size=int(p)).tolist()
        r = Request(self._n, self._t, ids, int(o), blk)
        self._t += float(g)
        self._n += 1
        return r

    def take(self, n: int) -> List[Request]:
        return [self.next() for _ in range(n)]
