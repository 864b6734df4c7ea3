"""The work that a step's inputs need, and the least time the card could
take for it.

Frozen here, so that no later change to the program can move the
yardstick. The arithmetic follows the per-kernel bounds that the port's
bring-up used (operations 2·M·K·N a product; bytes: the q4_j weight's
nibbles and bf16 scales once, x once, the output once), with one change:
a mixture-of-experts layer counts the routed experts, not the dense
mixture's eight.

- A product of ``[M, K]`` by a q4_j ``[K, N]`` weight: 2·M·K·N operations;
  K·N/2 bytes of codes, K/128·N·2 of scales, M·K·2 of x, M·N·2 of output.
- A Mixtral expert layer over r rows: r·k routed rows of operations, and
  the weights of min(E, r·k) experts (exact at r = 1; at r = 16 at most
  about 1% over the union of the experts the rows choose).
- Attention: at decode the keys and values read (2·L·Hkv·Dh·fill elements
  a row, at the cache's bytes an element); at prefill the QK and PV
  operations of the causal pairs (4·Hq·Dh a pair a layer).
- Peaks of one H100 SXM (NVIDIA's data sheet, dense): 1979 TOP/s int8 for
  the prompt's products (q4_j quantizes their activations to int8), 989
  TFLOP/s bf16 for everything else, 3.35 TB/s HBM. They hold at the 700 W
  power limit; a run prints the card's limit beside them.

A step's least time is the larger of its operations over the peaks and its
bytes over the bandwidth; a kernel family's share sums each product's own
least time. Each is a lower bound on the time of the work it counts, so no
share built on it passes 100%.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List

PEAK_INT8 = 1979e12
PEAK_BF16 = 989e12
HBM = 3.35e12
GROUP = 128


@dataclass
class Work:
    ops_s: float = 0.0     # seconds of operations at their peaks
    bytes: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.ops_s + o.ops_s, self.bytes + o.bytes)

    @property
    def least_s(self) -> float:
        return max(self.ops_s, self.bytes / HBM)


class Model:
    """Shapes of a configuration (the Hugging Face ``config.json`` keys)."""

    def __init__(self, hf: dict):
        self.D = hf["hidden_size"]
        self.L = hf["num_hidden_layers"]
        self.H = hf["num_attention_heads"]
        self.Hkv = hf.get("num_key_value_heads") or self.H
        self.Dh = hf.get("head_dim") or self.D // self.H
        self.F = hf["intermediate_size"]
        self.V = hf["vocab_size"]
        self.E = hf.get("num_local_experts", 0) or 0
        self.k = hf.get("num_experts_per_tok", 0) or 0


def product(M: int, K: int, N: int, peak: float, n_weights: int = 1,
            rows_ops: int = None) -> Work:
    """A q4_j product: ``n_weights`` weights of [K, N] read, over M rows of
    x (``rows_ops`` rows of operations, M by default)."""
    rows_ops = M if rows_ops is None else rows_ops
    w = n_weights * (K * N // 2 + (K // GROUP) * N * 2)
    return Work(2.0 * rows_ops * K * N / peak,
                float(w + M * K * 2 + M * N * 2))


def layer_products(m: Model, r: int, peak: float) -> List[Work]:
    """The q4_j products of one layer over r rows, one entry a product."""
    D, qd, kd, F = m.D, m.H * m.Dh, m.Hkv * m.Dh, m.F
    out = [product(r, D, qd, peak), product(r, D, kd, peak),
           product(r, D, kd, peak), product(r, qd, D, peak)]
    if m.E:
        held = min(m.E, r * m.k)
        rk = r * m.k
        out += [product(r, D, F, peak, held, rk),
                product(r, D, F, peak, held, rk),
                product(r, F, D, peak, held, rk)]
    else:
        out += [product(r, D, F, peak), product(r, D, F, peak),
                product(r, F, D, peak)]
    return out


def router(m: Model, r: int) -> Work:
    """The bf16 router of a MoE layer."""
    if not m.E:
        return Work()
    return Work(2.0 * r * m.D * m.E / PEAK_BF16, float(m.D * m.E * 2))


def prefill_products(m: Model, rows: int) -> List[Work]:
    """A prompt chunk's layer products (int8 activations)."""
    return [w for _ in range(m.L) for w in layer_products(m, rows,
                                                          PEAK_INT8)]


def decode_products(m: Model, rows: int) -> List[Work]:
    """One decode step's products over ``rows`` sequences, the lm_head
    included."""
    out = [w for _ in range(m.L) for w in layer_products(m, rows, PEAK_BF16)]
    out.append(product(rows, m.D, m.V, PEAK_BF16))
    return out


def prefill_attention(m: Model, begin: int, rows: int) -> Work:
    """QK and PV operations of the causal pairs of rows [begin,
    begin + rows)."""
    pairs = rows * begin + rows * (rows + 1) // 2
    return Work(4.0 * m.H * m.Dh * pairs * m.L / PEAK_BF16, 0.0)


def decode_attention(m: Model, fills: Iterable[int], kv_bytes: float) -> Work:
    """Keys and values read by one decode step, a row per fill."""
    n = sum(fills)
    return Work(4.0 * m.H * m.Dh * n * m.L / PEAK_BF16,
                2.0 * m.L * m.Hkv * m.Dh * n * kv_bytes)


def step_least_s(m: Model, step: dict, kv_bytes: float) -> float:
    """The least time of one step record: ``{"prefill": [[begin, rows,
    logits], ...], "decode": [fill, ...]}`` (``logits``: whether the chunk
    ends its prompt, so one row of the lm_head is needed)."""
    total = Work()
    for begin, rows, last in step.get("prefill", ()):
        for w in prefill_products(m, rows):
            total = total + w
        total = total + prefill_attention(m, begin, rows)
        for _ in range(m.L):
            total = total + router(m, rows)
        if last:
            total = total + product(1, m.D, m.V, PEAK_BF16)
    fills = step.get("decode", ())
    if fills:
        for w in decode_products(m, len(fills)):
            total = total + w
        for _ in range(m.L):
            total = total + router(m, len(fills))
        total = total + decode_attention(m, fills, kv_bytes)
    return total.least_s


def family_least_s(m: Model, steps: Iterable[dict], which: str) -> float:
    """The summed least time of each product of the steps' prompt chunks
    (``which`` = "prefill", lm_head excluded: one row of it rides on the
    decode kernel) or decode steps ("decode", lm_head included)."""
    t = 0.0
    for st in steps:
        if which == "prefill":
            for _, rows, _ in st.get("prefill", ()):
                t += sum(w.least_s for w in prefill_products(m, rows))
        else:
            fills = st.get("decode", ())
            if fills:
                t += sum(w.least_s for w in decode_products(m, len(fills)))
    return t
