"""Quantized dtype definitions (PyTorch port of ``neural_tpu/core/dtypes.py``).

A small frozen dataclass describes how a weight tensor is quantized; the
storage layout lives in :mod:`neural_tpu_torch.core.qtensor`. The presets
and the bit-plane decomposition are copied value for value, so a model
quantized by either package describes itself the same way.
"""
from __future__ import annotations

import dataclasses
import torch

# the JAX package's kinds; this port quantizes and multiplies "int" only
KINDS = ("int", "nf4", "fp4", "fp8_e4m3", "fp8_e5m2")

@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """How a weight tensor is quantized.

    - ``bits``: 1..8 for kind="int"; fixed 4 for nf4/fp4; 8 for fp8.
    - ``group_size``: K-block size of the scales, or -1 for one group over K.
    - ``sym``: symmetric (no zero-point) vs asymmetric (uint8 zero-points).
    - ``act_bits``: 16 → bf16 activations; 8 → dynamic per-row, per-group
      int8 activations for prefill-sized products (``ops.qmatmul``).
    - ``native_pack``: the at-rest layout, a uint8 plane ``[K/2, N]`` whose
      nibbles are the CENTERED int4 codes (code 2r in the low nibble of byte
      row r, code 2r+1 in the high nibble). Set by
      :func:`~neural_tpu_torch.core.qtensor.to_native_packed` only.
    """

    bits: int = 4
    kind: str = "int"
    group_size: int = 32
    sym: bool = True
    act_bits: int = 16
    scale_dtype: str = "f32"  # "f32" | "bf16"
    native_pack: bool = False

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown kind {self.kind!r}")
        if self.kind == "int" and not (1 <= self.bits <= 8):
            raise ValueError("int bits must be in 1..8")
        if self.native_pack and (self.kind != "int"
                                 or not 2 <= self.bits <= 4):
            raise ValueError("native_pack stores 2-4 bit int codes")
        if self.kind in ("nf4", "fp4") and self.bits != 4:
            object.__setattr__(self, "bits", 4)
        if self.kind.startswith("fp8") and self.bits != 8:
            object.__setattr__(self, "bits", 8)
        if self.kind != "int" and not self.sym:
            raise ValueError(f"{self.kind} supports only symmetric scales")
        if self.act_bits not in (8, 16):
            raise ValueError("act_bits must be 8 (dynamic int8) or 16 (bf16)")

    @property
    def scale_torch(self) -> torch.dtype:
        return torch.float32 if self.scale_dtype == "f32" else torch.bfloat16

    def short_name(self) -> str:
        """e.g. q4_sym_g32, nf4_g64, q4_asym_g128_a8."""
        if self.kind == "int":
            s = f"q{self.bits}_{'sym' if self.sym else 'asym'}_g{self.group_size}"
        else:
            s = f"{self.kind}_g{self.group_size}"
        if self.act_bits == 8:
            s += "_a8"
        return s


PRESETS = {
    "q4_0": QuantConfig(bits=4, group_size=32, sym=True),
    # int4 g128 sym with int8 activations for prefill: the main path
    "q4_j": QuantConfig(bits=4, group_size=128, sym=True, act_bits=8),
    "q4_1": QuantConfig(bits=4, group_size=32, sym=False),
    "q4_j_g32": QuantConfig(bits=4, group_size=32, sym=False),
    "q4_j_g128": QuantConfig(bits=4, group_size=128, sym=False),
    "q4_j_i8_g32": QuantConfig(bits=4, group_size=32, sym=False, act_bits=8),
    "q4_j_i8_g128": QuantConfig(bits=4, group_size=128, sym=False, act_bits=8),
    "q8_0": QuantConfig(bits=8, group_size=32, sym=True),
    "int8": QuantConfig(bits=8, group_size=-1, sym=True),
    "int5": QuantConfig(bits=5, group_size=32, sym=True),
    "int3": QuantConfig(bits=3, group_size=32, sym=True),
    "int2": QuantConfig(bits=2, group_size=32, sym=True),
    "int1": QuantConfig(bits=1, group_size=32, sym=True),
    "nf4": QuantConfig(kind="nf4", group_size=32),
    "fp4": QuantConfig(kind="fp4", group_size=32),
    "fp8": QuantConfig(kind="fp8_e4m3", group_size=128),
    "fp8_e5m2": QuantConfig(kind="fp8_e5m2", group_size=128),
}


def bit_planes(bits: int) -> tuple[int, ...]:
    """Decompose a bit-width into storage planes from {4, 2, 1}; 8 bits is
    one full-byte plane."""
    if bits == 8:
        return (8,)
    planes = []
    for p in (4, 2, 1):
        if bits >= p:
            planes.append(p)
            bits -= p
    if bits:
        raise ValueError("unreachable")
    return tuple(planes)
