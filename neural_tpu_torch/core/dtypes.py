"""Quantized dtype definitions (PyTorch port of ``neural_tpu/core/dtypes.py``).

A small frozen dataclass describes how a weight tensor is quantized; the
storage layout lives in :mod:`neural_tpu_torch.core.qtensor`. The presets
and the bit-plane decomposition are copied value for value, so a model
quantized by either package describes itself the same way.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# "int": 1-8 bit integers, optional asymmetric zero-point; "nf4"/"fp4": 4-bit
# indices into a 16-entry table; "fp8_e4m3"/"fp8_e5m2": 8-bit floats
KINDS = ("int", "nf4", "fp4", "fp8_e4m3", "fp8_e5m2")

# NF4 lookup table (16 entries), the standard QLoRA codebook
NF4_LUT = torch.tensor(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=torch.float32,
)

# FP4 E2M1 lookup table: sign x {0, .5, 1, 1.5, 2, 3, 4, 6} / 6, with a -0.0
# entry; the f32 quotient of a tensor division, as numpy computes it
_FP4 = torch.tensor([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
                     -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0],
                    dtype=torch.float32)
FP4_LUT = _FP4 / torch.full_like(_FP4, 6.0)

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
    def lut(self) -> Optional[torch.Tensor]:
        if self.kind == "nf4":
            return NF4_LUT
        if self.kind == "fp4":
            return FP4_LUT
        return None

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


def quant_config_from_args(weight_dtype="int4", alg="sym", group_size=32,
                           scale_dtype="fp32", compute_dtype="int8",
                           use_ggml=False):
    """Reference-style quant knobs → QuantConfig, the JAX package's rule
    (``neural_tpu/api.py``).

    ``weight_dtype``: int1..int8 / nf4 / fp4 / fp8 / fp8_e5m2, a preset
    name, a QuantConfig or a QuantRegistry (passed through), a mixed
    preset's name (its registry, ``convert.quant_registry.MIXED_PRESETS``),
    or None (bf16 projections). ``compute_dtype="int8"`` enables the
    dynamic int8-activation path for prefill; "bf16"/"fp16"/"fp32" keep
    bf16 activations. ``use_ggml`` maps to q4_0/q4_1 (sym/asym, group
    32)."""
    from ..convert.quant_registry import MIXED_PRESETS, QuantRegistry
    if weight_dtype is None or isinstance(weight_dtype,
                                          (QuantConfig, QuantRegistry)):
        return weight_dtype
    if weight_dtype in MIXED_PRESETS:
        return MIXED_PRESETS[weight_dtype]
    if weight_dtype in PRESETS:
        return PRESETS[weight_dtype]
    sym = alg == "sym"
    if use_ggml:
        return PRESETS["q4_0" if sym else "q4_1"]
    act_bits = 8 if compute_dtype == "int8" else 16
    sd = "f32" if scale_dtype in ("fp32", "f32") else "bf16"
    if weight_dtype.startswith("int"):
        return QuantConfig(bits=int(weight_dtype[3:]), group_size=group_size,
                           sym=sym, act_bits=act_bits, scale_dtype=sd)
    if weight_dtype in ("nf4", "fp4"):
        return QuantConfig(kind=weight_dtype, group_size=group_size,
                           scale_dtype=sd)
    if weight_dtype in ("fp8", "fp8_e4m3"):
        return QuantConfig(kind="fp8_e4m3", group_size=group_size,
                           scale_dtype=sd)
    if weight_dtype == "fp8_e5m2":
        return QuantConfig(kind="fp8_e5m2", group_size=group_size,
                           scale_dtype=sd)
    raise ValueError(f"unknown weight_dtype {weight_dtype!r}")


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
