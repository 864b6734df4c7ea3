"""Per-tensor quantization configs for mixed-bit models (port of
``neural_tpu/convert/quant_registry.py``).

A registry is an ordered list of (fnmatch pattern → QuantConfig, preset
name or None) rules; the first match wins, and None keeps the tensor in
the model dtype. Patterns match the tensor's short name ("w_down",
"lm_head") and its layer-qualified form ("layers.3.w_down"), so both
name-wide rules and one layer's exceptions work. The port's blocks are per
layer, so layers whose rules differ need no other layout.

Accepted wherever a quant config is: ``convert.hf.build_params``,
``init_random``, ``Model.init_from_hf_model(weight_dtype=...)``.
"""
from __future__ import annotations

import fnmatch
from typing import Optional, Sequence, Tuple, Union

from ..core.dtypes import PRESETS, QuantConfig


def _coerce(c) -> Optional[QuantConfig]:
    if c is None or isinstance(c, QuantConfig):
        return c
    return PRESETS[c]


class QuantRegistry:
    """Ordered first-match-wins rules: [(pattern, QuantConfig|preset|None)].
    ``default`` applies when no rule matches (None = keep the dtype)."""

    def __init__(self, rules: Sequence[Tuple[str, Union[str, QuantConfig,
                                                        None]]],
                 default: Union[str, QuantConfig, None] = None):
        self.rules = [(p, _coerce(c)) for p, c in rules]
        self.default = _coerce(default)

    def resolve(self, name: str, layer: Optional[int] = None
                ) -> Optional[QuantConfig]:
        keys = (name,) if layer is None else (f"layers.{layer}.{name}", name)
        for pat, qc in self.rules:
            if any(fnmatch.fnmatch(k, pat) for k in keys):
                return qc
        return self.default

    def __repr__(self):
        return f"QuantRegistry({self.rules!r}, default={self.default!r})"


# The mixed int2+int4 Llama recipe: attention projections int4/g32 sym,
# gate/up int2/g16 asym, w_down int4/g32 asym, lm_head int8; the embedding
# stays in the model dtype.
MIX_INT2_INT4 = QuantRegistry(
    rules=[
        ("w_down", QuantConfig(bits=4, group_size=32, sym=False)),
        ("w_gate", QuantConfig(bits=2, group_size=16, sym=False)),
        ("w_up", QuantConfig(bits=2, group_size=16, sym=False)),
        ("lm_head", "int8"),
    ],
    default=QuantConfig(bits=4, group_size=32, sym=True),
)

# The decode-bytes recipe: native int2 g32 sym on the FFN gate/up
# projections (the bulk of a Llama layer's bytes), q4_j (int4 g128 sym with
# int8 activations for prefill) everywhere else.
MIX_I2_FFN = QuantRegistry(
    rules=[
        ("w_gate", QuantConfig(bits=2, group_size=32, sym=True)),
        ("w_up", QuantConfig(bits=2, group_size=32, sym=True)),
    ],
    default=QuantConfig(bits=4, group_size=128, sym=True, act_bits=8),
)

MIXED_PRESETS = {"mix_int2_int4": MIX_INT2_INT4,
                 "mix_i2_ffn": MIX_I2_FFN}
