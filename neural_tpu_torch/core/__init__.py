from .device import resolve_device
from .dtypes import PRESETS, QuantConfig, bit_planes
from .qtensor import (QTensor, dequantize, matmul_ref, quantize,
                      to_native_packed)

__all__ = ["PRESETS", "QuantConfig", "QTensor", "bit_planes", "dequantize",
           "matmul_ref", "quantize", "resolve_device", "to_native_packed"]
