"""neural_tpu_torch: the PyTorch / CUDA port of neural-tpu for NVIDIA Hopper.

Weight-only-quantized LLM generation with hand-written CUDA kernels
(``csrc/``) for the quantized matmuls and the flash attention, built on
first use. The package imports only torch, numpy and the standard library;
its entry points run on the card unless the caller passes ``device="cpu"``,
where every kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"

from .api import Model
from .core import PRESETS, QTensor, QuantConfig, dequantize, quantize
from .models.config import ModelConfig
from .runtime.sampling import SamplingParams

__all__ = ["Model", "ModelConfig", "PRESETS", "QTensor", "QuantConfig",
           "SamplingParams", "dequantize", "quantize"]
