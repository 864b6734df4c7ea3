"""neural_tpu_torch: the PyTorch / CUDA port of neural-tpu for NVIDIA Hopper.

Weight-only-quantized LLM generation and continuous-batching serving with
hand-written CUDA kernels (``csrc/``) for the quantized matmuls and the
flash and paged attention, built on first use. The package imports only torch, numpy and the standard library;
its entry points run on the card unless the caller passes ``device="cpu"``,
where every kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"

from .api import Model
from .core import PRESETS, QTensor, QuantConfig, dequantize, quantize
from .models.config import ModelConfig
from .runtime.sampling import SamplingParams

__all__ = ["Model", "ModelConfig", "ModelServer", "PRESETS", "QTensor",
           "Query", "QuantConfig", "SamplingParams", "dequantize",
           "quantize"]


def __getattr__(name):
    # lazy: serving pulls in threading machinery
    if name in ("ModelServer", "Query"):
        from . import serving
        return getattr(serving, name)
    raise AttributeError(name)
