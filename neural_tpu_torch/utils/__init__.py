"""Host utilities of the port: WAV loading, timings and traces, chat
prompts (the port's own copies of ``neural_tpu/utils``)."""
from .audio import load_audio_16k, read_wav
from .profiling import Timings, maybe_trace, verbosity
from .prompts import build_prompt, build_prompt_glm1, build_prompt_glm2

__all__ = ["read_wav", "load_audio_16k", "Timings", "maybe_trace",
           "verbosity", "build_prompt", "build_prompt_glm1",
           "build_prompt_glm2"]
