"""Weight import: HF models, random weights, and JAX parameter trees."""
from .hf import build_params, from_hf_model, init_random, register_arch

__all__ = ["from_hf_model", "init_random", "build_params", "register_arch"]
