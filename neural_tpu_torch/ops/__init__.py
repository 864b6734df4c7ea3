"""Norms, RoPE, quantized matmul and attention; kernels in csrc/."""
