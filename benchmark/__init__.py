"""The benchmark of the PyTorch / CUDA port (``neural_tpu_torch``)."""
