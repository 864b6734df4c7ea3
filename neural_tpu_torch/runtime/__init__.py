"""KV cache, sampling and the generation loops."""
