"""Weight import: HF models, random weights, and JAX parameter trees."""
