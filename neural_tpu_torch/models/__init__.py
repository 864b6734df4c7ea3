"""Decoder configuration, the Llama family maps and the decoder graph."""
